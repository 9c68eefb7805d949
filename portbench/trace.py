"""Reduce a torch.profiler trace of the measured window to the benchmark's
device numbers: busy seconds, device time by operation, idle gaps by what
the host was doing, and the device time of the kernels launched inside each
benchmark span.

The profiler records host ranges (the program's timing scopes and the
benchmark's spans, both as record_function ranges), the host's CUDA
runtime calls and every kernel, copy and fill on the card. A device event's
linked_correlation_id names the host operation that launched it; the
kernel belongs to a span when that operation started inside one of the
span's ranges on the same thread.
"""

from __future__ import annotations

import bisect
import collections

DEVICE_KINDS = ("cuda",)


def _is_device(ev) -> bool:
    return str(ev.device_type()).split(".")[-1].lower() in DEVICE_KINDS


def union_seconds(intervals) -> float:
    """Seconds covered by the union of [start, end) intervals (ns)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def reduce_events(events, window_ns, span_names=(), top: int = 10) -> dict:
    """events: the profiler's kineto events; window_ns: (start, end) of the
    measured window on the profiler's clock. Returns busy_s, device_ops
    (seconds by name, the largest `top`), idle_gaps (idle seconds by the
    innermost host range open when each gap began, the largest `top`) and
    span_device_s (device seconds of the kernels launched inside each of
    span_names)."""
    w0, w1 = window_ns
    dev, host_ops, ranges = [], {}, []
    # the profiler mirrors each host range on the device's timeline (its
    # gpu_user_annotation events, named as the range): not device work
    annotations = {ev.name() for ev in events if not _is_device(ev) and ev.is_user_annotation()}
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if _is_device(ev):
            if ev.name() in annotations:
                continue
            s, e = max(s, w0), min(e, w1)
            if e > s:
                dev.append((s, e, ev.name(), ev.linked_correlation_id()))
        else:
            host_ops[ev.correlation_id()] = (s, ev.start_thread_id())
            if ev.is_user_annotation() and e > s:
                ranges.append((s, e, ev.name(), ev.start_thread_id()))
    busy = union_seconds((s, e) for s, e, _, _ in dev)
    by_op = collections.Counter()
    for s, e, name, _ in dev:
        by_op[name] += (e - s) / 1e9

    # spans: sorted starts per (name, thread), each range's end beside it
    spans = collections.defaultdict(list)
    for s, e, name, tid in ranges:
        if name in span_names:
            spans[(name, tid)].append((s, e))
    for v in spans.values():
        v.sort()
    span_s = {n: 0.0 for n in span_names}
    for s, e, _, corr in dev:
        op = host_ops.get(corr)
        if op is None:
            continue
        t, tid = op
        for name in span_names:
            iv = spans.get((name, tid))
            if not iv:
                continue
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t < iv[i][1]:
                span_s[name] += (e - s) / 1e9

    # idle time on the card, each stretch of it charged to the innermost
    # host range open then (the shortest open range)
    gaps = collections.Counter()
    cursor, gap_list = w0, []
    for s, e in sorted((s, e) for s, e, _, _ in dev):
        if s > cursor:
            gap_list.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gap_list.append((cursor, w1))
    marks = [(s, 1, j) for j, (s, _, _, _) in enumerate(ranges)]
    marks += [(e, 0, j) for j, (_, e, _, _) in enumerate(ranges)]
    marks += [(gs, 2, j) for j, (gs, _) in enumerate(gap_list)]
    marks += [(ge, 3, j) for j, (_, ge) in enumerate(gap_list)]
    open_, in_gap, t_prev = {}, False, w0
    for t, kind, j in sorted(marks):
        if in_gap and t > t_prev:
            name = ranges[min(open_, key=open_.get)][2] if open_ else "(no host range)"
            gaps[name] += (t - t_prev) / 1e9
        t_prev = t
        if kind == 1:
            open_[j] = ranges[j][1] - ranges[j][0]
        elif kind == 0:
            open_.pop(j, None)
        else:
            in_gap = kind == 2
    return {"busy_s": busy,
            "device_ops": [[k, v] for k, v in by_op.most_common(top)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(top)],
            "span_device_s": span_s}
