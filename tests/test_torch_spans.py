"""The port's timing scopes as spans (necat_tpu_torch/utils/logging.py): ids
and parents from each thread's own stack, stamps on torch.profiler's clock,
a profiler range per scope while a profiler runs, nothing at all while
timing is off, the general counter, and the Chrome trace that
NECAT_TPU_TRACE writes at exit."""

import gc
import json
import os
import pathlib
import statistics
import subprocess
import sys
import threading
import time

import pytest
import torch

from necat_tpu_torch.overlap.overlapper import find_all_candidates
from necat_tpu_torch.utils import logging as tlogging
from torch_port_helpers import SMALL_MAP_OPTIONS, small_store

REPO = pathlib.Path(__file__).resolve().parents[1]
PER_SHARD = ("cand.limits", "cand.dispatch", "cand.exec", "cand.stats_sync")


@pytest.fixture
def tracing(monkeypatch, tmp_path):
    """Timing on with the spans kept; cleared before and after."""
    monkeypatch.setattr(tlogging, "TIMING_ON", True)
    monkeypatch.setattr(tlogging, "TRACE_PATH", str(tmp_path / "spans.json"))
    tlogging.reset_timers()
    yield
    tlogging.reset_timers()


def _check_nesting(spans):
    """Unique ids; a parent is an earlier-opened span of the same thread that
    holds its child in time. Returns {id: span}."""
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent:
            p = by_id[s.parent]
            assert p.id < s.id and p.thread == s.thread
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    return by_id


def test_nested_spans_per_thread(tracing):
    """Threads nest scopes three deep at once, more threads than cores and
    a short switch interval: every span is kept with a unique id, and its
    parent is the scope its own thread had open, never another thread's."""
    n_threads, n_calls = 2 * (os.cpu_count() or 1) + 2, 50
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tids = {}
    try:
        def work(k):
            tids[k] = threading.get_native_id()
            for i in range(n_calls):
                with tlogging.timed(f"outer.{k}"):
                    with tlogging.timed(f"mid.{k}"):
                        with tlogging.timed(f"inner.{k}"):
                            pass
                    with tlogging.timed(f"mid2.{k}"):
                        pass

        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = tlogging.spans()
    assert len(spans) == 4 * n_threads * n_calls
    by_id = _check_nesting(spans)
    want_parent = {"outer": None, "mid": "outer", "inner": "mid", "mid2": "outer"}
    for s in spans:
        kind, k = s.name.split(".")
        assert s.thread == tids[int(k)]
        if want_parent[kind] is None:
            assert s.parent == 0
        else:
            assert by_id[s.parent].name == f"{want_parent[kind]}.{k}"
    rep = tlogging.timing_report()
    assert all(rep[s.name][1] == n_calls for s in spans)


def test_spans_under_shard_threads(tracing, monkeypatch):
    """The candidate search on two devices, one host thread per shard: the
    per-shard scopes are spans of two threads other than the caller's, each
    a root of its thread or nested in that thread's own scopes, and the
    spans match the report call for call."""
    _, rs = small_store()
    monkeypatch.setenv("NECAT_TPU_SYNC_DISPATCH", "1")
    find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise=True,
                        device=["cpu:0", "cpu:1"])
    spans = tlogging.spans()
    _check_nesting(spans)
    rep = tlogging.timing_report()
    counts = {}
    for s in spans:
        counts[s.name] = counts.get(s.name, 0) + 1
    assert counts == {k: c for k, (_, c) in rep.items() if c}
    me = threading.get_native_id()
    for name in PER_SHARD:
        threads = {s.thread for s in spans if s.name == name}
        assert len(threads) == 2 and me not in threads, name
    assert {s.thread for s in spans if s.name == "cand.batch_total"} == {me}


def _ranges(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


def test_spans_line_up_with_profiler_ranges(tracing):
    """Under a CPU torch.profiler each scope opens a profiler range of its
    name, stamped on the same Unix-epoch clock as its span: the span holds
    its range (stamped just outside it, so a stall of the process between
    a stamp and the range's edge only widens the span) to within 1 ms, and
    the typical span lies within 1 ms of its range at both ends."""
    gc.disable()        # a collection between a stamp and its range's edge
    try:                # is a stall, not a clock offset
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for i in range(3):
                with tlogging.timed("span.outer"):
                    time.sleep(0.002)
                    with tlogging.timed("span.inner"):
                        torch.ones(64).sum()
                        time.sleep(0.003)
    finally:
        gc.enable()
    spans = tlogging.spans()
    assert len(spans) == 6
    ranges = _ranges(prof)
    assert sum(name.startswith("span.") for name, _, _ in ranges) == 6
    offsets = []
    for s in spans:
        # the range of the name that starts nearest the span's start
        r0, r1 = min(((r0, r1) for name, r0, r1 in ranges if name == s.name),
                     key=lambda r: abs(r[0] - s.start_ns))
        assert s.start_ns - 1_000_000 <= r0 <= r1 <= s.end_ns + 1_000_000, (s, r0, r1)
        offsets.append(max(abs(r0 - s.start_ns), abs(r1 - s.end_ns)))
    assert statistics.median(offsets) < 1_000_000, offsets


def test_timing_off_records_nothing(monkeypatch, tmp_path):
    """With timing off, even with a trace path set and a profiler running:
    no scope, no counter, no span and no range of the scope's name."""
    monkeypatch.setattr(tlogging, "TIMING_ON", False)
    monkeypatch.setattr(tlogging, "TRACE_PATH", str(tmp_path / "spans.json"))
    tlogging.reset_timers()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tlogging.timed("off.scope"):
            torch.ones(8).sum()
        tlogging.count("off.counter", 3.0)
        tlogging.count_lanes(8, 3, 1024)
    assert tlogging.timing_report() == {}
    assert tlogging.spans() == []
    assert not any(name.startswith("off.") for name, _, _ in _ranges(prof))


def test_count_and_reset(tracing):
    """count adds to a counter reported with 0 calls and makes no span;
    reset_timers clears the scopes, the counters and the spans."""
    tlogging.count("t.counter", 1.25)
    tlogging.count("t.counter", 0.5)
    with tlogging.timed("t.scope"):
        pass
    rep = tlogging.timing_report(ndigits=None)
    assert rep["t.counter"] == (1.75, 0)
    assert [s.name for s in tlogging.spans()] == ["t.scope"]
    tlogging.reset_timers()
    assert tlogging.timing_report() == {} and tlogging.spans() == []


def test_trace_written_at_exit(tmp_path):
    """NECAT_TPU_TRACE=<file> turns timing on and, at exit, writes the spans
    to <file> as a Chrome trace: complete events in microseconds since the
    epoch, id and parent in args, nested by parent on one thread; the report
    still goes to stderr and stdout's last line stays the caller's."""
    path = tmp_path / "spans.json"
    code = ("import time\n"
            "from necat_tpu_torch.utils.logging import TIMING_ON, timed\n"
            "assert TIMING_ON\n"
            "t0 = time.time_ns()\n"
            "with timed('cns.compact'):\n"
            "    with timed('cns.padded_batch'):\n"
            "        time.sleep(0.002)\n"
            "    with timed('cns.compact_packed'):\n"
            "        pass\n"
            "print(t0)\n")
    env = {**os.environ, "NECAT_TPU_TRACE": str(path), "PYTHONPATH": str(REPO)}
    env.pop("NECAT_TPU_TIMING", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    t0_us = int(proc.stdout.strip()) / 1e3
    assert sum(ln.startswith("[timing] ") for ln in proc.stderr.splitlines()) == 3
    trace = json.loads(path.read_text())
    ev = {e["name"]: e for e in trace["traceEvents"]}
    assert set(ev) == {"cns.compact", "cns.padded_batch", "cns.compact_packed"}
    assert all(e["ph"] == "X" and e["pid"] == ev["cns.compact"]["pid"] for e in ev.values())
    assert len({e["tid"] for e in ev.values()}) == 1
    top = ev["cns.compact"]
    assert top["args"]["parent"] == 0
    assert t0_us <= top["ts"] < t0_us + 10e6
    for name in ("cns.padded_batch", "cns.compact_packed"):
        e = ev[name]
        assert e["args"]["parent"] == top["args"]["id"] != e["args"]["id"]
        assert top["ts"] <= e["ts"] and e["ts"] + e["dur"] <= top["ts"] + top["dur"] + 1
    assert ev["cns.padded_batch"]["dur"] >= 2000
