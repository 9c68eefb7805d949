"""Timestamped logger of the port (the role of necat_tpu/utils/logging.py;
OC_LOG / plgdInfo, ontcns_aux.h:19-35), and its host timing scopes."""

from __future__ import annotations

import logging
import sys

logger = logging.getLogger("necat_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(asctime)s [%(levelname)s] %(message)s",
                                      datefmt="%Y-%m-%d %H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


# ----------------------------------------------------------------- timing
# The TIMING_START/TIMING_END role (src/common/ontcns_aux.h:107-116), as
# necat_tpu/utils/logging.py:15-54 has it: accumulating wall-clock scopes
# under the JAX package's names, on with NECAT_TPU_TIMING=1 (read here at
# import; timed reads TIMING_ON at each call, so a caller may set it), the
# report written to stderr at exit. A scope ends where the host waits: the
# port's device work is asynchronous until a .cpu()/.item(), so device time
# lands in the scope of the first host read of a result, unless
# NECAT_TPU_SYNC_DISPATCH (read at each dispatch) makes the dispatch wait for
# the device inside its *exec* scope (sync_dispatch). The host threads of
# parallel/mesh.shard_stats time scopes at once, hence the lock, which the
# JAX package's single host thread did not need.
#
# A scope is also a span on the profiler's clock. While a torch.profiler
# runs, each scope opens a record_function range of its name, so that the
# device trace puts an idle gap down to the scope open at the time. With
# NECAT_TPU_TRACE=<file> (which implies timing; read at import, TRACE_PATH)
# each scope is kept as a span, with an id, the id of the span open around
# it on the same thread (0 for none) and its start and end from
# time.time_ns(), the Unix-epoch clock torch.profiler stamps its events
# with; at exit the spans go to <file> as a Chrome trace (write_trace).
import atexit as _atexit
import collections as _collections
import contextlib as _contextlib
import itertools as _itertools
import json as _json
import os as _os
import threading as _threading
import time as _time

_TIMERS = _collections.Counter()
_COUNTS = _collections.Counter()
_LOCK = _threading.Lock()
TRACE_PATH = _os.environ.get("NECAT_TPU_TRACE") or None
TIMING_ON = bool(_os.environ.get("NECAT_TPU_TIMING")) or TRACE_PATH is not None

Span = _collections.namedtuple("Span", "name id parent thread start_ns end_ns")
_SPANS: list = []                   # Span tuples, while TRACE_PATH is set
_IDS = _itertools.count(1)          # span ids; next() on it is atomic
_LOCAL = _threading.local()         # .state: _thread_state()

# The JAX package's scope names that the port has no code for.
NO_COUNTERPART = (
    # the JAX package issues an early asynchronous device-to-host copy of a
    # chunk's stats; the port issues none: the stats come back at their
    # first read (ext.stats_sync)
    "ext.stats_copy_issue",
    "cns.fused_stats_issue",
)

# The names the port records and the JAX package does not.
PORT_ONLY = (
    # the fused path's tag scatter (fused._accept_and_scatter), inside
    # cns.fused_call; the JAX package's scatter is part of its one fused
    # program, with nothing to time on the host
    "cns.tag_scatter",
    # host seconds blocked at the scatter's nonzero calls (tags._scatter_pass,
    # four per pass, two passes a chunk), each a device-to-host sync that
    # waits for all work queued before it; the JAX package's matrix-product
    # scatter has fixed shapes and no sync
    "cns.scatter_sync",
    # the two parts of cns.compact: the template rows (views of the read
    # store, one a bucket row) and the per-template slicing of the
    # consensus stream into pieces (compact_from_stream)
    "cns.padded_batch",
    "cns.compact_packed",
    # counter: the MB that cns.download brings to the host, per bucket its
    # consensus stream, cum_t and cov8 (and the hot mask on the wide-delta
    # path); the JAX package downloads its packed int32 per column instead
    "cns.download_MB",
    # record emission (correct._emit_records), after cns.compact, which the
    # JAX package does not time
    "cns.emit_records",
    # counter: the summed max(query, window) length of a chunk's real lanes,
    # which its length tier was chosen for, in millions; over
    # ext.cell_Mlanes (lanes x tier) it is the share of the planned cells
    # that hold work
    "ext.live_Mcols",
    # the long-indel rescue of the fused path (correct._run_waves with
    # rescue_long_indels), inside cns.extend_pairs_total: round 0's ladder
    # (_ident_ladder), round 0's second dispatch of every lane at its
    # decided band, and the later rounds' ladder of deferred lanes
    # (_defer_ladder); the JAX package runs the same steps untimed
    "cns.ident_ladder",
    "cns.round0_replay",
    "cns.defer_ladder",
    # counters of the rescue: the real lanes the ladders dispatch at a band
    # above band_width, and the lanes of round 0's second dispatch
    "cns.rung_lanes",
    "cns.replay_lanes",
)


def _thread_state() -> tuple:
    """(the ids of this thread's open spans, its native thread id). The id is
    read once per thread: it is a system call, which on a loaded host costs
    far more than the rest of a span's bookkeeping."""
    st = getattr(_LOCAL, "state", None)
    if st is None:
        st = _LOCAL.state = ([], _threading.get_native_id())
    return st


@_contextlib.contextmanager
def timed(name: str):
    """Add the wall-clock seconds of the block to scope `name`, and one call
    (nothing but a flag test while timing is off); a profiler range of the
    name while a torch.profiler runs, and a span while TRACE_PATH is set."""
    if not TIMING_ON:
        yield
        return
    # no torch imported, no profiler running: the logger stays free of torch
    prof = sys.modules.get("torch.autograd.profiler")
    rng = (prof.record_function(name) if getattr(prof, "_is_profiler_enabled", False)
           else _contextlib.nullcontext())
    st = None
    if TRACE_PATH is not None:
        st, tid = _thread_state()
        sid, parent = next(_IDS), (st[-1] if st else 0)
        st.append(sid)
    # the span is stamped outside the range: the profiler's first range in
    # a process stamps its start before a set-up of about a millisecond,
    # which then falls inside the span, not between the two starts
    t0 = _time.perf_counter()
    w0 = _time.time_ns() if st is not None else 0
    try:
        with rng:
            yield
    finally:
        w1 = _time.time_ns() if st is not None else 0
        dt = _time.perf_counter() - t0
        span = None
        if st is not None:
            st.pop()
            span = Span(name, sid, parent, tid, w0, w1)
        with _LOCK:
            _TIMERS[name] += dt
            _COUNTS[name] += 1
            if span is not None:
                _SPANS.append(span)


def count(name: str, value: float) -> None:
    """Add `value` to counter `name` (reported with 0 calls; nothing but a
    flag test while timing is off)."""
    if not TIMING_ON:
        return
    with _LOCK:
        _TIMERS[name] += value


def count_lanes(lanes: int, real: int, length: int) -> None:
    """The lane counters of one extension chunk (reported with 0 calls):
    ext.lanes (lanes run), ext.real_lanes (the pairs among them) and
    ext.cell_Mlanes (lanes times the length tier, in millions)."""
    if not TIMING_ON:
        return
    with _LOCK:
        _TIMERS["ext.lanes"] += lanes
        _TIMERS["ext.real_lanes"] += real
        _TIMERS["ext.cell_Mlanes"] += lanes * length / 1e6


def sync_dispatch(name: str, device) -> None:
    """Under NECAT_TPU_SYNC_DISPATCH, wait for `device` (a CUDA device; on the
    CPU the work is done already) in scope `name`, so that a dispatch's
    device time is charged to it."""
    if _os.environ.get("NECAT_TPU_SYNC_DISPATCH"):
        import torch                 # the logger alone stays free of torch
        with timed(name):
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)


def timing_report(ndigits: int | None = 2) -> dict:
    """{name: (seconds rounded to ndigits, or not at all with None, calls)},
    the most expensive first."""
    with _LOCK:
        return {k: (v if ndigits is None else round(v, ndigits), _COUNTS[k])
                for k, v in _TIMERS.most_common()}


def spans() -> list:
    """The kept spans (Span tuples), in the order they ended."""
    with _LOCK:
        return list(_SPANS)


def reset_timers() -> None:
    """Clear every scope, counter and span (to measure one run)."""
    with _LOCK:
        _TIMERS.clear()
        _COUNTS.clear()
        _SPANS.clear()


def write_trace(path) -> None:
    """Write the kept spans to `path` as a Chrome trace: one complete ("X")
    event per span, in microseconds since the Unix epoch (the clock of
    torch.profiler's own trace, so that Perfetto shows both on one
    timeline), the span's id and parent in its args."""
    pid = _os.getpid()
    events = [{"name": s.name, "ph": "X", "ts": s.start_ns / 1e3,
               "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid, "tid": s.thread,
               "args": {"id": s.id, "parent": s.parent}} for s in spans()]
    with open(path, "w") as f:
        _json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


if TIMING_ON:
    @_atexit.register
    def _dump_timers():
        # stderr only: a caller's last stdout line (chip_smoke.py's status
        # line) stays its own
        for k, (v, c) in timing_report().items():
            print(f"[timing] {k}: {v}s over {c} calls", file=sys.stderr)
        if TRACE_PATH is not None:
            write_trace(TRACE_PATH)
