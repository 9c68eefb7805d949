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
import atexit as _atexit
import collections as _collections
import contextlib as _contextlib
import os as _os
import threading as _threading
import time as _time

_TIMERS = _collections.Counter()
_COUNTS = _collections.Counter()
_LOCK = _threading.Lock()
TIMING_ON = bool(_os.environ.get("NECAT_TPU_TIMING"))

# The JAX package's scope names that the port has no code for.
NO_COUNTERPART = (
    # the JAX package issues an early asynchronous device-to-host copy of a
    # chunk's stats; the port issues none: the stats come back at their
    # first read (ext.stats_sync)
    "ext.stats_copy_issue",
    "cns.fused_stats_issue",
)


@_contextlib.contextmanager
def timed(name: str):
    """Add the wall-clock seconds of the block to scope `name`, and one call
    (nothing but a flag test while timing is off)."""
    if not TIMING_ON:
        yield
        return
    t0 = _time.perf_counter()
    try:
        yield
    finally:
        dt = _time.perf_counter() - t0
        with _LOCK:
            _TIMERS[name] += dt
            _COUNTS[name] += 1


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


def reset_timers() -> None:
    """Clear every scope and counter (to measure one run)."""
    with _LOCK:
        _TIMERS.clear()
        _COUNTS.clear()


if TIMING_ON:
    @_atexit.register
    def _dump_timers():
        # stderr only: a caller's last stdout line (chip_smoke.py's status
        # line) stays its own
        for k, (v, c) in timing_report().items():
            print(f"[timing] {k}: {v}s over {c} calls", file=sys.stderr)
