#!/usr/bin/env python
"""Which span torch.profiler credits with the device time of a kernel that
the port launches through ctypes, for the kernel library as it is built
(cudart linked statically, nvcc's default) or with ``-cudart=shared``.

    python scripts/torch_trace_attribution_probe.py [--cudart static|shared]

Under three record_function ranges, three times each: one tags.scatter_chunk
call on a synthetic chunk (two launches of tag_scatter_kernel), one K1
launch (banded_forward at W=128) and one ATen op pair (a product and a sum).
The trace is reduced with the benchmark's own reader (portbench/trace.py
reduce_events), which credits a device event to a span through its linked
correlation id. Prints each device event (name, ns, its linked correlation
id and the host op of that id, its own correlation id and the host runtime
call of that id with the range the call was made in) and, last, one JSON
line: the cudart variant; per kernel the events, those linked to id 0, and
those whose own id names a runtime launch made inside a range; and the
device seconds the reader credits to each range. ``shared`` builds its library into
build/cudart_shared/ and leaves build/libnecat_kernels.so as it is. Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RANGES = ("probe.scatter", "probe.k1", "probe.aten")


def synthetic_chunk(dev, P=64, MC=300, TB=5, Lt=400, seed=5):
    """scatter_chunk's arguments after weights and coverage, one insb word a
    pass: random column codes, clips, anchors and rows (some dropped)."""
    import torch
    g = torch.Generator().manual_seed(seed)

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, dtype=dtype).to(dev)

    def side():                  # cols, (insb,), lead, leadb, jc
        return [ints(0, 1 << 8, (P, MC)), (ints(0, 1 << 28, (P, MC)),), ints(0, 4, (P,)),
                ints(0, 4, (P, 7), torch.uint8), ints(0, MC + 1, (P,))]

    return side() + side() + [ints(0, Lt, (P,)), ints(-1, TB + 1, (P,)),
                              torch.rand(P, generator=g).to(dev), ints(Lt // 2, Lt + 1, (P,))]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cudart", choices=("static", "shared"), default="static")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_trace_attribution_probe: CUDA is not available", file=sys.stderr)
        return 1
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.consensus import tags
    from necat_tpu_torch.utils import build
    from portbench import trace

    if args.cudart == "shared":
        build.NVCC_FLAGS = (*build.NVCC_FLAGS, "-cudart=shared")
        build.BUILD_DIR = build.BUILD_DIR / "cudart_shared"
        build.LIBRARY = build.BUILD_DIR / build.LIBRARY.name
        build.BUILD_LOG = build.BUILD_DIR / build.BUILD_LOG.name
    dev = torch.device("cuda")
    TB, D, Lt = 5, 8, 400
    chunk = synthetic_chunk(dev, TB=TB, Lt=Lt)
    w = torch.zeros((TB + 1, D, 5, Lt), dtype=torch.float64, device=dev)
    c = torch.zeros((TB + 1, Lt), dtype=torch.int32, device=dev)
    a = torch.randint(0, 4, (64, 1024), dtype=torch.uint8, device=dev)
    la = torch.full((64,), 1000, dtype=torch.int32, device=dev)

    def step():
        with torch.profiler.record_function("probe.scatter"):
            tags.scatter_chunk(w, c, *chunk)
        with torch.profiler.record_function("probe.k1"):
            bk.banded_forward(a, a, la, la, 128)
        with torch.profiler.record_function("probe.aten"):
            (w * 2).sum()

    step()                                 # builds and loads the library, warms up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    host = {ev.correlation_id(): ev for ev in events if not trace._is_device(ev)}
    ranges = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()) for ev in events
              if not trace._is_device(ev) and ev.name() in RANGES]

    def range_of(ev):
        t = ev.start_ns()
        return next((name for s, e, name in ranges if s <= t < e), None)

    kernels = collections.defaultdict(collections.Counter)
    for ev in events:
        if trace._is_device(ev) and not ev.is_user_annotation():
            linked, own = ev.linked_correlation_id(), ev.correlation_id()
            op, launch = host.get(linked), host.get(own)
            print("device", ev.name()[:60], ev.duration_ns(), "ns; linked", linked,
                  "->", op.name() if op else None, "; own", own, "->",
                  launch.name() if launch else None, "in", range_of(launch) if launch else None)
            k = kernels[ev.name().replace("void ", "").replace("(anonymous namespace)::", "")[:32]]
            k["events"] += 1
            k["linked_0"] += linked == 0
            if launch is not None and range_of(launch):
                k[f"own_id_launched_in_{range_of(launch)}"] += 1
    red = trace.reduce_events(events, (0, 1 << 62), RANGES)
    print(json.dumps({"cudart": args.cudart, "kernels": kernels,
                      "span_device_s": red["span_device_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
