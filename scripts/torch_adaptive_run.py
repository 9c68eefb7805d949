#!/usr/bin/env python
"""Build the kernels, then run chip_smoke.py's main path and its phase 20
(the adaptive band: K1a and K3a against their plain versions at every width
of KERNEL_WIDTHS, and main with NECAT_TPU_NO_PALLAS) on one GPU, without
the other phases.

    python scripts/torch_adaptive_run.py [--out adaptive.json]
        [--dump adaptive_records.npz]

Also K1, K2 and K3 at W=128 on the same chunk as K1a and K3a (phase 3's
check), for chip_smoke's "adaptive/static" line. Prints chip_smoke's lines;
the kernel rows and the ratios go to --out as JSON, phase 20's records to
--dump (chip_smoke.dump_records). Fails as the phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args()
    import time
    import torch
    import chip_smoke as cs
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("torch_adaptive_run: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.probe()
    cs.build()
    print(f"torch_adaptive_run: built at {time.perf_counter() - t0:.1f} s", flush=True)
    static = cs.check_kernels(dev)                     # K1, K2, K3 at 128 (same chunk)
    launch_counts = {}
    _, main_inputs = cs.main_path(dev, launch_counts)
    print(f"torch_adaptive_run: main done at {time.perf_counter() - t0:.1f} s", flush=True)
    rows, _ = cs.check_adaptive(dev, launch_counts, main_inputs, smi, dump=args.dump)
    ratios = cs.adaptive_ratios({**static, **rows})
    print(f"torch_adaptive_run: {time.perf_counter() - t0:.1f} s")
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "kernels": list(rows.values()) + list(static.values()),
                       "ratios": ratios,
                       "launches": {p: cs._by_width(c) for p, c in launch_counts.items()}},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
