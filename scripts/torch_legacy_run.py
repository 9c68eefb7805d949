#!/usr/bin/env python
"""Build the kernels, then run chip_smoke.py's main path, its phase 8
(`cli correct`), phase 20 (the adaptive band) and phase 22 (the legacy
two-program correction against the fused flow) on one GPU, without the
other phases.

    python scripts/torch_legacy_run.py [--out legacy.json]

Prints chip_smoke's lines; phase 22's summary goes to --out as JSON. Fails
as a phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("torch_legacy_run: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    os.environ["NECAT_TPU_MAX_STAGE_ERROR"] = "1"
    smi = cs.probe()
    cs.build()
    launch_counts = {}
    main_res, main_inputs = cs.main_path(dev, launch_counts)
    cfg_path, _ = cs.check_correct(launch_counts, main_res)
    os.makedirs(cs.PHASE10, exist_ok=True)     # phase 10 keeps phase 8's cns_final
    shutil.copy(os.path.join(cs.WORK, "project", cs.PHASE10_FILES[0]), cs.PHASE10)
    _, adaptive_recs = cs.check_adaptive(dev, launch_counts, main_inputs, smi)
    print(f"torch_legacy_run: phases 5, 8 and 20 done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    summary = cs.check_legacy(dev, launch_counts, main_inputs, adaptive_recs, cfg_path, smi)
    print(f"torch_legacy_run: {time.perf_counter() - t0:.1f} s")
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
