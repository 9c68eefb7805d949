#!/usr/bin/env python
"""Build the kernels, then run chip_smoke.py's phase 21 (the whole pipeline
in the adaptive band: `cli assemble` and `cli bridge` with
NECAT_TPU_NO_PALLAS, phase 11b's bridge_contigs and phase 7's planted
insertions up the ladder) on one GPU, without the other phases.

    python scripts/torch_adaptive_pipeline_run.py [--copy DIR]

Prints chip_smoke's lines and fails as the phase fails; --copy first copies
the phase's stage files and their per-record digests
(adaptive_record_digests.json) into DIR, also when the phase fails, so that
a difference from the JAX package's files can be placed.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--copy", default=None)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("torch_adaptive_pipeline_run: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    os.environ["NECAT_TPU_MAX_STAGE_ERROR"] = "1"
    smi = cs.probe()
    cs.build()
    print(f"torch_adaptive_pipeline_run: built at {time.perf_counter() - t0:.1f} s", flush=True)
    cfg_path, genome, _ = cs.bench_project()
    try:
        cs.check_adaptive_pipeline(dev, {}, cfg_path, genome, smi)
    finally:
        if args.copy:
            os.makedirs(args.copy, exist_ok=True)
            prj = os.path.join(cs.WORK, "project_adaptive")
            for key, path in cs.pipeline_paths(prj, os.path.join(
                    cs.WORK, "adaptive_polished_assemble.fasta")).items():
                ext = ".fasta.gz" if path.endswith(".gz") else ".fasta"
                if os.path.exists(path):
                    shutil.copy(path, os.path.join(args.copy, key + ext))
            for path in glob.glob(os.path.join(cs.WORK, "adaptive_*")):
                shutil.copy(path, args.copy)
        print(f"torch_adaptive_pipeline_run: {time.perf_counter() - t0:.1f} s")
        print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
