"""The controls of the benchmark's checks, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 21 22 23 [--units 1]
        --out <file.jsonl>

For each seed: the cell's set-up, a short window of --units units (enough
to have answers to check), then the check's reading of the program against
the reference and the control's reading on the same sample (the reference
put in the program's place with the step a later change would be tempted
by: bfloat16 pair weights for correction). A limit sits between the
largest sound reading and the smallest control reading. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--out", required=True, help="JSON lines, appended (relative to the checkout)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from portbench import harness
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    job = harness.load_module(ROOT / "portbench" / "jobs" / f"{cell.traffic['job']}.py")
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        st = job.setup({"config": cell.config, "traffic": cell.traffic, "seed": seed,
                        "device": "cuda", "log": io.StringIO()})
        for i in range(args.units):
            job.unit(st, i)
        job.release(st)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        sound = {k: v for k, (v, _) in job.check(st, np.random.default_rng([seed, 7])).items()}
        t2 = time.perf_counter()
        control = job.control(st, np.random.default_rng([seed, 7]))
        t3 = time.perf_counter()
        rec = {"workload": args.workload, "seed": seed, "sound": sound, "control": control,
               "setup_and_units_s": t1 - t0, "check_s": t2 - t1, "control_s": t3 - t2}
        print(json.dumps(rec), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        del st
    return 0


if __name__ == "__main__":
    sys.exit(main())
