"""Run cells several times, one process a run, and summarise their spread.

    python3 portbench/sets.py --workload <cell> [--workload ...] --seeds 11 12 13
        --seconds <s> [--trace 0|1] --out <file.jsonl>

Each run is `portbench/run.py` in a process of its own (as the benchmark
is run); its last stdout line, exit code, wall seconds and the end of its
stderr go to --out as one JSON line. The summary gives each metric's
median and its spread, the distance between the first and third quartiles
(statistics.quantiles, n=4) as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values) -> float:
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True, help="JSON lines, appended (relative to the checkout)")
    args = ap.parse_args()
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    for w in args.workload:
        values: dict = {}
        for seed in args.seeds:
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", w,
                                "--seed", str(seed), "--seconds", str(args.seconds),
                                "--trace", str(args.trace)],
                               cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            lines = p.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                res = None
            rec = {"workload": w, "seed": seed, "trace": args.trace, "rc": p.returncode,
                   "wall_s": wall, "result": res, "stderr": p.stderr[-6000:]}
            with out.open("a") as f:
                f.write(json.dumps(rec) + "\n")
            line = {"workload": w, "seed": seed, "rc": p.returncode, "wall_s": round(wall, 1)}
            if res:
                line["correct"] = res["correct"]
                line.update({k: v["value"] for k, v in res["metrics"].items()})
                for k, v in res["metrics"].items():
                    values.setdefault(k, []).append(v["value"])
            else:
                line["stderr"] = p.stderr[-1500:]
            print(json.dumps(line), flush=True)
        for k, v in values.items():
            print(json.dumps({"workload": w, "metric": k, "n": len(v),
                              "median": statistics.median(v), "spread": spread(v)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
