"""Run one cell of the port's benchmark once and print its result as the
last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (necat_tpu_torch). The
cell's inputs come from the seed; --trace 0 reports the cell's end-to-end
metrics, --trace 1 its per-layer metrics from a profiled window. A run
needs as many CUDA cards as the cell asks for: without them it exits 2 and
prints no result. The port's kernels build into the checkout's build/, the
cache that a cell's later runs reuse.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
THREADS = 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    # host threads of the deployment (THREADS=4 of necat.pl's template)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    # build and kernel caches at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    from portbench import harness
    cell = harness.load_cell(ROOT, args.workload)
    import torch
    torch.set_num_threads(THREADS)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    from portbench import inputs
    inputs.START = T_START
    print(inputs.stamp("cuda").strip(), file=sys.stderr)
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         root=ROOT, device="cuda", t_start=T_START)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
