"""Command line of the PyTorch port (necat.pl commands).

  python -m necat_tpu_torch.pipeline.cli config   <cfg>                      # config template
  python -m necat_tpu_torch.pipeline.cli correct  <cfg> [--device DEVICES]   # correct raw reads
  python -m necat_tpu_torch.pipeline.cli assemble <cfg> [--device DEVICES]   # correct + trim + assemble [+ polish]
  python -m necat_tpu_torch.pipeline.cli bridge   <cfg> [--device DEVICES]   # assemble + bridge [+ polish]

`--device cuda` (the default) runs the CUDA kernels and fails where CUDA is
missing; `--device cpu` runs their plain PyTorch versions; a comma-separated
list (`cuda:0,cuda:1`) shares the work over those devices. Several
processes share a run through NECAT_TPU_COORDINATOR, NECAT_TPU_NUM_PROCS
and NECAT_TPU_PROC_ID (necat_tpu_torch/parallel/launcher.py).
"""

from __future__ import annotations

import argparse
import sys

from necat_tpu_torch.pipeline import config as config_mod
from necat_tpu_torch.pipeline.stages import Project
from necat_tpu_torch.utils.device import resolve_devices
from necat_tpu_torch.utils.logging import logger


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m necat_tpu_torch.pipeline.cli",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("command", choices=("config", "correct", "assemble", "bridge"))
    ap.add_argument("cfg")
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run: cuda (the default), cpu, or a "
                         "comma-separated list such as cuda:0,cuda:1")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.command == "config":
        config_mod.write_template(args.cfg)
        print(f"wrote config template to {args.cfg}")
        return 0
    try:
        resolve_devices(args.device)     # no CUDA, a bad name: fail before any work
    except ValueError as e:
        ap.error(str(e))
    cfg = config_mod.load_config(args.cfg)
    prj = Project(cfg, cfg.project)
    if args.command == "correct":
        out = prj.run_correct(device=args.device)
    else:
        run = prj.run_assemble if args.command == "assemble" else prj.run_bridge
        out = run(device=args.device)
        if cfg.polish:
            out = prj.run_polish(out, "final", device=args.device)
    if cfg.get("CLEANUP", "0") in ("1", "true"):
        prj.cleanup()
    logger.info("final output: %s", out)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
