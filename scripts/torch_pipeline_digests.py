#!/usr/bin/env python
"""The port's `cli assemble` and then `cli bridge` of the bench read set in
the adaptive band (NECAT_TPU_NO_PALLAS=1), on the CPU unless --device says
otherwise, as file digests: the counterpart of
scripts/jax_pipeline_reference.py, for showing that the port's CPU run (the
kernels' plain versions) writes the files that chip_smoke.py's phase 21
writes on the card (scripts/torch_adaptive_pipeline_run.py runs that phase
alone).

    python scripts/torch_pipeline_digests.py [--device cpu] [--work DIR] [--out FILE]
        [--cns-final FILE]

The reads and config are chip_smoke.py's phase 8 and 21's, and the commands
run through chip_smoke.run_pipeline, as in phase 21 and the JAX script;
prints one JSON line with chip_smoke.fasta_digest of each file of
chip_smoke.pipeline_paths and each stage's seconds; --out writes the
per-record digests (chip_smoke.fasta_record_digests). --cns-final FILE
stands in for the correct stage's output, as in the JAX script. Resumable by
the manifests. On an 8-core CPU shared with other runs, the correct stage
took 74 min and trim 20 min.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--work", default="build/torch_pipeline_digests")
    ap.add_argument("--out", default=None, help="JSON file of per-record digests")
    ap.add_argument("--cns-final", default=None)
    args = ap.parse_args()
    os.environ["NECAT_TPU_NO_PALLAS"] = "1"
    import chip_smoke
    from necat_tpu_torch.pipeline import cli
    work = os.path.abspath(args.work)
    prj = os.path.join(work, "project")
    cfg_path, _, _ = chip_smoke.bench_project(work, fresh=False)
    paths, walls, _ = chip_smoke.run_pipeline(
        cli, cfg_path, prj, os.path.join(work, "polished_contigs.assemble.fasta"),
        device=args.device, cns_final=args.cns_final)
    print(json.dumps({
        "device": args.device, "walls_s": walls, "stages_s": chip_smoke.stage_seconds(prj),
        "files": {k: chip_smoke.fasta_digest(p) for k, p in paths.items()}}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({k: chip_smoke.fasta_record_digests(p) for k, p in paths.items()}, f,
                      indent=0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
