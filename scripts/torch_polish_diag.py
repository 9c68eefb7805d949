#!/usr/bin/env python
"""Where polishing gains or loses identity: necat_tpu_torch's `assemble` of
the bench read set on one NVIDIA GPU, then polish_contigs of its draft with
variants of the polish stage, each scored against the true genome.

    python scripts/torch_polish_diag.py [--work DIR] [--out FILE] [--save DIR]

The draft comes from `cli assemble --device cuda` with phase 8's config of
chip_smoke.py (the template, MIN_READ_LENGTH=1000) and POLISH_CONTIGS=false.
Variants: the stage as it is; without the host link-DP repair of hotspots
(`_bucket_hot_overrides` returning nothing); with max_cov 20 instead of 12;
both. Each prints one JSON line: identity to the genome (chip_smoke's
contig_identity: 10 kb pieces placed by a unique 21-mer), bases, seconds by
part, and the hotspot override count. --save writes the draft and each
variant's contigs as FASTA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default="build/polish_diag")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    ap.add_argument("--save", help="directory for the contigs' FASTA files")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_polish_diag: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from necat_tpu_torch.consensus import correct
    from necat_tpu_torch.io.readstore import ReadStore
    from necat_tpu_torch.pipeline import cli, config as config_mod
    from necat_tpu_torch.pipeline.stages import load_raw_reads
    from necat_tpu_torch.polish import polish
    from necat_tpu_torch.utils.benchdata import gen_benchmark_reads

    def emit(tag: str, row: dict) -> None:
        line = f"{tag} " + json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    work = os.path.abspath(args.work)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    genome, store, _ = gen_benchmark_reads(genome_size=200_000, coverage=20, seed=7)
    store.to_fasta(os.path.join(work, "reads.fasta"))
    with open(os.path.join(work, "read_list.txt"), "w") as f:
        f.write(os.path.join(work, "reads.fasta") + "\n")
    cfg_path = os.path.join(work, "run.cfg")
    with open(cfg_path, "w") as f:
        f.write(config_mod.CONFIG_TEMPLATE.replace(
            "PROJECT=", f"PROJECT={os.path.join(work, 'project')}").replace(
            "ONT_READ_LIST=", f"ONT_READ_LIST={os.path.join(work, 'read_list.txt')}").replace(
            "GENOME_SIZE=", "GENOME_SIZE=200000").replace(
            "MIN_READ_LENGTH=3000", "MIN_READ_LENGTH=1000").replace(
            "POLISH_CONTIGS=true", "POLISH_CONTIGS=false"))
    if cli.main(["assemble", cfg_path, "--device", "cuda"]) != 0:
        return 1
    draft = ReadStore.from_fasta(os.path.join(work, "project", "4-fsa", "contigs.fasta"))
    reads = load_raw_reads(config_mod.load_config(cfg_path))
    if args.save:
        os.makedirs(args.save, exist_ok=True)
        draft.to_fasta(os.path.join(args.save, "draft.fasta"))
    emit("draft", {"identity": chip_smoke.contig_identity(draft, genome),
                   "bases": int(draft.total_bases)})
    repair = correct._bucket_hot_overrides
    base = polish.PolishOptions()
    for name, overrides, opts in (
            ("as_is", True, base),
            ("no_overrides", False, base),
            ("max_cov_20", True, dataclasses.replace(base, max_cov=20)),
            ("no_overrides_max_cov_20", False, dataclasses.replace(base, max_cov=20))):
        made = []
        correct._bucket_hot_overrides = (
            lambda *a, **k: made.append(repair(*a, **k)) or made[-1]) if overrides \
            else (lambda *a, **k: made.append({}) or {})
        correct.seconds_by_part.clear()
        t0 = time.perf_counter()
        pol = polish.polish_contigs(draft, reads, device="cuda", opts=opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        correct._bucket_hot_overrides = repair
        if args.save:
            pol.to_fasta(os.path.join(args.save, f"{name}.fasta"))
        emit(name, {"identity": chip_smoke.contig_identity(pol, genome),
                    "bases": int(pol.total_bases), "wall_s": wall,
                    "seconds_by_part": dict(correct.seconds_by_part),
                    "override_positions": sum(len(v) for o in made for v in o.values())})
    return 0


if __name__ == "__main__":
    sys.exit(main())
