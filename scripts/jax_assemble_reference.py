#!/usr/bin/env python
"""necat_tpu's own `assemble` of the bench read set on the CPU: the
reference for chip_smoke.py's JAX_CPU_ASSEMBLY_REFERENCE.

    JAX_PLATFORMS=cpu python scripts/jax_assemble_reference.py [--work DIR]

The reads (gen_benchmark_reads(200_000, 20, seed=7)) and the config (the
template, MIN_READ_LENGTH=1000, POLISH_CONTIGS=true) are those of
chip_smoke.py's correct and assemble phases; `python -m
necat_tpu.pipeline.cli assemble` runs on them (on the CPU the JAX package
takes its adaptive band). Prints one JSON line: contig count, N50, and the
identity of the draft and the polished contigs to the true genome as
chip_smoke.contig_identity measures it. Resumable: a rerun skips the stages
whose manifests are current.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default="build/jax_assemble_reference")
    args = ap.parse_args()
    import chip_smoke
    from necat_tpu.io.readstore import ReadStore
    from necat_tpu.pipeline import cli, config as config_mod
    from necat_tpu.utils.benchdata import gen_benchmark_reads
    work = os.path.abspath(args.work)
    os.makedirs(work, exist_ok=True)
    genome, store, _ = gen_benchmark_reads(genome_size=200_000, coverage=20, seed=7)
    reads = os.path.join(work, "reads.fasta")
    if not os.path.exists(reads):
        store.to_fasta(reads)
    with open(os.path.join(work, "read_list.txt"), "w") as f:
        f.write(reads + "\n")
    cfg_path = os.path.join(work, "run.cfg")
    with open(cfg_path, "w") as f:
        f.write(config_mod.CONFIG_TEMPLATE.replace(
            "PROJECT=", f"PROJECT={os.path.join(work, 'project')}").replace(
            "ONT_READ_LIST=", f"ONT_READ_LIST={os.path.join(work, 'read_list.txt')}").replace(
            "GENOME_SIZE=", "GENOME_SIZE=200000").replace(
            "MIN_READ_LENGTH=3000", "MIN_READ_LENGTH=1000"))
    t0 = time.perf_counter()
    if cli.main(["assemble", cfg_path]) != 0:
        return 1
    draft = ReadStore.from_fasta(os.path.join(work, "project", "4-fsa", "contigs.fasta"))
    polished = ReadStore.from_fasta(os.path.join(work, "project", "polished_contigs.fasta"))
    print(json.dumps({
        "wall_s": time.perf_counter() - t0, "contigs": draft.n_reads,
        "contig_n50": draft.n50()[0],
        "draft_identity": chip_smoke.contig_identity(draft, genome)[0],
        "polished_identity": chip_smoke.contig_identity(polished, genome)[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
