#!/usr/bin/env python
"""One `assemble` run of necat_tpu_torch on one NVIDIA GPU, at a scale of
choice, through the pipeline's stages (correct -> trim -> assemble ->
polish), then the bridge stage on the assembled contigs.

    python scripts/torch_assemble_run.py [--genome-size 4600000] [--coverage 40]
        [--seed 7] [--work DIR] [--out FILE] [--no-polish] [--vol-size BASES]

The reads are gen_benchmark_reads(genome_size, coverage, seed) (the E. coli
stand-in of bench.py at the defaults), the config is the template's with
POLISH_CONTIGS=true. After each stage the stage's manifest
(<stage>.done.json: wall and parts) is printed as one JSON line, so that a
run cut by a time limit still shows how far it got; the last line adds the
contigs' count, bases and N50, peak device memory and the launches per
(kernel, W). The bridge stage (Project.run_bridge: all raw reads mapped
to 4-fsa/contigs.fasta, the contigs to each other, contigs joined; its
output is not polished) follows, on a line of its own: the stage's manifest
(seconds of map, c2c, graph and junction, links, pairs per band), contigs
and N50 in and out, its peak device memory and its launches per (kernel,
W). --no-polish leaves the polish stage out. --vol-size sets VOL_SIZE
(subject volumes of at most that many bases in correct, trim and assemble)
and first runs the correct stage's first candidate search (its input read
set, OVLP_SENSITIVE_OPTIONS) untiled and in volumes: the "volumes" line
holds both searches' seconds, index-build seconds and peak device memory,
and whether the candidates are equal field for field. Nothing else is
compared: this is an exploratory run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

STAGES = (("correct", "1-consensus"), ("trim", "2-trim_bases"), ("assemble", "4-fsa"),
          ("polish", "final-polish"), ("bridge", "6-bridge_contigs"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-size", type=int, default=4_600_000)
    ap.add_argument("--coverage", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--work", default="build/assemble_run")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    ap.add_argument("--no-polish", action="store_true", help="leave the polish stage out")
    ap.add_argument("--vol-size", type=int, default=0,
                    help="VOL_SIZE: subject volumes of at most this many bases (0: none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_assemble_run: CUDA is not available", file=sys.stderr)
        return 1
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.io.readstore import ReadStore
    from necat_tpu_torch.pipeline import config as config_mod
    from necat_tpu_torch.pipeline.stages import Project
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
    t0 = time.perf_counter()
    _, store, _ = gen_benchmark_reads(genome_size=args.genome_size,
                                      coverage=args.coverage, seed=args.seed)
    reads = os.path.join(work, "reads.fasta")
    store.to_fasta(reads)
    with open(os.path.join(work, "read_list.txt"), "w") as f:
        f.write(reads + "\n")
    cfg_path = os.path.join(work, "run.cfg")
    with open(cfg_path, "w") as f:
        f.write(config_mod.CONFIG_TEMPLATE.replace(
            "PROJECT=", f"PROJECT={os.path.join(work, 'project')}").replace(
            "ONT_READ_LIST=", f"ONT_READ_LIST={os.path.join(work, 'read_list.txt')}").replace(
            "GENOME_SIZE=", f"GENOME_SIZE={args.genome_size}")
            + (f"\nVOL_SIZE={args.vol_size}\n" if args.vol_size else ""))
    emit("reads", {"reads": store.n_reads, "bases": int(store.total_bases),
                   "setup_s": time.perf_counter() - t0,
                   "device": torch.cuda.get_device_name(0)})
    cfg = config_mod.load_config(cfg_path)
    prj = Project(cfg, cfg.project)
    if args.vol_size:
        emit("volumes", compare_volumes(cfg, args.vol_size))
    bk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()

    def manifest(name: str, sub: str) -> None:
        with open(prj.path(sub, f"{name}.done.json")) as f:
            row = {k: v for k, v in json.load(f).items() if k not in ("input_fp", "params")}
        emit(f"stage {name}", {**row, "since_start_s": time.perf_counter() - t0})

    # the stages `cli.main(["assemble", cfg, "--device", "cuda"])` runs, one
    # at a time so that each manifest is printed when its stage ends
    prj.run_correct(device="cuda")
    manifest(*STAGES[0])
    prj.run_trim(device="cuda")
    manifest(*STAGES[1])
    ctg = prj.run_assemble(device="cuda")
    manifest(*STAGES[2])
    pol = None
    if not args.no_polish:
        pol = prj.run_polish(ctg, "final", device="cuda")
        manifest(*STAGES[3])
    torch.cuda.synchronize()
    draft = ReadStore.from_fasta(ctg)
    polished = ReadStore.from_fasta(pol) if pol else None
    emit("assemble_run", {
        "wall_s": time.perf_counter() - t0,
        "contigs": draft.n_reads, "contig_bases": int(draft.total_bases),
        "contig_n50": draft.n50()[0],
        "polished_bases": int(polished.total_bases) if polished else None,
        "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
        "launches": {f"{k}@{w}": n for (k, w), n in sorted(bk.launches_by_width.items())},
        "k3_by_words": {f"{w}x{n_w}": n for (w, n_w), n in
                        sorted(bk.k3_launches_by_words.items())}})
    bk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    bridged = ReadStore.from_fasta(prj.run_bridge(device="cuda"))
    torch.cuda.synchronize()
    manifest(*STAGES[4])
    emit("bridge_run", {
        "wall_s": time.perf_counter() - t1, "contigs_in": draft.n_reads,
        "n50_in": draft.n50()[0], "contigs_out": bridged.n_reads,
        "n50_out": bridged.n50()[0], "bases_out": int(bridged.total_bases),
        "lengths_out": sorted(int(x) for x in bridged.lengths)[::-1][:20],
        "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
        "launches": {f"{k}@{w}": n for (k, w), n in sorted(bk.launches_by_width.items())},
        "k3_by_words": {f"{w}x{n_w}": n for (w, n_w), n in
                        sorted(bk.k3_launches_by_words.items())}})
    return 0


def compare_volumes(cfg, vol_size: int) -> dict:
    """The correct stage's first candidate search, untiled and in volumes,
    on the card: seconds, index-build seconds, peak memory, equality."""
    import dataclasses

    from necat_tpu_torch.overlap import overlapper
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.pipeline.stages import load_raw_reads
    reads = load_raw_reads(cfg, keep_coverage=cfg.prep_output_coverage)
    mopts = MapOptions.from_string(cfg.get("OVLP_SENSITIVE_OPTIONS", ""))
    row = {"reads": reads.n_reads, "bases": int(reads.total_bases),
           "volumes": reads.volumes(vol_size)}
    found = {}
    for name, search in (
            ("untiled", lambda: overlapper.find_all_candidates(reads, reads, mopts,
                                                               pairwise=True, device="cuda")),
            ("tiled", lambda: overlapper.candidates_by_volumes(reads, mopts, vol_size,
                                                               device="cuda"))):
        overlapper.index_build_s.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        found[name] = search()
        torch.cuda.synchronize()
        row[name] = {"candidates": len(found[name]), "seconds": time.perf_counter() - t0,
                     "index_build_s": list(overlapper.index_build_s),
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    row["equal"] = all(np.array_equal(getattr(found["untiled"], f.name),
                                      getattr(found["tiled"], f.name))
                       for f in dataclasses.fields(found["untiled"]))
    return row


if __name__ == "__main__":
    sys.exit(main())
