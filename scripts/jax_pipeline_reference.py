#!/usr/bin/env python
"""necat_tpu's own `cli assemble` and then `cli bridge` of the bench read set
on the CPU, as file digests: the reference for chip_smoke.py's
JAX_CPU_PIPELINE_REFERENCE and JAX_CPU_LADDER_REFERENCE.

    JAX_PLATFORMS=cpu python scripts/jax_pipeline_reference.py [--work DIR] [--out FILE]
        [--ladder-only] [--cns-final FILE]

The reads (gen_benchmark_reads(200_000, 20, seed=7)) and the config (the
template, MIN_READ_LENGTH=1000, NUM_ITER=2, POLISH_CONTIGS=true) are those of
chip_smoke.py's phases 8 and 21. No band is forced, so on the CPU the JAX
package takes its adaptive band. First a "ladder" line: m4_digest and
records_digest of extend_candidates and correct_reads(rescue_long_indels)
of chip_smoke.planted_pairs (phase 21's ladder; --ladder-only stops there).
Then one JSON line: chip_smoke.fasta_digest (sha256 over the decompressed
content, record count) of each stage file of chip_smoke.pipeline_paths,
with the digest of the rest of the file where chip_smoke.PIPELINE_TIES
names records; each stage's seconds from its manifest; contig count, N50
and the identity of the draft and the polished contigs (contig_identity).
--out writes every file's chip_smoke.fasta_record_digests, to place a
difference. --cns-final FILE puts another run's cns_final in the project
and runs the later stages on it (the correct stage does not run): the JAX
stages on the port's own input. Resumable: a rerun skips the stages whose
manifests are current, and once both commands have run it reads the files
only.

The run took 79 min on an 8-core CPU shared with other runs: correct 2515
s, trim 787 s, assemble 923 s, polish 287 s, the bridge command's polish
226 s (the stages' log); the ladder ~125 s.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def ladder_reference(chip_smoke) -> dict:
    """extend_candidates and correct_reads(rescue_long_indels=True) of
    chip_smoke.planted_pairs in the JAX package (its adaptive band on the
    CPU): chip_smoke.m4_digest and records_digest of the two outputs."""
    import dataclasses

    from necat_tpu.consensus.correct import correct_reads
    from necat_tpu.consensus.options import CnsOptions
    from necat_tpu.io.readstore import ReadStore
    from necat_tpu.overlap.candidates import Candidates
    from necat_tpu.overlap.overlapper import extend_candidates
    store_t, cands_t = chip_smoke.planted_pairs()
    store = ReadStore.from_seqs([store_t.get(i) for i in range(store_t.n_reads)])
    cands = Candidates(**{f.name: getattr(cands_t, f.name)
                          for f in dataclasses.fields(cands_t)})
    t0 = time.perf_counter()
    m4 = extend_candidates(cands, store, store)
    recs = correct_reads(store, Candidates.concat([cands, cands.swap_roles()]),
                         CnsOptions(rescue_long_indels=True))
    return {"wall_s": time.perf_counter() - t0, "m4": chip_smoke.m4_digest(m4),
            "m4_rows": len(m4), "records": chip_smoke.records_digest(recs),
            "corrected": sum(r.corrected for r in recs)}


def reference_digest(chip_smoke, key: str, path: str) -> dict:
    """chip_smoke.fasta_digest of a stage file and, where
    chip_smoke.PIPELINE_TIES names records of it, the digest of the rest."""
    out = chip_smoke.fasta_digest(path)
    ties = chip_smoke.PIPELINE_TIES.get(key)
    if ties:
        out["sha256_without_ties"] = chip_smoke.fasta_digest(
            path, skip={t.split()[0] for t in ties.values()})["sha256"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default="build/jax_pipeline_reference")
    ap.add_argument("--out", default=None, help="JSON file of per-record digests")
    ap.add_argument("--ladder-only", action="store_true",
                    help="print the planted pairs' line alone")
    ap.add_argument("--cns-final", default=None,
                    help="a cns_final.fasta.gz that stands in for the correct stage's "
                         "output (another run's), so that trim and the later stages run "
                         "on it")
    args = ap.parse_args()
    import chip_smoke
    print("ladder " + json.dumps(ladder_reference(chip_smoke)), flush=True)
    if args.ladder_only:
        return 0
    from necat_tpu.io.readstore import ReadStore
    from necat_tpu.pipeline import cli, config as config_mod
    work = os.path.abspath(args.work)
    prj = os.path.join(work, "project")
    cfg_path, genome, _ = chip_smoke.bench_project(work, config_mod.CONFIG_TEMPLATE,
                                                   fresh=False)
    paths, walls, _ = chip_smoke.run_pipeline(
        cli, cfg_path, prj, os.path.join(work, "polished_contigs.assemble.fasta"),
        cns_final=args.cns_final)
    draft = ReadStore.from_fasta(paths["contigs"])
    polished = ReadStore.from_fasta(paths["polished_assemble"])
    print(json.dumps({
        "walls_s": walls, "stages_s": chip_smoke.stage_seconds(prj),
        "files": {k: reference_digest(chip_smoke, k, p) for k, p in paths.items()},
        "contigs": draft.n_reads, "contig_n50": draft.n50()[0],
        "draft_identity": chip_smoke.contig_identity(draft, genome)[0],
        "polished_identity": chip_smoke.contig_identity(polished, genome)[0]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({k: chip_smoke.fasta_record_digests(p) for k, p in paths.items()}, f,
                      indent=0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
