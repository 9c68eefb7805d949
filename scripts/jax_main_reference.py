#!/usr/bin/env python
"""necat_tpu's own main path on the CPU, as that package runs by default:
the reference for chip_smoke.py's JAX_CPU_MAIN_REFERENCE.

    JAX_PLATFORMS=cpu python scripts/jax_main_reference.py [--dump records.npz]

The reads are the bench read set (gen_benchmark_reads(200_000, 20, seed=7):
339 reads, 4.02 Mb); find_all_candidates -> swap_roles -> correct_reads run
with default options and no monkeypatch, so that on the CPU the JAX
extension takes its adaptive band (necat_tpu/align/banded.py:_use_pallas).
Prints one JSON line: the wall, the corrected count, the identity sample of
chip_smoke.accuracy_sample (bench.py's), chip_smoke.records_digest over
(tid, left, right, corrected, seq) of every record and of every record but
chip_smoke.MAIN_TIE_FLIPS', and those records' left, right and length;
--dump writes the records themselves (chip_smoke.dump_records).
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--dump", default=None)
    args = ap.parse_args()
    import chip_smoke
    from necat_tpu.consensus.correct import correct_reads
    from necat_tpu.consensus.options import CnsOptions
    from necat_tpu.overlap.candidates import Candidates
    from necat_tpu.overlap.options import MapOptions
    from necat_tpu.overlap.overlapper import find_all_candidates
    from necat_tpu.utils.benchdata import gen_benchmark_reads
    genome, store, (st, sd, ln) = gen_benchmark_reads(genome_size=200_000, coverage=20,
                                                      seed=7)
    t0 = time.perf_counter()
    cands = find_all_candidates(store, store, MapOptions(), pairwise=True)
    call = Candidates.concat([cands, cands.swap_roles()])
    t1 = time.perf_counter()
    recs = correct_reads(store, call, CnsOptions())
    t2 = time.perf_counter()
    print(json.dumps({
        "candidates": len(cands), "records": len(recs),
        "corrected_reads": len({r.tid for r in recs if r.corrected}),
        "identity": chip_smoke.accuracy_sample(recs, store.lengths, genome, st, sd, ln),
        "digest": chip_smoke.records_digest(recs),
        "digest_without_tie_flips": chip_smoke.records_digest(
            recs, skip=chip_smoke.MAIN_TIE_FLIPS),
        "tie_flips": {str(r.tid): [r.left, r.right, len(r.seq)] for r in recs
                      if r.tid in chip_smoke.MAIN_TIE_FLIPS},
        "candidates_s": t1 - t0, "correct_s": t2 - t1}))
    if args.dump:
        chip_smoke.dump_records(recs, args.dump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
