#!/usr/bin/env python
"""necat_tpu's own bridge_contigs on the CPU: the reference for
chip_smoke.py's JAX_CPU_BRIDGE_REFERENCE and JAX_CPU_BRIDGE_DIGEST.

    JAX_PLATFORMS=cpu python scripts/jax_bridge_reference.py [--work DIR]

The contigs are chip_smoke.bridge_bench_contigs of the bench genome
(gen_benchmark_reads(200_000, 20, seed=7): five pieces in a shuffled id
order, three gaps and one overlap) and the reads are the bench read set's
339 raw reads, as in chip_smoke.py's phase 11b; bridge_contigs runs with its
default options (on the CPU the JAX package takes its adaptive band).
Prints one JSON line: the wall, the pairs extend_candidates ran at each band
width (the mapping and its ladder, the contig-to-contig extension), the
bridged contigs' count and lengths,
their identity to the true genome as chip_smoke.contig_identity measures it,
and chip_smoke.fasta_digest and fasta_record_digests of the bridged contigs
written as FASTA (DIR/bridged_contigs.fasta), which phase 21 holds the port's
adaptive band to. The run takes 130-160 s on an 8-core CPU.
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
    ap.add_argument("--work", default="build/jax_bridge_reference")
    args = ap.parse_args()
    import collections

    import chip_smoke
    from necat_tpu.bridge.bridge import bridge_contigs
    from necat_tpu.overlap import overlapper
    from necat_tpu.io.readstore import ReadStore
    from necat_tpu.utils.benchdata import gen_benchmark_reads
    genome, store, _ = gen_benchmark_reads(genome_size=200_000, coverage=20, seed=7)
    seqs, names = chip_smoke.bridge_bench_contigs(genome)
    pairs_by_band = collections.Counter()
    extend = overlapper._extend_subset

    def counted(cands, engine, idx, W, *a, **k):
        pairs_by_band[W] += len(idx)
        return extend(cands, engine, idx, W, *a, **k)
    overlapper._extend_subset = counted
    t0 = time.perf_counter()
    out = bridge_contigs(ReadStore.from_seqs(seqs, names), store)
    wall = time.perf_counter() - t0
    ident, placed, total = chip_smoke.contig_identity(out, genome)
    os.makedirs(args.work, exist_ok=True)
    fasta = os.path.join(args.work, "bridged_contigs.fasta")
    out.to_fasta(fasta)
    print(json.dumps({"wall_s": wall, "contigs": out.n_reads,
                      "lengths": [int(x) for x in out.lengths],
                      "total": int(out.total_bases), "identity": ident,
                      "placed_bases": [placed, total],
                      "pairs_by_band": dict(sorted(pairs_by_band.items())),
                      "digest": chip_smoke.fasta_digest(fasta),
                      "record_digests": chip_smoke.fasta_record_digests(fasta)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
