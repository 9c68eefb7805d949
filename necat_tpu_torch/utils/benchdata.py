"""The bench read set (the port's copy of necat_tpu/utils/benchdata.py: the
same reads from the same seed as bench.py and necat_tpu's runs)."""

from __future__ import annotations

import os

from necat_tpu_torch.io import simulate
from necat_tpu_torch.io.readstore import ReadStore


def gen_benchmark_reads(genome_size: int = 500_000, coverage: float = 30.0,
                        seed: int = 1234):
    """ONT-like raw reads from a random genome (the E. coli 40X stand-in,
    scaled). Returns (genome, ReadStore, (true start, strand, length))."""
    genome = simulate.random_genome(genome_size, seed=seed)
    em = simulate.ErrorModel(sub=0.05, ins=0.05, dele=0.05)
    reads, st, sd, ln = simulate.simulate_reads(
        genome, coverage=coverage, mean_len=12000, min_len=3000, max_len=40000,
        em=em, seed=seed + 1)
    return genome, ReadStore.from_seqs(reads), (st, sd, ln)


def write_benchmark_fasta(path: str | os.PathLike, genome_size: int = 500_000,
                          coverage: float = 30.0, seed: int = 1234) -> int:
    """Write gen_benchmark_reads' reads to a FASTA file (gzip if the path ends
    in .gz); returns the number of reads."""
    _, store, _ = gen_benchmark_reads(genome_size, coverage, seed)
    store.to_fasta(path)
    return store.n_reads
