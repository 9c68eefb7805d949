"""The benchmark's read generator: a frozen copy of the port's
io/simulate.py (random_genome, mutate, simulate_reads; copied from
necat_tpu_torch/io/simulate.py at commit 6202318), with the parameters of
necat_tpu_torch/utils/benchdata.py:gen_benchmark_reads as defaults.

Reads are ONT-like: lengths drawn from a gamma distribution with mean
12 kb, clipped to 3-40 kb, and 5 % substitutions, 5 % single-base
insertions and 5 % deletions. The same seed gives the same reads.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class ErrorModel:
    sub: float = 0.05
    ins: float = 0.05
    dele: float = 0.05

    @property
    def total(self) -> float:
        return self.sub + self.ins + self.dele


def random_genome(size: int, seed: int = 0, circular: bool = True) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=size, dtype=np.int64).astype(np.uint8)
    return g


def mutate(seq: np.ndarray, em: ErrorModel, rng: np.random.Generator) -> np.ndarray:
    """Apply iid substitution/insertion/deletion errors to an encoded sequence."""
    n = len(seq)
    r = rng.random(n)
    # Deletions: drop bases.
    keep = r >= em.dele
    # Substitutions on survivors.
    sub_mask = (r >= em.dele) & (r < em.dele + em.sub)
    out = seq.copy()
    shift = rng.integers(1, 4, size=n).astype(np.uint8)
    out = np.where(sub_mask, (out + shift) % 4, out)
    out = out[keep]
    # Insertions: after each surviving base, insert with prob ins (single bases).
    m = len(out)
    ins_mask = rng.random(m) < em.ins
    n_ins = int(ins_mask.sum())
    if n_ins:
        ins_bases = rng.integers(0, 4, size=n_ins).astype(np.uint8)
        pos = np.flatnonzero(ins_mask) + 1
        out = np.insert(out, pos, ins_bases)
    return out.astype(np.uint8)


def simulate_reads(
    genome: np.ndarray,
    coverage: float,
    mean_len: int = 12000,
    min_len: int = 3000,
    max_len: int = 40000,
    em: ErrorModel | None = None,
    seed: int = 1,
    circular: bool = True,
) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray, np.ndarray]:
    """Sample noisy reads to the requested coverage.

    Returns (reads, true_start, true_strand, true_len) where true_* describe the
    error-free source interval on the genome (strand 0=fwd, 1=rev).
    """
    if em is None:
        em = ErrorModel()
    rng = np.random.default_rng(seed)
    G = len(genome)
    target = int(G * coverage)
    reads: List[np.ndarray] = []
    starts, strands, lens = [], [], []
    total = 0
    while total < target:
        L = int(np.clip(rng.gamma(shape=3.0, scale=mean_len / 3.0), min_len, max_len))
        if circular:
            s = int(rng.integers(0, G))
            idxs = (s + np.arange(L)) % G
            frag = genome[idxs]
        else:
            if L >= G:
                L = G
                s = 0
            else:
                s = int(rng.integers(0, G - L))
            frag = genome[s:s + L]
        strand = int(rng.integers(0, 2))
        if strand:
            frag = (3 - frag[::-1]).astype(np.uint8)
        noisy = mutate(frag, em, rng)
        reads.append(noisy)
        starts.append(s)
        strands.append(strand)
        lens.append(L)
        total += len(noisy)
    return reads, np.array(starts), np.array(strands), np.array(lens)


# gen_benchmark_reads' read model (necat_tpu_torch/utils/benchdata.py)
BENCH_READS = dict(mean_len=12000, min_len=3000, max_len=40000)
BENCH_ERRORS = dict(sub=0.05, ins=0.05, dele=0.05)


def bench_reads(genome_size: int, coverage: float, seed: int):
    """gen_benchmark_reads without its ReadStore: (genome, reads, (true start,
    strand, length)) from a random genome of `genome_size` from `seed`, reads
    from seed + 1."""
    genome = random_genome(genome_size, seed=seed)
    reads, st, sd, ln = simulate_reads(genome, coverage=coverage, em=ErrorModel(**BENCH_ERRORS),
                                       seed=seed + 1, **BENCH_READS)
    return genome, reads, (st, sd, ln)
