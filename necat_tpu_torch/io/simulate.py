"""Synthetic genome / noisy-long-read generation for tests and benchmarks
(the port's copy of necat_tpu/io/simulate.py: both packages give the same
reads from the same seed).

The reference's test-data maker splits long reads into overlapping mutated chunks
(oc2slr, src/split_long_reads/main.c:12-30). This module generalizes that: a random
genome plus reads sampled with an ONT-style error model (substitutions + short indels),
so every stage has ground truth to score against (SURVEY.md §4 test strategy).
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


def identity_to_genome(read: np.ndarray, genome: np.ndarray, start: int, strand: int,
                       true_len: int, circular: bool = True) -> float:
    """Alignment identity (percent) of a read against its true source interval.

    Uses a plain O(n*band) banded edit distance on the host — test oracle only.
    """
    G = len(genome)
    if circular:
        idxs = (start + np.arange(true_len)) % G
        ref = genome[idxs]
    else:
        ref = genome[start:start + true_len]
    if strand:
        ref = (3 - ref[::-1]).astype(np.uint8)
    d = banded_edit_distance(read, ref, band=max(64, int(0.35 * max(len(read), len(ref)))))
    return 100.0 * (1.0 - d / max(len(read), len(ref)))


def banded_edit_distance(a: np.ndarray, b: np.ndarray, band: int,
                         b_suffix_free: bool = False,
                         b_prefix_free: bool = False) -> int:
    """Reference banded Levenshtein distance (NumPy, row-wise), for oracles.

    b_suffix_free=True returns min over the last row (an unconsumed suffix of b
    is free); b_prefix_free=True makes row 0 all zeros (alignment may start
    anywhere in b). Use both when b is a reference window containing a's true
    source somewhere inside."""
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        if n == 0:
            return 0 if (b_suffix_free or b_prefix_free) else m
        return n
    INF = 10 ** 9
    # dp over rows of a; band around scaled diagonal
    prev = np.full(m + 1, INF, dtype=np.int64)
    width = band
    if b_prefix_free:
        prev[:] = 0
    else:
        lo_prev, hi_prev = 0, min(m, width) + 1
        prev[lo_prev:hi_prev] = np.arange(lo_prev, hi_prev)
    for i in range(1, n + 1):
        center = int(round(i * m / n))
        lo = max(0, center - width)
        hi = min(m, center + width) + 1
        cur = np.full(m + 1, INF, dtype=np.int64)
        seg = np.arange(lo, hi)
        # from top (deletion in b / consume a only)
        cur[lo:hi] = prev[lo:hi] + 1
        # diagonal
        dlo = max(lo, 1)
        sub = (b[dlo - 1:hi - 1] != a[i - 1]).astype(np.int64)
        np.minimum(cur[dlo:hi], prev[dlo - 1:hi - 1] + sub, out=cur[dlo:hi])
        # left (insertion) — running min
        run = cur[lo:hi] - seg
        np.minimum.accumulate(run, out=run)
        cur[lo:hi] = run + seg
        prev = cur
    if b_suffix_free:
        return int(prev.min())
    return int(prev[m])
