"""Batched seed chaining DP (counterpart of necat_tpu/overlap/chain.py).

All seeds of each (query, subject) pair are chained at once, vectorised over
pairs. Scoring matches chain_dp.c:57-87 (minimap2-style):
sc = min(min(dq, dr), k) - floor(0.01*k*dd) - ilog2(dd)/2, gated by dq, dr in
(0, max_dist] and |dq - dr| <= bw.
"""

from __future__ import annotations

import torch

NEG = -(1 << 28)
CHAIN_SLICE = 8192   # pairs per slice: the DP builds [P, S, S] transition tensors


def chain_pairs(qoff, soff, seed_mask, kmer_size: int, max_dist: int = 5000,
                bw: int = 500) -> dict:
    """qoff/soff int32[P, S] seeds sorted by (soff, qoff) within each pair,
    seed_mask bool[P, S]. Returns the best chain per pair: score, n_seeds,
    qbeg, qend, sbeg, send (int32[P])."""
    P = qoff.shape[0]
    parts = [_chain_slice(qoff[s:s + CHAIN_SLICE], soff[s:s + CHAIN_SLICE],
                          seed_mask[s:s + CHAIN_SLICE], kmer_size, max_dist, bw)
             for s in range(0, max(P, 1), CHAIN_SLICE)]
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of int32 x >= 1 by a bit scan: integer ops only, so
    exact on every device (the card's float64 log2 of a power of two may
    fall below the integer, which floor then takes one too low)."""
    r = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        m = x >= (1 << s)
        r = r + m.to(x.dtype) * s
        x = torch.where(m, x >> s, x)
    return r


def _chain_slice(q, s, seed_mask, kmer_size, max_dist, bw):
    P, S = q.shape
    dev = q.device
    i32 = torch.int32
    q = q.to(i32)
    s = s.to(i32)
    # transition scores M[p, i, j] for j -> i (j strictly before i)
    dq = q[:, :, None] - q[:, None, :]
    dr = s[:, :, None] - s[:, None, :]
    dd = (dr - dq).abs()
    ok = (dq > 0) & (dr > 0) & (dq <= max_dist) & (dr <= max_dist) & (dd <= bw)
    ok &= seed_mask[:, :, None] & seed_mask[:, None, :]
    ok &= torch.ones((S, S), dtype=torch.bool, device=dev).tril(-1)[None]
    log_dd = floor_log2(dd.clamp(min=1))
    sc = (torch.minimum(torch.minimum(dq, dr), torch.tensor(kmer_size, dtype=i32, device=dev))
          - (dd.to(torch.float32) * (0.01 * kmer_size)).to(i32) - (log_dd >> 1))
    M = torch.where(ok, sc, NEG)
    del dq, dr, dd, ok, sc, log_dd

    f = torch.full((P, S), NEG, dtype=i32, device=dev)
    parent = torch.empty((P, S), dtype=torch.int64, device=dev)
    for i in range(S):
        cand = f + M[:, i, :]
        best_v, best_j = cand.max(dim=1)      # first maximum, as jnp.argmax
        fi = best_v.clamp(min=kmer_size)
        parent[:, i] = torch.where(best_v >= kmer_size, best_j, -1)
        f[:, i] = torch.where(seed_mask[:, i], fi, NEG)

    score, end = f.max(dim=1)
    # walk the parents from the chain end to its start
    cur = end.clone()
    beg = end.clone()
    n_seeds = torch.ones(P, dtype=i32, device=dev)
    for _ in range(S):
        nxt = parent.gather(1, cur[:, None])[:, 0]
        has = nxt >= 0
        beg = torch.where(has, nxt, beg)
        cur = torch.where(has, nxt, cur)
        n_seeds += has.to(i32)
    take = lambda a, idx: a.gather(1, idx[:, None])[:, 0]
    return {"score": score, "n_seeds": n_seeds,
            "qbeg": take(q, beg), "sbeg": take(s, beg),
            "qend": take(q, end) + kmer_size, "send": take(s, end) + kmer_size}

