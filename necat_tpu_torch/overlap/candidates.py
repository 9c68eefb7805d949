"""Candidate detection: query k-mer sampling -> index hits -> (query, subject)
pair grouping -> batched chain DP -> gapped candidates.

Counterpart of necat_tpu/overlap/candidates.py on one device. The hit, pair
and chain buffers are sized from the exact counts (one sync each) instead of
the JAX package's static caps; the caps' ceilings still bound them, so a
pass that would saturate a ceiling drops what the JAX package drops.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from necat_tpu_torch.index.kmer_index import KmerIndex, query_kmer_hashes
from necat_tpu_torch.overlap.chain import chain_pairs
from necat_tpu_torch.overlap.options import MapOptions

MAX_PAIRS_CEILING = 1 << 18   # the JAX package's escalation ceilings
MAX_CHAIN_CEILING = 1 << 17


@dataclasses.dataclass
class Candidates:
    """SoA of gapped candidates (host). Mirrors GappedCandidate
    (gapped_candidate.h:9-19): the subject strand is always forward."""

    qid: np.ndarray      # int32 global query read id
    sid: np.ndarray      # int32 global subject read id
    qdir: np.ndarray     # int8, 0=FWD 1=REV (query strand)
    score: np.ndarray    # int32 chain score
    qbeg: np.ndarray     # int32 (coords on the qdir strand of the query)
    qend: np.ndarray
    sbeg: np.ndarray     # int32 (forward subject coords)
    send: np.ndarray
    qsize: np.ndarray    # int32
    ssize: np.ndarray    # int32

    def __len__(self) -> int:
        return len(self.qid)

    @staticmethod
    def concat(parts: list["Candidates"]) -> "Candidates":
        parts = [p for p in parts if len(p)]
        if not parts:
            z = np.zeros(0, np.int32)
            return Candidates(z, z, z.astype(np.int8), z, z, z, z, z, z, z)
        return Candidates(*[np.concatenate([getattr(p, f.name) for p in parts])
                            for f in dataclasses.fields(Candidates)])

    def take(self, idx: np.ndarray) -> "Candidates":
        return Candidates(*[getattr(self, f.name)[idx]
                            for f in dataclasses.fields(Candidates)])

    def swap_roles(self) -> "Candidates":
        """Swap query/subject roles, keeping the subject strand forward
        (change_pcan_roles + normalise_pcan_sdir, gapped_candidate.h:102-105):
        a REV record flips both strands, so its coordinates mirror."""
        rev = self.qdir == 1
        return Candidates(
            qid=self.sid.copy(), sid=self.qid.copy(), qdir=self.qdir.copy(),
            score=self.score.copy(),
            qbeg=np.where(rev, self.ssize - self.send, self.sbeg).astype(np.int32),
            qend=np.where(rev, self.ssize - self.sbeg, self.send).astype(np.int32),
            sbeg=np.where(rev, self.qsize - self.qend, self.qbeg).astype(np.int32),
            send=np.where(rev, self.qsize - self.qbeg, self.qend).astype(np.int32),
            qsize=self.ssize.copy(), ssize=self.qsize.copy())


def expand_hits(start, count, positions, soff_limit, max_hits: int):
    """Expand CSR (start, count) ranges i32[B, S] into a flat hit list:
    (qrow, kcol, pos, valid), in (row, sampled k-mer, index order). At most
    max_hits hits are kept, as in the JAX package's buffer; hits at subject
    positions >= soff_limit[row] are invalid."""
    B, S = start.shape
    flat_count = count.reshape(-1).long()
    total = min(int(flat_count.sum()), max_hits)
    kmer_idx = torch.repeat_interleave(
        torch.arange(B * S, device=start.device), flat_count)[:total]
    cum_prev = torch.cumsum(flat_count, 0) - flat_count
    within = torch.arange(total, device=start.device) - cum_prev[kmer_idx]
    pos = positions[start.reshape(-1).long()[kmer_idx] + within]
    qrow = torch.div(kmer_idx, S, rounding_mode="floor")
    kcol = kmer_idx - qrow * S
    return qrow, kcol, pos, pos < soff_limit[qrow]


def group_pairs(qrow, qoff, pos, valid, sub_offsets, *, max_seeds: int,
                min_hits: int):
    """Sort valid hits by (qrow, pos, qoff), segment them into (query, subject)
    pairs, keep pairs with >= min_hits hits (fewer can never pass the seed
    filter after chaining) and gather up to max_seeds seeds per kept pair
    (even subsampling beyond, order kept)."""
    dev = qrow.device
    q, p, o = qrow[valid], pos[valid].long(), qoff[valid].long()
    # lexicographic sort: stable passes from the last key to the first
    order = torch.argsort(o, stable=True)
    order = order[torch.argsort((q[order].long() << 32) | p[order], stable=True)]
    k1, k2, k3 = q[order], p[order], o[order]
    H = k1.shape[0]
    sid = torch.searchsorted(sub_offsets, k2, right=True) - 1
    new_pair = torch.ones(H, dtype=torch.bool, device=dev)
    new_pair[1:] = (k1[1:] != k1[:-1]) | (sid[1:] != sid[:-1])
    pair_start = torch.nonzero(new_pair)[:, 0][:MAX_PAIRS_CEILING]
    # past the ceiling the last kept pair runs to the end, as in the JAX package
    pair_end = torch.cat([pair_start[1:], pair_start.new_tensor([H])])[:len(pair_start)]
    pair_cnt = pair_end - pair_start
    kidx = torch.nonzero(pair_cnt >= min_hits)[:, 0][:MAX_CHAIN_CEILING]
    c_start, c_cnt = pair_start[kidx], pair_cnt[kidx]
    pair_sid = sid[c_start]
    ar = torch.arange(max_seeds, device=dev)[None, :]
    idx_in = torch.where(c_cnt[:, None] > max_seeds,
                         torch.div(ar * c_cnt[:, None], max_seeds, rounding_mode="floor"),
                         ar)
    gidx = (c_start[:, None] + idx_in).clamp(max=max(H - 1, 0))
    seed_mask = ar < c_cnt.clamp(max=max_seeds)[:, None]
    return dict(pair_qrow=k1[c_start], pair_sid=pair_sid,
                seed_q=k3[gidx].to(torch.int32),
                seed_s=(k2[gidx] - sub_offsets[pair_sid][:, None]).to(torch.int32),
                seed_mask=seed_mask)


def candidates_forward(index: KmerIndex, sub_offsets, batch, lens, soff_limit,
                       opts: MapOptions) -> torch.Tensor:
    """One candidate pass (hashing -> lookup -> hit expansion -> pair grouping
    -> chain DP) over a padded query batch u8[B, L]. Returns stats
    int32[9, P] = pair_qrow, pair_sid, pair_valid, n_seeds, score, qbeg,
    qend, sbeg, send."""
    qh, qoffs, kvalid = query_kmer_hashes(batch, lens, index.k, opts.scan_window)
    start, count = index.lookup_ranges(qh)
    count = torch.where(kvalid, count, 0)
    qrow, kcol, pos, valid = expand_hits(start, count, index.sorted_positions,
                                         soff_limit, opts.max_hits_ceiling)
    g = group_pairs(qrow, qoffs[kcol], pos, valid, sub_offsets,
                    max_seeds=opts.max_seeds_per_pair,
                    min_hits=max(opts.block_score_cutoff, 1))
    mask = g["seed_mask"]
    chains = []
    for _ in range(opts.n_chains_per_pair):
        if chains:
            # secondary chains (one candidate per scoring block,
            # word_finder.c:183-359): re-chain with the previous chain's
            # subject span masked out
            prev = chains[-1]
            mask = mask & ~((g["seed_s"] >= prev["sbeg"][:, None])
                            & (g["seed_s"] < prev["send"][:, None]))
        chains.append(chain_pairs(g["seed_q"], g["seed_s"], mask, opts.kmer_size,
                                  opts.chain_max_dist, opts.chain_bw))
    n = len(chains)
    cat = lambda key: torch.cat([c[key] for c in chains])
    pv = torch.ones(n * g["pair_qrow"].shape[0], dtype=torch.int32,
                    device=batch.device)
    return torch.stack([g["pair_qrow"].repeat(n).to(torch.int32),
                        g["pair_sid"].repeat(n).to(torch.int32), pv,
                        cat("n_seeds"), cat("score"), cat("qbeg"), cat("qend"),
                        cat("sbeg"), cat("send")]).to(torch.int32)


def stats_to_candidates(st: np.ndarray, qids, lens, qdir, sub_sizes,
                        sub_vol_read_start: int, opts: MapOptions):
    """Host filter/pack of one candidate pass's stats [9, P]: the
    candidates, and the stats column each came from."""
    pv = st[2].astype(bool)
    n_seeds, score = st[3], st[4]
    qbeg, qend, sbeg, send = st[5], st[6], st[7], st[8]
    keep = (pv & (n_seeds >= opts.block_score_cutoff)
            & (score >= opts.chain_min_score)
            & (((qend - qbeg) >= opts.align_size_cutoff)
               | ((send - sbeg) >= opts.align_size_cutoff)))
    idx = np.flatnonzero(keep)
    pq, psid = st[0][idx], st[1][idx]
    return idx, Candidates(
        qid=qids[pq].astype(np.int32),
        sid=(psid + sub_vol_read_start).astype(np.int32),
        qdir=np.full(len(idx), qdir, dtype=np.int8),
        score=score[idx].astype(np.int32),
        qbeg=qbeg[idx].astype(np.int32), qend=qend[idx].astype(np.int32),
        sbeg=sbeg[idx].astype(np.int32), send=send[idx].astype(np.int32),
        qsize=lens[pq].astype(np.int32),
        ssize=sub_sizes[psid].astype(np.int32))


def top_n_per_query(cands: Candidates, n: int) -> Candidates:
    """Keep the n best-scoring candidates per qid (pm_worker.c:163-186 ncan),
    in their original order."""
    if len(cands) == 0:
        return cands
    order = np.lexsort((-cands.score, cands.qid))
    qid_sorted = cands.qid[order]
    new_grp = np.r_[True, qid_sorted[1:] != qid_sorted[:-1]]
    grp_first = np.flatnonzero(new_grp)
    rank = np.arange(len(order)) - grp_first[np.cumsum(new_grp) - 1]
    return cands.take(np.sort(order[rank < n]))
