"""The reference's overlap-candidate search, in plain torch and NumPy.

Written from the semantics of the JAX package's candidate search
(necat_tpu/index/kmer_index.py, overlap/candidates.py, overlap/chain.py,
overlap/overlapper.py, after NECAT's word_finder and chain_dp), one pair at
a time and with none of its batching:

  * every position of every read is indexed by its k-mer (base-4,
    big-endian), k-mers across a read end excluded; a k-mer found more than
    occ_cutoff times in the whole set gives no hits;
  * a query samples the k-mers at 0, z, 2z, ... of itself on each strand
    (strand 1 = the reverse complement);
  * pairwise: a query meets only the reads before it (sid < qid), so each
    pair is found once, by its later read;
  * a pair's hits, sorted by (subject position, query offset), with at
    least block_score_cutoff of them, are chained over at most 64 seeds
    (seed i of n > 64 is hit (i * n) // 64); the best chain is the
    candidate if it has >= block_score_cutoff seeds, a score >=
    chain_min_score and spans align_size_cutoff on either read;
  * a query keeps its ncan best candidates by score.

A row is a dict of CAND_FIELDS (qid, sid, qdir, score, qbeg, qend, sbeg,
send, qsize, ssize), query coordinates on the query's strand.
"""

from __future__ import annotations

import numpy as np
import torch

CAND_FIELDS = ("qid", "sid", "qdir", "score", "qbeg", "qend", "sbeg", "send", "qsize", "ssize")
NEG = -(1 << 28)
MAX_SEEDS = 64
# chain_dp.c:161-181
CHAIN_MAX_DIST, CHAIN_BW, CHAIN_MIN_SCORE = 5000, 500, 30


def parse_map_options(s: str) -> dict:
    """NECAT's pairwise-mapping options (map_options.c defaults) with the
    flags of an option string over them: -k, -z, -q, -s, -n, -a."""
    o = {"k": 15, "z": 10, "q": 500, "s": 3, "n": 500, "a": 500}
    toks = s.split()
    for i in range(0, len(toks) - 1):
        if toks[i].startswith("-") and len(toks[i]) == 2 and toks[i][1] in o:
            o[toks[i][1]] = int(toks[i + 1])
    return o


class Volume:
    """The read set on a device with its k-mer index: the hashes of every
    position (forward and reverse complement), and the forward hashes of
    the valid positions sorted, for occurrence counts and positions."""

    def __init__(self, reads: list, k: int, device):
        self.k = k
        self.device = torch.device(device)
        self.lens = np.array([len(r) for r in reads], np.int64)
        self.offsets = np.zeros(len(reads) + 1, np.int64)
        np.cumsum(self.lens, out=self.offsets[1:])
        self.host = np.concatenate(reads).astype(np.uint8)
        x = torch.from_numpy(self.host).to(self.device).long()
        n = len(self.host) - k + 1
        fwd = torch.zeros(n, dtype=torch.int64, device=self.device)
        rc = torch.zeros(n, dtype=torch.int64, device=self.device)
        for j in range(k):
            fwd = (fwd << 2) | x[j:j + n]
            rc = rc | ((3 - x[j:j + n]) << (2 * j))
        del x
        self.fwd, self.rc = fwd, rc
        off = torch.from_numpy(self.offsets).to(self.device)
        pos = torch.arange(n, device=self.device)
        self.read_of = torch.searchsorted(off, pos, right=True) - 1
        end = off[self.read_of + 1]
        self.valid = pos + k <= end
        # each position's offset in its read on strand 0 and, as the start
        # of a reverse-complement k-mer, on strand 1
        self.qoff = (pos - off[self.read_of], end - k - pos)
        del end
        vpos = pos[self.valid]
        self.sorted_hash, order = torch.sort(fwd[self.valid], stable=True)
        self.sorted_pos = vpos[order]
        self.off_t = off

    def count(self, h: torch.Tensor):
        """(first index in the sorted hashes, occurrences) of each hash."""
        lo = torch.searchsorted(self.sorted_hash, h)
        hi = torch.searchsorted(self.sorted_hash, h, right=True)
        return lo, hi - lo

    def sampled(self, rid: int, z: int, strand: int):
        """(query offsets, hashes) of read rid's sampled k-mers on a strand."""
        L, o = int(self.lens[rid]), int(self.offsets[rid])
        s = torch.arange(0, max(L - self.k + 1, 0), z, device=self.device)
        h = self.fwd[o + s] if strand == 0 else self.rc[o + L - self.k - s]
        return s, h


def _chain(q: np.ndarray, s: np.ndarray, k: int):
    """Best chain of seeds (q, s), sorted by (s, q): (score, n_seeds, qbeg,
    qend, sbeg, send). Transition j -> i (j < i): min(min(dq, dr), k) -
    trunc(0.01 k dd) - floor(log2 dd) / 2 for 0 < dq, dr <= max_dist and
    dd = |dr - dq| <= bw; f_i = max(k, best), ties to the first j; the best
    end is the first maximum of f."""
    S = len(q)
    q = q.astype(np.int64)
    s = s.astype(np.int64)
    dq = q[:, None] - q[None, :]
    dr = s[:, None] - s[None, :]
    dd = np.abs(dr - dq)
    ok = ((dq > 0) & (dr > 0) & (dq <= CHAIN_MAX_DIST) & (dr <= CHAIN_MAX_DIST)
          & (dd <= CHAIN_BW) & np.tri(S, S, -1, dtype=bool))
    log_dd = np.zeros_like(dd)
    pos = dd > 0
    log_dd[pos] = np.floor(np.log2(dd[pos].astype(np.float64))).astype(np.int64)
    pen = (dd.astype(np.float32) * np.float32(0.01 * k)).astype(np.int64)
    M = np.where(ok, np.minimum(np.minimum(dq, dr), k) - pen - (log_dd >> 1), NEG)
    f = np.full(S, NEG, np.int64)
    parent = np.full(S, -1, np.int64)
    for i in range(S):
        cand = f + M[i]
        j = int(np.argmax(cand))
        best = int(cand[j])
        f[i] = max(k, best)
        parent[i] = j if best >= k else -1
    end = int(np.argmax(f))
    n, beg = 1, end
    while parent[beg] >= 0:
        beg = int(parent[beg])
        n += 1
    return int(f[end]), n, int(q[beg]), int(q[end]) + k, int(s[beg]), int(s[end]) + k


def _pair_rows(hits: dict, vol: Volume, o: dict) -> list:
    """Candidate rows of grouped hits {(qid, qdir, sid): (qoffs, spos)}."""
    rows = []
    for (qid, qdir, sid), (qo, sp) in hits.items():
        n = len(qo)
        if n < max(o["s"], 1):
            continue
        order = np.lexsort((qo, sp))
        qo, sp = qo[order], sp[order]
        if n > MAX_SEEDS:
            idx = (np.arange(MAX_SEEDS) * n) // MAX_SEEDS
            qo, sp = qo[idx], sp[idx]
        score, ns, qb, qe, sb, se = _chain(qo, sp, o["k"])
        if (ns >= o["s"] and score >= CHAIN_MIN_SCORE
                and (qe - qb >= o["a"] or se - sb >= o["a"])):
            rows.append(dict(qid=qid, sid=sid, qdir=qdir, score=score, qbeg=qb, qend=qe,
                             sbeg=sb, send=se, qsize=int(vol.lens[qid]),
                             ssize=int(vol.lens[sid])))
    return rows


def _group(keys: np.ndarray, qo: np.ndarray, sp: np.ndarray) -> dict:
    """{key tuple: (query offsets, subject positions)} of hits keyed [n, 3]."""
    out = {}
    if not len(keys):
        return out
    order = np.lexsort(keys.T[::-1])
    keys, qo, sp = keys[order], qo[order], sp[order]
    cut = np.flatnonzero(np.any(keys[1:] != keys[:-1], axis=1)) + 1
    for a, b in zip(np.r_[0, cut], np.r_[cut, len(keys)]):
        out[tuple(int(x) for x in keys[a])] = (qo[a:b], sp[a:b])
    return out


def top_n(rows: list, n: int) -> list:
    """A query's n best rows by score; ties in the order the search finds
    them (strand 0 first, then by subject)."""
    rows = sorted(rows, key=lambda r: (-r["score"], r["qdir"], r["sid"]))
    return rows[:n]


def query_rows(vol: Volume, qid: int, o: dict, strands=(0, 1)) -> list:
    """Every candidate row of query qid against the reads before it."""
    keys, qos, sps = [], [], []
    limit = int(vol.offsets[qid])
    for d in strands:
        s, h = vol.sampled(qid, o["z"], d)
        lo, cnt = vol.count(h)
        use = (cnt > 0) & (cnt <= o["q"])
        lo, cnt, s = lo[use], cnt[use], s[use]
        rep = torch.repeat_interleave(torch.arange(len(cnt), device=vol.device), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        idx = lo[rep] + (torch.arange(len(rep), device=vol.device) - first[rep])
        p = vol.sorted_pos[idx]
        keep = p < limit
        p, qo = p[keep], s[rep][keep]
        sid = vol.read_of[p]
        sp = p - vol.off_t[sid]
        sid, qo, sp = sid.cpu().numpy(), qo.cpu().numpy(), sp.cpu().numpy()
        keys.append(np.stack([np.full(len(sid), qid), np.full(len(sid), d), sid], 1))
        qos.append(qo)
        sps.append(sp)
    rows = _pair_rows(_group(np.concatenate(keys), np.concatenate(qos), np.concatenate(sps)),
                      vol, o)
    return top_n(rows, o["n"])


def subject_rows(vol: Volume, sid: int, o: dict) -> list:
    """Every candidate row in which read sid is the subject: the sampled
    k-mers of every later read, on both strands, that occur in sid."""
    k = vol.k
    L, off = int(vol.lens[sid]), int(vol.offsets[sid])
    th = vol.fwd[off:off + L - k + 1]
    th_sorted, th_order = torch.sort(th, stable=True)
    later = vol.valid & (vol.read_of > sid)
    keys, qos, sps = [], [], []
    for d, hv in ((0, vol.fwd), (1, vol.rc)):
        qo_all = vol.qoff[d]
        sel = later & (qo_all % o["z"] == 0)
        sel &= torch.isin(hv, th_sorted)
        p = torch.nonzero(sel)[:, 0]
        h = hv[p]
        _, cnt = vol.count(h)
        use = cnt <= o["q"]
        p, h = p[use], h[use]
        lo = torch.searchsorted(th_sorted, h)
        hi = torch.searchsorted(th_sorted, h, right=True)
        m = hi - lo
        rep = torch.repeat_interleave(torch.arange(len(m), device=vol.device), m)
        first = torch.cumsum(m, 0) - m
        sp = th_order[lo[rep] + (torch.arange(len(rep), device=vol.device) - first[rep])]
        qid = vol.read_of[p][rep]
        qo = qo_all[p][rep]
        qid, qo, sp = qid.cpu().numpy(), qo.cpu().numpy(), sp.cpu().numpy()
        keys.append(np.stack([qid, np.full(len(qid), d), np.full(len(qid), sid)], 1))
        qos.append(qo)
        sps.append(sp)
    return _pair_rows(_group(np.concatenate(keys), np.concatenate(qos), np.concatenate(sps)),
                      vol, o)


def swap(r: dict) -> dict:
    """The row with query and subject swapped, the subject kept on its
    forward strand (a strand-1 row mirrors both reads' coordinates)."""
    rev = r["qdir"] == 1
    return dict(qid=r["sid"], sid=r["qid"], qdir=r["qdir"], score=r["score"],
                qbeg=r["ssize"] - r["send"] if rev else r["sbeg"],
                qend=r["ssize"] - r["sbeg"] if rev else r["send"],
                sbeg=r["qsize"] - r["qend"] if rev else r["qbeg"],
                send=r["qsize"] - r["qbeg"] if rev else r["qend"],
                qsize=r["ssize"], ssize=r["qsize"])


def template_rows(vol: Volume, tid: int, o: dict) -> list:
    """The candidates of template tid for correction: the rows of every pair
    it takes part in, with tid as the subject."""
    return subject_rows(vol, tid, o) + [swap(r) for r in query_rows(vol, tid, o)]
