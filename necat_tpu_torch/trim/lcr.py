"""Read trimming: largest-cover-range clipping with chimera/complete detection
(the port's copy of necat_tpu/trim/lcr.py, host NumPy).

Rebuild of the trim stage (src/trim_bases/): the reference's three-variant
flow (fast/accurate/accurate0, necat.pl:1196-1210) exists to save CPU by
remapping only unfinished reads; since our overlapper is cheap, we run the
single-pass form: all-vs-all overlaps -> per-read qualified-overlap filter ->
complete/chimeric classification -> largest cover range -> clip. Semantics of
the per-read passes follow largest_cover_range.c / detect_chimeric_reads.c
exactly; parameters match the fast path (necat.pl:748-755: error cutoff 0.1,
min_ovlp 1, min_cov 1, min_size 1000).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.m4 import M4Records

K_MAX_END = 20  # largest_cover_range.c:11


@dataclasses.dataclass(frozen=True)
class TrimOptions:
    min_ident: float = 90.0     # 100*(1 - 0.1) necat.pl:748
    min_ovlp: int = 1
    min_cov: int = 1
    min_size: int = 1000
    max_m4_per_read: int = 300  # truncate_m4_list (largest_cover_range.c:72)


def qualified_m4_mask(m4: M4Records) -> np.ndarray:
    """is_qualified_m4 (largest_cover_range.c:42-66): dovetail-shaped overlaps."""
    L, M = 2000, 20
    qoff, qend = m4.fwd_query_range()
    soff, send, ssize, qsize = m4.soff, m4.send, m4.ssize, m4.qsize
    ok = (qoff <= M) & (qsize - qend <= M)
    ok |= (soff <= M) & (ssize - send <= M)
    ok |= (qsize - qend <= M) & (soff <= M) & (qend - qoff >= L)
    ok |= (ssize - send <= M) & (qoff <= M) & (qend - qoff >= L)
    return ok


def largest_cover_range(soffs: np.ndarray, sends: np.ndarray,
                        min_cov: int, min_ovlp: int) -> Tuple[int, int] | None:
    """largest_cover_range (largest_cover_range.c:87-206): merge overlap
    intervals chained by >= min_ovlp overlap, intersect with depth >= min_cov
    regions, return the largest surviving interval."""
    if len(soffs) == 0:
        return None
    order = np.lexsort((sends, soffs))
    lo, hi = soffs[order], sends[order]
    # merged intervals (overlap >= min_ovlp or containment)
    merged: List[Tuple[int, int]] = []
    cl, ch = int(lo[0]), int(hi[0])
    for l, h in zip(lo[1:], hi[1:]):
        if (cl <= l and h <= ch) or (ch - min_ovlp >= l):
            ch = max(ch, int(h))
        else:
            merged.append((cl, ch))
            cl, ch = int(l), int(h)
    merged.append((cl, ch))

    if min_cov > 0:
        # depth regions >= min_cov (depth_from_CovRangeList + scan)
        events = np.concatenate([np.stack([lo, np.ones_like(lo)], 1),
                                 np.stack([hi, -np.ones_like(hi)], 1)])
        ev_order = np.lexsort((-events[:, 1], events[:, 0]))
        ev = events[ev_order]
        depth = np.cumsum(ev[:, 1])
        regions: List[Tuple[int, int]] = []
        rb = None
        for i in range(len(ev)):
            pos = int(ev[i, 0])
            d = int(depth[i])
            nxt = int(ev[i + 1, 0]) if i + 1 < len(ev) else pos
            if d >= min_cov and rb is None:
                rb = pos
            if d < min_cov and rb is not None:
                regions.append((rb, pos))
                rb = None
        if rb is not None:
            regions.append((rb, int(ev[-1, 0])))
        # intersect merged with regions
        out: List[Tuple[int, int]] = []
        for ml, mh in merged:
            for rl, rh in regions:
                l, h = max(ml, rl), min(mh, rh)
                if l < h:
                    out.append((l, h))
        merged = out

    if not merged:
        return None
    best = max(merged, key=lambda t: t[1] - t[0])
    return best


def _chimeric_pair_check(qb1, qe1, qb2, qe2, tb1, te1, tb2, te2, qsize, tsize) -> int:
    """Cases I/II of detect_chimeric_reads.c:36-160 for one alignment pair."""
    if qb1 < qb2:
        lqb, lqe, rqb, rqe = qb1, qe1, qb2, qe2
    else:
        lqb, lqe, rqb, rqe = qb2, qe2, qb1, qe1
    if tb1 < tb2:
        ltb, lte, rtb, rte = tb1, te1, tb2, te2
    else:
        ltb, lte, rtb, rte = tb2, te2, tb1, te1
    ov1, ov2 = lqe - lqb, rqe - rqb
    if min(ov1, ov2) < max(ov1, ov2) * 0.9:
        return 0
    common = max(0, lqe - rqb)
    if not (common >= ov1 * 0.9 and common >= ov2 * 0.9):
        return 0
    # case I: complete target, target halves disjoint-ish
    mapped_t = (rte - ltb) - max(0, rtb - lte)
    if mapped_t >= tsize * 0.9:
        if lte > rtb:
            ov = lte - rtb
            if ov < (lte - ltb) * 0.4 and ov < (rte - rtb) * 0.4:
                return 1
        else:
            return 1
    # case II: complete read on both alignments, target breakpoints close
    if (ov1 >= qsize * 0.9) and (ov2 >= qsize * 0.9) and abs(rtb - lte) <= 1000:
        return 2
    return 0


def classify_read(m4: M4Records, idx: np.ndarray, opts: TrimOptions) -> Tuple[str, int, int] | None:
    """Per-read (as subject) trim decision over its M4 set. Returns
    (kind, left, right) with kind in {complete, chimeric, lcr} or None."""
    sub = m4.take(idx)
    size = int(sub.ssize[0])
    ok = sub.ident >= opts.min_ident
    sub = sub.take(np.flatnonzero(ok))
    if len(sub) == 0:
        return None
    if len(sub) > opts.max_m4_per_read:
        order = np.argsort(-sub.ident, kind="stable")
        sub = sub.take(np.sort(order[:opts.max_m4_per_read]))
    # complete? (detect_chimeric_reads.c is_complete_read)
    comp = (sub.soff <= K_MAX_END) & (size - sub.send <= K_MAX_END)
    if comp.any():
        return ("complete", 0, size)
    # chimeric? best fwd vs best rev alignment of the same query read
    kind = _detect_chimeric(sub, size)
    if kind is not None:
        return kind
    r = largest_cover_range(sub.soff, sub.send, opts.min_cov, opts.min_ovlp)
    if r is None:
        return None
    return ("lcr", r[0], r[1])


def _detect_chimeric(sub: M4Records, size: int):
    qf, qe = sub.fwd_query_range()
    order = np.lexsort((-sub.vscore, sub.qdir, sub.qid))
    n_chim = 0
    best = (0, 0, 0)
    i = 0
    qid_s = sub.qid[order]
    while i < len(order):
        j = i + 1
        while j < len(order) and qid_s[j] == qid_s[i]:
            j += 1
        # first record of each qdir within the group
        k = i + 1
        while k < j and sub.qdir[order[k]] == sub.qdir[order[i]]:
            k += 1
        if k < j:
            a, b = order[i], order[k]
            r = _chimeric_pair_check(qf[a], qe[a], qf[b], qe[b],
                                     sub.soff[a], sub.send[a], sub.soff[b], sub.send[b],
                                     int(sub.qsize[a]), size)
            if r:
                n_chim += 1
                for t in (a, b):
                    if sub.send[t] - sub.soff[t] > best[0]:
                        best = (int(sub.send[t] - sub.soff[t]), int(sub.soff[t]), int(sub.send[t]))
        i = j
    if n_chim > 1 and best[0] > 0:
        return ("chimeric", best[1], best[2])
    return None


def trim_reads(
    store: ReadStore,
    m4: M4Records,
    opts: TrimOptions = TrimOptions(),
) -> Tuple[ReadStore, np.ndarray, np.ndarray]:
    """Clip every read to its largest cover range.

    `m4` must contain each overlap once (sid < qid); both orientations are
    derived internally (the oc2pm4 duplication). Returns (trimmed_store,
    kept_read_ids, clip_ranges[N, 2]) where row i of clip_ranges is the
    [left, right) window of original read kept_read_ids[i].
    """
    full = M4Records.concat([m4, m4.swap_roles()])
    qual = qualified_m4_mask(full)
    full = full.take(np.flatnonzero(qual))
    if len(full) == 0:
        return ReadStore.from_seqs([]), np.zeros(0, np.int64), np.zeros((0, 2), np.int64)
    order = np.argsort(full.sid, kind="stable")
    sid_sorted = full.sid[order]
    bounds = np.flatnonzero(np.r_[True, sid_sorted[1:] != sid_sorted[:-1]])
    bounds = np.r_[bounds, len(order)]

    kept, ranges, seqs, names = [], [], [], []
    for i in range(len(bounds) - 1):
        s, e = bounds[i], bounds[i + 1]
        rid = int(sid_sorted[s])
        res = classify_read(full, order[s:e], opts)
        if res is None:
            continue
        _, left, right = res
        if right - left < opts.min_size:
            continue
        kept.append(rid)
        ranges.append((left, right))
        seqs.append(store.get(rid)[left:right])
        names.append(store.names[rid])
    trimmed = ReadStore.from_seqs(seqs, names)
    return trimmed, np.array(kept, np.int64), np.array(ranges, np.int64).reshape(-1, 2)
