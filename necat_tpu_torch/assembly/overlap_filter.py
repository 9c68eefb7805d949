"""Overlap filtering before string-graph assembly (the port's copy of
necat_tpu/assembly/overlap_filter.py).

Host-side rebuild of fsa_ol_filter (src/fsa/overlap_filter.{hpp,cpp}): the pass
pipeline StatLowQuality -> FilterLowQuality -> GroupAndFilterDuplicate ->
FilterContained -> FilterCoverage -> FilterBestN (overlap_filter.hpp:104-117),
with auto-selected identity/overhang thresholds from per-read statistics
(AutoSelectParams, :119-128). Overhang ends within the threshold are clamped to
the sequence ends (ModifyEnd) so the graph sees proper dovetails. NumPy
vectorized; the MT variants of the reference collapse into array passes.

Overlaps are in the A/B co-directional frame: A = query on its qdir strand
(qoff/qend), B = subject forward (soff/send).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from necat_tpu_torch.overlap.m4 import M4Records


@dataclasses.dataclass(frozen=True)
class FilterOptions:
    min_identity: float = -1.0       # auto when < 0 (overlap_filter.hpp min_identity_)
    min_identity_raw: float = 70.0
    max_overhang: int = -1           # auto when < 0
    max_overhang_raw: int = 1000
    min_length: int = 2500
    min_aligned_length: int = 2500
    bestn: int = 10
    # coverage params (auto-selected from the per-read min/max coverage
    # distributions when < 0 — CoverageParam, overlap_filter.cpp:1267-1349)
    min_coverage: int = -1
    max_coverage: int = -1
    max_diff_coverage: int = -1
    coverage_discard: float = 1.0    # percentile (%, coverage_discard_)
    identity_deviation: float = 6.0  # identity_global_deviation2_
    overhang_deviation: float = 6.0
    lack_of_support: bool = True     # FilterLackOfSupport pass

    @classmethod
    def from_string(cls, s: str,
                    base: "FilterOptions | None" = None) -> "FilterOptions":
        """Parse an FSA_OL_FILTER_OPTIONS string (fsa_ol_filter ArgumentParser
        names, overlap_filter.cpp:31-60) over defaults. Unsupported names
        warn loudly instead of vanishing."""
        from necat_tpu_torch.utils.args import apply_named, parse_named
        mapping = {
            "min_length": ("min_length", int),
            "min_identity": ("min_identity", float),
            "min_aligned_length": ("min_aligned_length", int),
            "max_overhang": ("max_overhang", int),
            "min_coverage": ("min_coverage", int),
            "max_coverage": ("max_coverage", int),
            "max_diff_coverage": ("max_diff_coverage", int),
            "coverage_discard": ("coverage_discard", float),
            "bestn": ("bestn", int),
            "identity_global_deviation2": ("identity_deviation", float),
            "overhang_global_deviation2": ("overhang_deviation", float),
        }
        return apply_named(parse_named(s), mapping, base or cls(),
                           "fsa_ol_filter")


@dataclasses.dataclass
class FilterResult:
    m4: M4Records
    min_identity: float
    max_overhang: int
    contained: np.ndarray   # read ids judged contained
    filtered_reads: np.ndarray
    # per-read statistics over the kept overlaps (the reference's readinfos /
    # coverage dumps, overlap_filter.hpp:162-167 — consumed by fsa_ctg_bridge
    # AutoSelectParams, contig_bridge.cpp:197-290)
    read_ident: np.ndarray | None = None    # mean identity (nan = no overlaps)
    read_cov: np.ndarray | None = None      # int32[n_reads, 2] (min, max)


def _per_read_stats(m4: M4Records, n_reads: int):
    """Per-read median identity and overhang over its overlaps (CalcReadInfo)."""
    qoff_f, qend_f = m4.fwd_query_range()
    oh_q = np.minimum(qoff_f, m4.qsize - qend_f)
    oh_s = np.minimum(m4.soff, m4.ssize - m4.send)
    ident_sum = np.zeros(n_reads)
    oh_sum = np.zeros(n_reads)
    cnt = np.zeros(n_reads)
    for ids, ident, oh in ((m4.qid, m4.ident, oh_q), (m4.sid, m4.ident, oh_s)):
        np.add.at(ident_sum, ids, ident)
        np.add.at(oh_sum, ids, oh)
        np.add.at(cnt, ids, 1)
    with np.errstate(invalid="ignore"):
        mean_ident = np.where(cnt > 0, ident_sum / np.maximum(cnt, 1), np.nan)
        mean_oh = np.where(cnt > 0, oh_sum / np.maximum(cnt, 1), np.nan)
    return mean_ident, mean_oh, cnt


def auto_thresholds(m4: M4Records, n_reads: int, opts: FilterOptions) -> Tuple[float, int]:
    """AutoSelectParams (overlap_filter.cpp): identity threshold = mean - dev*std of
    per-read identities; overhang threshold from the typical dovetail hang.

    The overhang statistic uses the distribution of per-overlap min-hangs
    robustly (median of the dovetail-like population), because partial/repeat
    overlaps inflate a mean+dev estimate to the cap and everything then counts
    as contained."""
    mean_ident, mean_oh, cnt = _per_read_stats(m4, n_reads)
    have = cnt > 0
    if not have.any():
        return opts.min_identity_raw, opts.max_overhang_raw
    mi = mean_ident[have]
    ident_thr = float(np.clip(mi.mean() - opts.identity_deviation * mi.std(),
                              opts.min_identity_raw, 100.0))
    qoff_f, qend_f = m4.fwd_query_range()
    oh = np.minimum(np.minimum(qoff_f, m4.qsize - qend_f),
                    np.minimum(m4.soff, m4.ssize - m4.send))
    med = float(np.median(oh))
    mad = float(np.median(np.abs(oh - med))) + 1.0
    oh_thr = int(np.clip(med + opts.overhang_deviation * mad + 30, 50,
                         opts.max_overhang_raw))
    return ident_thr, oh_thr


def clamp_ends(m4: M4Records, maxoh: int) -> M4Records:
    """ModifyEnd: clamp overhangs <= maxoh onto the sequence ends so dovetails
    become exact."""
    qoff = np.where(m4.qoff <= maxoh, 0, m4.qoff)
    qend = np.where(m4.qsize - m4.qend <= maxoh, m4.qsize, m4.qend)
    soff = np.where(m4.soff <= maxoh, 0, m4.soff)
    send = np.where(m4.ssize - m4.send <= maxoh, m4.ssize, m4.send)
    out = M4Records(**{f: getattr(m4, f).copy() for f in
                       ("qid", "sid", "ident", "vscore", "qdir", "qoff", "qend",
                        "qsize", "sdir", "soff", "send", "ssize")})
    out.qoff, out.qend, out.soff, out.send = (qoff.astype(np.int32), qend.astype(np.int32),
                                              soff.astype(np.int32), send.astype(np.int32))
    return out


def classify(m4: M4Records):
    """Per overlap: is A contained / B contained / proper dovetail (after clamping).

    Containment/location semantics follow Overlap::Location (fsa/overlap.hpp:40-73).
    """
    a_l = m4.qoff
    a_r = m4.qsize - m4.qend
    b_l = m4.soff
    b_r = m4.ssize - m4.send
    a_contained = (a_l == 0) & (a_r == 0)
    b_contained = (b_l == 0) & (b_r == 0)
    # proper dovetail: at each end one of the reads is exhausted
    left_ok = (a_l == 0) | (b_l == 0)
    right_ok = (a_r == 0) | (b_r == 0)
    proper = left_ok & right_ok
    return a_contained, b_contained, proper


def filter_overlaps(m4: M4Records, n_reads: int, opts: FilterOptions = FilterOptions()) -> FilterResult:
    if len(m4) == 0:
        return FilterResult(m4, opts.min_identity_raw, opts.max_overhang_raw,
                            np.zeros(0, np.int64), np.zeros(0, np.int64))
    # --- auto params + low-quality pass
    min_ident = opts.min_identity
    max_oh = opts.max_overhang
    if min_ident < 0 or max_oh < 0:
        ai, ao = auto_thresholds(m4, n_reads, opts)
        if min_ident < 0:
            min_ident = ai
        if max_oh < 0:
            max_oh = ao
    keep = (m4.ident >= min_ident)
    keep &= (m4.qsize >= opts.min_length) & (m4.ssize >= opts.min_length)
    span = np.maximum(m4.qend - m4.qoff, m4.send - m4.soff)
    keep &= span >= opts.min_aligned_length
    m4 = m4.take(np.flatnonzero(keep))
    # classification uses end-clamped coords (ModifyEnd); the RETURNED records
    # keep original coordinates so the graph can trim true unaligned tails.
    cl = clamp_ends(m4, max_oh)
    a_c, b_c, proper = classify(cl)
    # overhang filter: non-proper, non-containment overlaps are local/repeat hits
    keep2 = np.flatnonzero(proper | a_c | b_c)
    m4, cl = m4.take(keep2), cl.take(keep2)

    # --- duplicate pass: keep best aligned length per (qid, sid) pair
    pair_lo = np.minimum(m4.qid, m4.sid).astype(np.int64)
    pair_hi = np.maximum(m4.qid, m4.sid).astype(np.int64)
    pair_key = pair_lo * (n_reads + 1) + pair_hi
    alen = np.maximum(m4.qend - m4.qoff, m4.send - m4.soff)
    order = np.lexsort((-alen, pair_key))
    first = np.sort(order[np.r_[True, pair_key[order][1:] != pair_key[order][:-1]]])
    m4, cl = m4.take(first), cl.take(first)
    a_c, b_c, proper = classify(cl)

    # --- contained reads
    contained = np.zeros(n_reads, bool)
    contained[m4.qid[a_c]] = True
    contained[m4.sid[b_c]] = True
    keep3 = np.flatnonzero(~(contained[m4.qid] | contained[m4.sid]))
    m4, cl = m4.take(keep3), cl.take(keep3)

    # --- coverage filter (FilterCoverage, overlap_filter.cpp:690-718): drop
    # reads whose coverage profile min/max/diff falls outside the auto params
    filtered_reads = np.zeros(n_reads, bool)
    min_cov_param = max(opts.min_coverage, 0)
    if len(m4):
        covs = _per_read_minmax_cov(cl, n_reads, int(max_oh))
        have = np.flatnonzero(covs[:, 1] > 0)
        if len(have) >= 8:
            pmin, pmax, pdiff = _coverage_params(covs[have], opts)
            min_cov_param = pmin
            bad = np.zeros(n_reads, bool)
            bad[have] = ((covs[have, 0] < pmin) | (covs[have, 1] > pmax)
                         | (covs[have, 1] - covs[have, 0] > pdiff))
            filtered_reads = bad
            keep4 = np.flatnonzero(~(bad[m4.qid] | bad[m4.sid]))
            m4, cl = m4.take(keep4), cl.take(keep4)

    # --- lack-of-support (FilterLackOfSupport, :751-762): an overlap whose
    # junction isn't corroborated by other overlaps at the same read ends is
    # a likely repeat-induced false join
    if len(m4) and opts.lack_of_support:
        keep_s = _support_mask(cl, max(0, min_cov_param - 1))
        m4, cl = m4.take(np.flatnonzero(keep_s)), cl.take(np.flatnonzero(keep_s))

    # --- best-N per read per end (side classification on clamped coords)
    if len(m4) and opts.bestn > 0:
        keep5 = _best_n_mask(cl, opts.bestn)
        m4 = m4.take(np.flatnonzero(keep5))

    read_ident, _, _ = _per_read_stats(m4, n_reads)
    read_cov = _per_read_minmax_cov(clamp_ends(m4, max_oh), n_reads,
                                    int(max_oh))
    return FilterResult(m4, min_ident, int(max_oh),
                        np.flatnonzero(contained),
                        np.flatnonzero(filtered_reads),
                        read_ident=read_ident, read_cov=read_cov)


def _per_read_minmax_cov(m4: M4Records, n_reads: int, overhang_limit: int
                         ) -> np.ndarray:
    """Per-read (min, max) of the coverage profile over its overlaps, with
    intervals extended by the overhang limit (CalcMinMaxCoverage,
    overlap_filter.cpp:1209-1247). Exact diff-array per read; returns
    int32[n_reads, 2] ((0, 0) for reads with no overlaps)."""
    covs = np.zeros((n_reads, 2), np.int32)
    qoff_f, qend_f = m4.fwd_query_range()
    # one global diff array over concatenated read coordinate spaces
    sizes = np.zeros(n_reads, np.int64)
    for ids, size in ((m4.qid, m4.qsize), (m4.sid, m4.ssize)):
        sizes[ids] = size
    starts = np.concatenate([[0], np.cumsum(sizes + 1)])
    total = int(starts[-1])
    diff = np.zeros(total + 1, np.int32)
    for ids, lo, hi, size in ((m4.qid, qoff_f, qend_f, m4.qsize),
                              (m4.sid, m4.soff, m4.send, m4.ssize)):
        a = starts[ids] + np.maximum(0, lo - overhang_limit)
        b = starts[ids] + np.minimum(size, hi + overhang_limit)
        np.add.at(diff, a, 1)
        np.add.at(diff, b, -1)
    prof = np.cumsum(diff[:-1])
    touched = np.unique(np.concatenate([m4.qid, m4.sid]))
    for rid in touched:
        seg = prof[starts[rid]:starts[rid] + sizes[rid]]
        if len(seg):
            covs[rid, 0] = seg.min()
            covs[rid, 1] = seg.max()
    return covs


def _coverage_params(covs: np.ndarray, opts: FilterOptions):
    """Auto min/max/diff coverage (CoverageParam, overlap_filter.cpp:1267-1349):
    discard-percentile from below of per-read MIN coverages, from above of MAX
    coverages and of (max - min)."""
    q = opts.coverage_discard
    pmin = opts.min_coverage
    pmax = opts.max_coverage
    pdiff = opts.max_diff_coverage
    if pmin < 0:
        pmin = int(np.percentile(covs[:, 0], q, method="inverted_cdf"))
    if pmax < 0:
        pmax = int(np.percentile(covs[:, 1], 100 - q, method="inverted_cdf"))
    if pdiff < 0:
        pdiff = int(np.percentile(covs[:, 1] - covs[:, 0], 100 - q,
                                  method="inverted_cdf"))
    return pmin, pmax, pdiff


def _support_mask(cl: M4Records, count: int) -> np.ndarray:
    """HasSupport (overlap_filter.cpp:1459-1516), per-end-count form: a
    dovetail overlap joining A's end ea to B's end eb is supported when A has
    > count OTHER overlaps at ea and B > count at eb."""
    if count <= 0:
        return np.ones(len(cl), bool)
    qoff_f, qend_f = cl.fwd_query_range()
    q_side = np.where(qoff_f == 0, 0, 1)
    s_side = np.where(cl.soff == 0, 0, 1)
    n = int(max(cl.qid.max(), cl.sid.max())) + 1
    cnt = np.zeros((n, 2), np.int64)
    np.add.at(cnt, (cl.qid, q_side), 1)
    np.add.at(cnt, (cl.sid, s_side), 1)
    sup_a = cnt[cl.qid, q_side] - 1 >= count
    sup_b = cnt[cl.sid, s_side] - 1 >= count
    return sup_a & sup_b


def _best_n_mask(cl: M4Records, bestn: int) -> np.ndarray:
    """FilterBestN: keep each read's best n overlaps per end (left/right),
    classified on end-clamped coords."""
    alen = np.maximum(cl.qend - cl.qoff, cl.send - cl.soff)
    qoff_f, qend_f = cl.fwd_query_range()
    # end of each overlap on each read: 0 = left (prefix), 1 = right (suffix)
    q_end_side = np.where(qoff_f == 0, 0, 1)
    s_end_side = np.where(cl.soff == 0, 0, 1)
    keep = np.zeros(len(cl), bool)
    for ids, side in ((cl.qid, q_end_side), (cl.sid, s_end_side)):
        key = ids.astype(np.int64) * 2 + side
        order = np.lexsort((-alen, key))
        key_s = key[order]
        newg = np.r_[True, key_s[1:] != key_s[:-1]]
        grp_first = np.flatnonzero(newg)
        gid = np.cumsum(newg) - 1
        rank = np.arange(len(order)) - grp_first[gid]
        keep[order[rank < bestn]] = True
    return keep
