"""The reference's read correction with the long-indel rescue ladder and
broken consensus, in plain NumPy over reference.search, reference.extend
and the helpers of reference.correct.

Written from the semantics of the JAX package's fused correction with
rescue (necat_tpu/consensus/correct.py _run_waves_fused, fused.py; after
NECAT's cns_extension cascade, consensus_aux.c:123-215, and cbcns.c), one
template and one pair at a time, with none of its batching, buckets,
deferral flags or device tensors. Everything reference.correct states
holds here too (candidates, waves, cutoff, acceptance, weights, votes and
the call); in addition:

  * a pass aligns against a window of the template around the anchor:
    the left pass over at most (aq * 13) // 10 + 600 template bases
    before the anchor, the right pass over at most ((qsize - aq) * 13) //
    10 + 600 after it (NECAT's oc_aligner windows the subject the same
    way); at W = 128 the W/4 clamp binds first, so only the wide rungs
    can meet the window;
  * a pair hangs when its alignment leaves more than 200 bases of the
    candidate's query range [qbeg, qend) unaligned; the rungs are W0 * 4,
    W0 * 8, ... doubling up to W0 * rescue_band_max_scale and 4096;
  * round 0, with the ladder: a hanging pair climbs the rungs in turn; a
    rung counts only where it aligned at least the best columns so far,
    and the pair stops climbing once a counted rung leaves it hanging by
    200 or less. Its best rung (the last that counted) gives the identity
    that feeds the template's cutoff, and the pair is accepted and votes
    with that rung's alignment;
  * later rounds, with the ladder: a pair that hangs at W0 is held back
    and climbs the rungs; at a rung it is judged (accepted or not, as at
    W0) unless it still hangs (the last rung does not hold it back for
    that) or aligned fewer columns than its best so far; a pair held back
    past the last rung is judged with its best rung's alignment;
  * broken consensus (-f 0): each covered run of at least min_size columns
    gives a corrected piece (its called bases, kept if at least min_size
    of them); the template's stretches of at least 1000 bases (raw_min_gap)
    outside the pieces pass through uncorrected; nothing else is emitted
    for it. Full consensus (-f 1) is reference.correct's whole read;
  * a template with fewer than min_cov candidates passes through whole
    and uncorrected, with either -f.

Departures: none in what is computed; the passes of a wave are extended
in groups of at most BUDGET bytes of moves, which changes no result (the
lanes are independent).
"""

from __future__ import annotations

import types
from collections import Counter

import numpy as np
import torch

from portbench.reference import correct as C
from portbench.reference import extend as X
from portbench.reference import search as S

MAX_BAND = 4096
WINDOW_MARGIN = 600
HANG = 200
RAW_MIN_GAP = 1000
# bytes of moves (lanes x columns x band) one extension call may hold
BUDGET = 2 << 30


def parse_cns_options(s: str) -> dict:
    """reference.correct's options with the ladder's constants."""
    o = C.parse_cns_options(s)
    o.update(rescue_band_scale=4, rescue_band_max_scale=32, raw_min_gap=RAW_MIN_GAP)
    return o


def rungs(o: dict) -> list:
    """The ladder's band widths."""
    out, scale = [], o["rescue_band_scale"]
    while scale <= o["rescue_band_max_scale"] and o["band_width"] * scale <= MAX_BAND:
        out.append(o["band_width"] * scale)
        scale *= 2
    return out


class _Pair:
    """One pair's alignment at one band: the clipped counts and the lanes
    (left pass li, right pass li + 1 of `lanes`) it votes with."""

    def __init__(self, t, c, lanes, li: int, W: int):
        self.W = W
        aq, at = int(c["qbeg"]), int(c["sbeg"])
        L, R = li, li + 1
        self.lanes, self.li = lanes, li
        self.ql, self.qr = aq - int(lanes.q[L]), aq + int(lanes.q[R])
        self.tl, self.tr = at - int(lanes.jc[L]), at + int(lanes.jc[R])
        self.n_cols = int(lanes.n_cols[L] + lanes.n_cols[R])
        n_match = int(lanes.n_match[L] + lanes.n_match[R])
        self.ident = (np.float32(100.0) * np.float32(n_match) / np.float32(max(self.n_cols, 1))
                      if self.n_cols > 0 else np.float32(0.0))
        self.hang = max(self.ql - int(c["qbeg"]), 0) + max(int(c["qend"]) - self.qr, 0)


def _extend(pairs: list, W: int, read, device) -> list:
    """The _Pair of every (template, candidate) of `pairs` at band W."""
    passes = []
    for t, c in pairs:
        q = read(c["qid"])
        q = C._rc(q) if c["qdir"] == 1 else q
        aq, at = int(c["qbeg"]), int(c["sbeg"])
        ws = max(at - ((aq * 13) // 10 + WINDOW_MARGIN), 0)
        we = min(at + (((len(q) - aq) * 13) // 10 + WINDOW_MARGIN), t.n)
        passes.append((q[:aq][::-1], t.seq[ws:at][::-1]))
        passes.append((q[aq:], t.seq[at:we]))
    out = [None] * len(pairs)
    # pairs grouped by their longer pass, each group within BUDGET
    cols = [max(min(len(passes[2 * i][1]), len(passes[2 * i][0]) + W // 4),
                min(len(passes[2 * i + 1][1]), len(passes[2 * i + 1][0]) + W // 4), 1)
            for i in range(len(pairs))]
    order = sorted(range(len(pairs)), key=lambda i: cols[i])
    g = 0
    while g < len(order):
        h = g + 1
        while h < len(order) and 2 * (h + 1 - g) * cols[order[h]] * W <= BUDGET:
            h += 1
        grp = order[g:h]
        lanes = X.extend_lanes([passes[j][0] for i in grp for j in (2 * i, 2 * i + 1)],
                               [passes[j][1] for i in grp for j in (2 * i, 2 * i + 1)],
                               W, device)
        for k, i in enumerate(grp):
            out[i] = _Pair(*pairs[i], lanes, 2 * k, W)
        g = h
    return out


def _judge(p: _Pair, t, c, o: dict, round_id: int) -> bool:
    ok = p.n_cols >= o["min_align_size"]
    qs, ts = np.int64(c["qsize"]), np.int64(t.n)
    pass_ident = p.ident >= t.cutoff
    if round_id > 0:
        pass_ident |= bool(C._full_cov(p.ql, p.qr, qs, p.tl, p.tr, ts))
    return bool(ok and pass_ident and C._mapping_range(p.ql, p.qr, qs, p.tl, p.tr, ts,
                                                        o["min_align_size"],
                                                        o["mapping_ratio"]))


def _vote(p: _Pair, t, c, o: dict, weight_dtype) -> None:
    w = C.cns_weight(np.array([p.ident], np.float32))
    if weight_dtype is not None:
        w = torch.from_numpy(w).to(weight_dtype).float().numpy()
    t.cov[min(max(p.tl, 0), t.n):min(max(p.tr, 0), t.n)] += 1
    at = int(c["sbeg"])
    C._scatter(t, p.lanes, p.li, at, float(w[0]), True, o["max_delta"])
    C._scatter(t, p.lanes, p.li + 1, at, float(w[0]), False, o["max_delta"])


def _count(bands: Counter, pairs, idx, W) -> None:
    """Count the pairs idx of `pairs` as extended at band W (one W, or
    one a pair)."""
    for i, w in zip(idx, W if isinstance(W, list) else [W] * len(idx)):
        t, c = pairs[i]
        bands[(t.tid, int(c["qid"]), int(w))] += 1


def _round0(pairs, tpls, o, read, device, climbed: dict, bands: Counter) -> list:
    """Each pair's alignment at its best band; the templates' cutoffs."""
    best = _extend(pairs, o["band_width"], read, device)
    _count(bands, pairs, range(len(pairs)), o["band_width"])
    if o["rescue"]:
        bad = [i for i, p in enumerate(best) if p.hang > HANG]
        for Wx in rungs(o):
            if not bad:
                break
            _count(bands, pairs, bad, Wx)
            for i in bad:
                climbed[pairs[i][0].tid] = climbed.get(pairs[i][0].tid, 0) + 1
            nb = []
            for i, p in zip(bad, _extend([pairs[i] for i in bad], Wx, read, device)):
                imp = p.n_cols >= best[i].n_cols
                if imp:
                    best[i] = p
                if p.hang > HANG or not imp:
                    nb.append(i)
            bad = nb
        # each pair again at its band
        _count(bands, pairs, range(len(pairs)), [p.W for p in best])
    for t in tpls:
        m = [i for i, (tt, _) in enumerate(pairs) if tt is t]
        if not m:
            continue
        ps = [best[i] for i in m]
        ql = np.array([p.ql for p in ps]); qr = np.array([p.qr for p in ps])
        tl = np.array([p.tl for p in ps]); tr = np.array([p.tr for p in ps])
        qs = np.array([pairs[i][1]["qsize"] for i in m]); ts = np.full(len(m), t.n)
        ident = np.array([p.ident for p in ps], np.float32)
        ok_align = np.array([p.n_cols for p in ps]) >= o["min_align_size"]
        good = C._good_overlap(ql, qr, qs, tl, tr, ts, o["good_end_margin"]) & ok_align
        span = (((qr - ql) >= np.float32(0.6) * qs.astype(np.float32))
                | ((tr - tl) >= np.float32(0.6) * ts.astype(np.float32))) & ok_align
        t.cutoff = C.ident_cutoff(ident, good, span, o["n_ident"])
    return best


def _later(pairs, o, read, device, climbed: dict, bands: Counter) -> list:
    """Each pair's alignment that is judged, in a round after 0."""
    res = _extend(pairs, o["band_width"], read, device)
    _count(bands, pairs, range(len(pairs)), o["band_width"])
    if not o["rescue"]:
        return res
    final = list(res)
    di = [i for i, p in enumerate(res) if p.hang > HANG]
    best = {i: res[i] for i in di}
    ladder = rungs(o)
    for r, Wx in enumerate(ladder):
        if not di:
            break
        _count(bands, pairs, di, Wx)
        for i in di:
            climbed[pairs[i][0].tid] = climbed.get(pairs[i][0].tid, 0) + 1
        last = r + 1 == len(ladder)
        nd = []
        for i, p in zip(di, _extend([pairs[i] for i in di], Wx, read, device)):
            held = (not last and p.hang > HANG) or p.n_cols < best[i].n_cols
            if p.n_cols >= best[i].n_cols:
                best[i] = p
            if held:
                nd.append(i)
            else:
                final[i] = p
        di = nd
    for i in di:
        final[i] = best[i]
    _count(bands, pairs, di, [best[i].W for i in di])
    return final


def _pieces(t, o: dict) -> list:
    """Broken consensus of a template: (left, right, seq, corrected)."""
    V = t.votes.astype(np.float32)
    cov = t.votes_cov
    covered = cov >= o["min_cov"]
    b0 = np.argmax(V[0], axis=0)
    emit0 = covered & (b0 < 4) & (V[0].max(axis=0) > 0)
    wk = V[1:, :4]
    bk = np.argmax(wk, axis=1)
    thr = np.float32(o["ins_frac"]) * np.maximum(cov, 1).astype(np.float32) \
        + np.float32(o["ins_offset"])
    emitk = covered[None, :] & (wk.max(axis=1) >= thr[None, :])
    fields = np.concatenate([np.where(emit0, b0, 7)[None], np.where(emitk, bk, 7)], axis=0).T
    dif = np.diff(np.r_[0, covered.astype(np.int8), 0])
    cns = []
    for s, e in zip(np.flatnonzero(dif == 1), np.flatnonzero(dif == -1)):
        if e - s < o["min_size"]:
            continue
        f = fields[s:e]
        seq = f[f < 4].astype(np.uint8)
        if len(seq) >= o["min_size"]:
            cns.append((int(s), int(e), seq, True))
    raw, prev = [], 0
    for s, e in [(s, e) for s, e, _, _ in cns] + [(t.n, t.n)]:
        if s - prev >= o["raw_min_gap"]:
            raw.append((prev, s, t.seq[prev:s].astype(np.uint8), False))
        prev = max(prev, e)
    return cns + raw


def vote_weight(t) -> float:
    """A template's votes summed: every (rank, base, position) weight as
    the call reads it (float32), added in float64, which is exact for these
    sums of float32 pair weights."""
    return float(t.votes.astype(np.float32).sum(dtype=np.float64))


def correct(vol: S.Volume, tids, mo: dict, o: dict, device, weight_dtype=None,
            climbed: dict | None = None, bands: Counter | None = None,
            votes: dict | None = None) -> list:
    """The records of templates tids. With weight_dtype, the pair weights
    are rounded to it before they vote. climbed, if given, receives per
    template the pairs that climbed a rung, counted once a rung; bands the
    times each (template, query, band) pair was extended, as the program
    dispatches them (round 0 and the ladder's last rung extend a pair once
    more at its band); votes each template's vote_weight (none for a
    template passed through with fewer than min_cov candidates)."""
    climbed = {} if climbed is None else climbed
    bands = Counter() if bands is None else bands
    votes = {} if votes is None else votes
    read = lambda r: vol.host[vol.offsets[r]:vol.offsets[r + 1]]
    records, tpls = [], []
    for tid in tids:
        t = C._Template(int(tid), read(int(tid)), S.template_rows(vol, int(tid), mo), o)
        if len(t.cands) < o["min_cov"]:
            records.append(C._record(t, False, t.seq))
        else:
            tpls.append(t)
    max_rounds = -(-o["max_examined"] // o["wave_size"]) + 1
    round_id = 0 if not o["fixed_cutoff"] else 1
    while round_id <= max_rounds:
        wave = o["n_ident"] + 10 if round_id == 0 else o["wave_size"]
        pairs = [(t, c) for t in tpls for c in t.select(round_id, wave, o["max_cov"])]
        if not pairs:
            if round_id == 0:
                round_id += 1
                continue
            break
        if round_id == 0:
            res = _round0(pairs, tpls, o, read, device, climbed, bands)
        else:
            res = _later(pairs, o, read, device, climbed, bands)
        for (t, c), p in zip(pairs, res):
            if _judge(p, t, c, o, round_id):
                _vote(p, t, c, o, weight_dtype)
        round_id += 1
    for t in tpls:
        votes[t.tid] = vote_weight(t)
        if o["full_consensus"]:
            records.append(C._record(t, *C._call(t, o)))
        else:
            records += [types.SimpleNamespace(tid=t.tid, left=s, right=e, org_size=t.n,
                                              seq=seq, corrected=cor)
                        for s, e, seq, cor in _pieces(t, o)]
    return records
