"""The reference's read correction, in plain NumPy over reference.search
and reference.extend.

Written from the semantics of the JAX package's correction
(necat_tpu/consensus/correct.py, fused.py, tags.py, backbone.py, after
NECAT's consensus_one_read, error_estimate and cbcns), one template at a
time, with none of its batching, buckets or device tensors:

  * a template's candidates are the rows of every pair it is in, the best
    row per query read (ties to strand 0), ranked by score (ties by query
    id), the first max_examined kept; with fewer than min_cov it is passed
    through uncorrected;
  * round 0 extends the first n_ident + 10; from their identities the
    template's cutoff is mean - 5 sd (population) of the top 70 % (all
    below 8) of the first n_ident good overlaps (ends within 200 of the
    reads' ends; else of the first n_ident spanning 60 % of either read),
    aligned over >= min_align_size columns; 0 below 5 of them;
  * rounds 1.. take the next wave_size candidates whose template span
    still holds a position covered fewer than max_cov times, skipping the
    others, up to ceil(max_examined / wave_size) + 1 rounds;
  * a pair is accepted with >= min_align_size columns, a mapping range
    (min_align_size, or mapping_ratio of a read, on either read) and an
    identity >= the cutoff (from round 1 also a nearly full overlap:
    5000, tail 100); its span counts towards the coverage;
  * an accepted pair adds its float32 weight (1 - e)^2 + e^2/3, e = (100 -
    ident) / 200, to the template's (position, insertion rank, base) votes,
    summed exactly (float64): each kept column its base or a gap at rank 0,
    the first max_delta - 1 bases of each insertion run (the right pass's
    in order, the left pass's counted from the run's end) at ranks 1.., and
    one coverage count per kept column;
  * the call, in float32: at a position covered >= min_cov times, rank 0's
    heaviest of 5 (first on ties) unless a gap or no weight, rank d's
    heaviest base if its weight >= 0.2 coverage + 1;
  * full consensus: runs of covered positions >= 0.85 min_size long give
    their called bases if >= min_size of them; the read is those pieces
    joined by its raw bases between them, or passed through uncorrected.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from portbench.reference import extend as X
from portbench.reference import search as S

GAP = 4


def parse_cns_options(s: str) -> dict:
    """NECAT's consensus options (cns_options.c defaults and
    consensus_one_read's wave constants) with an option string's flags
    over them: -a, -x, -y, -l, -e, -p, -u, -r, -f."""
    o = dict(min_align_size=400, min_cov=4, max_cov=12, min_size=500, mapping_ratio=0.8,
             error=0.5, fixed_cutoff=False, rescue=False, full_consensus=False,
             max_examined=300, wave_size=50, n_ident=15, good_end_margin=200,
             max_delta=8, ins_frac=0.2, ins_offset=1.0, band_width=128)
    keys = {"a": ("min_align_size", int), "x": ("min_cov", int), "y": ("max_cov", int),
            "l": ("min_size", int), "e": ("error", float), "p": ("mapping_ratio", float),
            "u": ("fixed_cutoff", lambda v: bool(int(v))), "r": ("rescue", lambda v: bool(int(v))),
            "f": ("full_consensus", lambda v: bool(int(v)))}
    toks = s.split()
    for i in range(0, len(toks) - 1):
        t = toks[i]
        if t.startswith("-") and len(t) == 2 and t[1] in keys:
            name, conv = keys[t[1]]
            o[name] = conv(toks[i + 1])
    return o


def _f32(x):
    return np.float32(x)


def cns_weight(ident: np.ndarray) -> np.ndarray:
    """consensus_one_read.c:11-16 in float32."""
    ident = ident.astype(np.float32)
    e = (_f32(100.0) - ident) / _f32(100.0) / _f32(2.0)
    w = (_f32(1.0) - e) * (_f32(1.0) - e) + e * e / _f32(3.0)
    return np.where(_f32(100.0) - ident <= _f32(1e-6), _f32(1.0), w).astype(np.float32)


def ident_cutoff(ident, good, span, n_ident: int) -> np.float32:
    """error_estimate.c:32-64 over a template's round-0 overlaps, in float32."""
    sel = np.flatnonzero(good)[:n_ident]
    if min(len(sel), n_ident) < n_ident:
        sel = np.flatnonzero(span)[:n_ident]
    n = len(sel)
    if n < 5:
        return _f32(0.0)
    vals = np.sort(ident[sel].astype(np.float32))[::-1]
    vals = vals[:(n * 7) // 10 if n >= 8 else n]
    mean = vals.sum(dtype=np.float32) / _f32(len(vals))
    dv = vals - mean
    sd = np.sqrt(np.maximum((dv * dv).sum(dtype=np.float32) / _f32(len(vals)), _f32(0.0)))
    return _f32(mean - _f32(5.0) * sd)


def _good_overlap(ql, qr, qs, tl, tr, ts, m):
    return (((ql <= m) & (qs - qr <= m)) | ((tl <= m) & (ts - tr <= m))
            | ((qs - qr <= m) & (tl <= m)) | ((ts - tr <= m) & (ql <= m)))


def _mapping_range(ql, qr, qs, tl, tr, ts, min_size, ratio):
    r = _f32(ratio)
    return (((qr - ql) >= min_size) | ((tr - tl) >= min_size)
            | ((qr - ql) >= qs.astype(np.float32) * r) | ((tr - tl) >= ts.astype(np.float32) * r))


def _full_cov(ql, qr, qs, tl, tr, ts, size=5000, tail=100):
    r = ((ql <= tail) & (qs - qr <= tail)) | ((tl <= tail) & (ts - tr <= tail))
    r |= (qs - qr <= tail) & (tl <= tail) & ((qr - ql) >= size)
    r |= (ts - tr <= tail) & (ql <= tail) & ((qr - ql) >= size)
    return r


class _Template:
    def __init__(self, tid: int, seq: np.ndarray, rows: list, o: dict):
        self.tid, self.seq, self.n = tid, seq, len(seq)
        best = {}
        for r in sorted(rows, key=lambda r: (r["qid"], -r["score"], r["qdir"])):
            best.setdefault(r["qid"], r)
        ranked = sorted(best.values(), key=lambda r: (-r["score"], r["qid"]))
        self.cands = ranked[:o["max_examined"]]
        self.cursor = 0
        self.cov = np.zeros(self.n, np.int64)
        self.cutoff = _f32(100.0 * (1.0 - o["error"])) if o["fixed_cutoff"] else _f32(0.0)
        self.votes = np.zeros((o["max_delta"], 5, self.n), np.float64)
        self.votes_cov = np.zeros(self.n, np.int64)

    def select(self, round_id: int, wave: int, max_cov: int) -> list:
        """The next wave of candidates (those taken and those skipped before
        the last taken are consumed)."""
        pend = list(range(self.cursor, len(self.cands)))
        if not pend:
            return []
        if round_id > 0:
            under = np.r_[0, np.cumsum(self.cov < max_cov)]
            def elig(i):
                c = self.cands[i]
                sb, se = min(max(c["sbeg"], 0), self.n), min(max(c["send"], 0), self.n)
                return under[se] - under[sb] > 0
            pend = [i for i in pend if elig(i)]
        take = pend[:wave]
        self.cursor = take[-1] + 1 if len(take) >= wave else len(self.cands)
        return [self.cands[i] for i in take]


def _rc(x: np.ndarray) -> np.ndarray:
    return (3 - x[::-1]).astype(np.uint8)


def _scatter(t: _Template, lane, i: int, at: int, w: float, rev: bool, D: int) -> None:
    """Add one pass (lane i) of an accepted pair to the template's votes."""
    jc = int(lane.jc[i])
    if jc == 0:
        return
    A = lane.A[i].astype(np.int64)
    op, qrow, k = lane.op[i, :jc], lane.qrow[i, :jc], lane.k[i, :jc]
    j = np.arange(1, jc + 1)
    pos = at - j if rev else at + j - 1
    base0 = np.where(op == X.DEL, GAP, A[np.clip(qrow - 1, 0, len(A) - 1)])
    idx = [(0 * 5 + base0) * t.n + pos]
    np.add.at(t.votes_cov, pos, 1)
    # insertion runs after columns 1 .. jc-1
    for d in range(1, D):
        m = np.flatnonzero(k[:-1] >= d)
        if not len(m):
            break
        src = (qrow[m] + k[m] - d) if rev else (qrow[m] + d - 1)
        ipos = pos[m] - 1 if rev else pos[m]
        idx.append((d * 5 + A[src]) * t.n + ipos)
    # the run before column 1, between template positions at-1 and at
    lead = int(lane.lead[i])
    if lead and 0 <= at - 1 < t.n:
        d = np.arange(1, min(lead, D - 1) + 1)
        src = lead - d if rev else d - 1
        idx.append((d * 5 + A[src]) * t.n + (at - 1))
    idx = np.concatenate(idx)
    np.add.at(t.votes.reshape(-1), idx, np.float64(w))


def _call(t: _Template, o: dict):
    """The template's record: (corrected, sequence)."""
    V = t.votes.astype(np.float32)
    cov = t.votes_cov
    covered = cov >= o["min_cov"]
    b0 = np.argmax(V[0], axis=0)
    emit0 = covered & (b0 < 4) & (V[0].max(axis=0) > 0)
    wk = V[1:, :4]
    bk = np.argmax(wk, axis=1)
    thr = _f32(o["ins_frac"]) * np.maximum(cov, 1).astype(np.float32) + _f32(o["ins_offset"])
    emitk = covered[None, :] & (wk.max(axis=1) >= thr[None, :])
    f0 = np.where(emit0, b0, np.where(covered, 5, 7))
    fk = np.where(emitk, bk, 7)
    fields = np.concatenate([f0[None], fk], axis=0).T          # [n, D]
    min_run = max(1, int(o["min_size"] * 0.85))
    dif = np.diff(np.r_[0, (f0 != 7).astype(np.int8), 0])
    pieces = []
    for s, e in zip(np.flatnonzero(dif == 1), np.flatnonzero(dif == -1)):
        if e - s < min_run:
            continue
        f = fields[s:e]
        seq = f[f < 4].astype(np.uint8)
        if len(seq) >= o["min_size"]:
            pieces.append((s, e, seq))
    if not pieces:
        return False, t.seq
    parts, prev = [], 0
    for s, e, seq in pieces:
        parts += [t.seq[prev:s], seq]
        prev = e
    parts.append(t.seq[prev:])
    return True, np.concatenate(parts).astype(np.uint8)


def correct(vol: S.Volume, tids, mo: dict, o: dict, device, weight_dtype=None) -> list:
    """The records of templates tids (one each: full consensus). With
    weight_dtype, the pair weights are rounded to it before they vote."""
    if not o["full_consensus"] or o["rescue"]:
        raise NotImplementedError("the reference corrects with -f 1 -r 0 only")
    read = lambda r: vol.host[vol.offsets[r]:vol.offsets[r + 1]]
    D, W = o["max_delta"], o["band_width"]
    records, tpls = [], []
    for tid in tids:
        t = _Template(int(tid), read(int(tid)), S.template_rows(vol, int(tid), mo), o)
        if len(t.cands) < o["min_cov"]:
            records.append(_record(t, False, t.seq))
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
        a_list, b_list = [], []
        for t, c in pairs:
            q = read(c["qid"])
            q = _rc(q) if c["qdir"] == 1 else q
            aq, at = c["qbeg"], c["sbeg"]
            a_list += [q[:aq][::-1], q[aq:]]
            b_list += [t.seq[:at][::-1], t.seq[at:]]
        lanes = X.extend_lanes(a_list, b_list, W, device)
        L, R = slice(0, None, 2), slice(1, None, 2)
        aq = np.array([c["qbeg"] for _, c in pairs])
        at = np.array([c["sbeg"] for _, c in pairs])
        ql, qr = aq - lanes.q[L], aq + lanes.q[R]
        tl, tr = at - lanes.jc[L], at + lanes.jc[R]
        n_cols = lanes.n_cols[L] + lanes.n_cols[R]
        n_match = lanes.n_match[L] + lanes.n_match[R]
        ident = np.where(n_cols > 0, _f32(100.0) * n_match.astype(np.float32)
                         / np.maximum(n_cols, 1).astype(np.float32), _f32(0.0)).astype(np.float32)
        qs = np.array([c["qsize"] for _, c in pairs])
        ts = np.array([t.n for t, _ in pairs])
        ok_align = n_cols >= o["min_align_size"]
        owner = np.array([id(t) for t, _ in pairs])
        if round_id == 0:
            good = _good_overlap(ql, qr, qs, tl, tr, ts, o["good_end_margin"]) & ok_align
            span = (((qr - ql) >= _f32(0.6) * qs.astype(np.float32))
                    | ((tr - tl) >= _f32(0.6) * ts.astype(np.float32))) & ok_align
            for t in tpls:
                m = owner == id(t)
                if m.any():
                    t.cutoff = ident_cutoff(ident[m], good[m], span[m], o["n_ident"])
        cut = np.array([t.cutoff for t, _ in pairs], np.float32)
        pass_ident = ident >= cut
        if round_id > 0:
            pass_ident |= _full_cov(ql, qr, qs, tl, tr, ts)
        ok = ok_align & pass_ident & _mapping_range(ql, qr, qs, tl, tr, ts,
                                                     o["min_align_size"], o["mapping_ratio"])
        w = cns_weight(ident)
        if weight_dtype is not None:
            w = torch.from_numpy(w).to(weight_dtype).float().numpy()
        for p in np.flatnonzero(ok):
            t = pairs[p][0]
            t.cov[min(max(tl[p], 0), t.n):min(max(tr[p], 0), t.n)] += 1
            _scatter(t, lanes, 2 * p, int(at[p]), float(w[p]), True, D)
            _scatter(t, lanes, 2 * p + 1, int(at[p]), float(w[p]), False, D)
        round_id += 1
    for t in tpls:
        records.append(_record(t, *_call(t, o)))
    return records


def _record(t: _Template, corrected: bool, seq: np.ndarray):
    return types.SimpleNamespace(tid=t.tid, left=0, right=t.n, org_size=t.n, seq=seq,
                                 corrected=corrected)
