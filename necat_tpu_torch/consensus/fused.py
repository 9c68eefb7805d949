"""Correction chunks: gather -> extend -> accept -> scatter on the device.

Counterpart of necat_tpu/consensus/fused.py. One chunk runs the row gather,
the banded extension, the acceptance test (identity cutoff / mapping range /
full-coverage exception) and the weighted tag scatter into the bucket's
consensus tensors, and returns a small int32 stats array. The adaptive
identity cutoff (error_estimate.c:32-64) is kept on the device too: a round-0
identity pass writes per-template (ident, good, span) triples into a small
buffer that cutoff_from_idents reduces.

The long-indel rescue (cns_extension cascade, consensus_aux.c:152-213) works
by deferral: with `rescue_defer`, lanes whose extension leaves > 200 bp of
the candidate's query range unaligned scatter nothing and raise the
`deferred` stats flag; correct_reads re-dispatches them at a wider band with
`cols_guard` (a lane counts only if the wide result aligns at least the
columns of its best earlier rung, `nc0`), and replays the lanes still
deferred at their best band.

Acceptance mirrors consensus_one_read.c:215-392 + consensus_aux.c:93-122.
Where the JAX package donates the consensus tensors and the ident buffer to
its programs, these functions update the same tensors in place.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from necat_tpu_torch.align.banded import TAIL_MATCH
from necat_tpu_torch.align.engine import DESC_COLS, count_live_cols, gather_extend
from necat_tpu_torch.consensus.tags import scatter_chunk
from necat_tpu_torch.utils.logging import count_lanes, sync_dispatch, timed

# extra desc columns after the 9 DESC_COLS (engine.plan extra_cols)
#   row    — template row within its bucket (TB = dead lane)
#   tsfull — full template length (the other lengths are window lengths)
#   ws     — window start on the template (absolute)
#   slot   — round-0 ident-buffer slot (sequential per template)
#   qe     — candidate query end (the rescue hang check)
#   nc0    — best earlier column count (the rescue cols_guard)
FUSED_EXTRA = ("row", "tsfull", "ws", "slot", "qe", "nc0")
_C = {k: i for i, k in enumerate(DESC_COLS + FUSED_EXTRA)}

IDENT_SLOTS = 32        # round-0 ident buffer slots per template (>= n_ident+10)

# pairs dispatch_wave (or the legacy flow of correct.py) extended at each band
# width W; the correct stage clears it before each iteration and records it
# after
pairs_by_band: Counter = Counter()

_BUF_KEYS = ("left_cols", "left_insb", "left_lead", "left_leadb", "left_jc",
             "right_cols", "right_insb", "right_lead", "right_leadb",
             "right_jc")


# ------------------------------------------------------------- predicates
# Pure arithmetic on numpy arrays and torch tensors alike.

def is_good_overlap(ql, qr, qs, tl, tr, ts, margin=200):
    """error_estimate.c:7-30 — overlap ends near sequence ends on paired sides."""
    qlh, qrh, tlh, trh = ql, qs - qr, tl, ts - tr
    m = margin
    return ((qlh <= m) & (qrh <= m)) | ((tlh <= m) & (trh <= m)) | \
           ((qrh <= m) & (tlh <= m)) | ((trh <= m) & (qlh <= m))


def check_mapping_range(ql, qr, qs, tl, tr, ts, min_size, ratio):
    """consensus_aux.c:115-122."""
    return ((qr - ql) >= min_size) | ((tr - tl) >= min_size) | \
           ((qr - ql) >= qs * ratio) | ((tr - tl) >= ts * ratio)


def is_full_cov_ovlp(ql, qr, qs, tl, tr, ts, ovlp_size, tail):
    """consensus_aux.c:93-112 — query or template nearly fully covered."""
    r = ((ql <= tail) & (qs - qr <= tail)) | ((tl <= tail) & (ts - tr <= tail))
    r |= (qs - qr <= tail) & (tl <= tail) & ((qr - ql) >= ovlp_size)
    r |= (ts - tr <= tail) & (ql <= tail) & ((qr - ql) >= ovlp_size)
    return r


def calc_cns_weight(ident_perc):
    """Per-overlap consensus weight (consensus_one_read.c:11-16), f32."""
    e = (100.0 - ident_perc) / 100.0 / 2.0
    w = (1.0 - e) * (1.0 - e) + e * e / 3.0
    return torch.where(100.0 - ident_perc <= 1e-6, 1.0, w).to(torch.float32)


# ------------------------------------------------------------- chunk steps

def _extend(qdev, sdev, desc, W, L, tail_match, insb_words):
    c = {k: desc[:, i] for k, i in _C.items()}
    return c, gather_extend(qdev, sdev, desc, W, L, tail_match, insb_words)


def _chunk_bufs(out) -> dict:
    """The per-column buffers the tag scatter reads, insb words as tuples."""
    bufs = {k: out[k] for k in _BUF_KEYS}
    for side in ("left", "right"):
        words = [out[f"{side}_insb"]]
        while f"{side}_insb{len(words) + 1}" in out:
            words.append(out[f"{side}_insb{len(words) + 1}"])
        bufs[f"{side}_insb"] = tuple(words)
    return bufs


def _accept_and_scatter(c, stats6, ident, cutoff, weights, coverage, bufs,
                        min_align_size, mapping_ratio, allow_fullcov,
                        deferred=None):
    """Acceptance of one chunk + tag scatter of its accepted lanes (deferred
    lanes are not accepted); returns the stats int32[8, PB] = qoff, qend,
    toff, tend (window), n_cols, n_match, accepted, deferred."""
    if deferred is None:
        deferred = torch.zeros_like(stats6[0], dtype=torch.bool)
    TB = weights.shape[0] - 1
    ql, qr = stats6[0], stats6[1]
    tl = stats6[2] + c["ws"]
    tr = stats6[3] + c["ws"]
    qs, ts = c["qlen"], c["tsfull"]
    ok = stats6[4] >= min_align_size
    ok &= check_mapping_range(ql, qr, qs, tl, tr, ts, min_align_size,
                              mapping_ratio)
    pass_ident = ident >= cutoff[c["row"].clamp(0, TB).long()]
    if allow_fullcov:
        pass_ident |= is_full_cov_ovlp(ql, qr, qs, tl, tr, ts, 5000, 100)
    ok &= pass_ident
    ok &= (c["row"] >= 0) & (c["row"] < TB)
    ok &= ~deferred
    w = torch.where(ok, calc_cns_weight(ident), 0.0)
    row_eff = torch.where(ok, c["row"], TB)
    with timed("cns.tag_scatter"):
        scatter_chunk(weights, coverage,
                      bufs["left_cols"], bufs["left_insb"], bufs["left_lead"],
                      bufs["left_leadb"], bufs["left_jc"],
                      bufs["right_cols"], bufs["right_insb"], bufs["right_lead"],
                      bufs["right_leadb"], bufs["right_jc"],
                      c["at"] + c["ws"], row_eff, w, ts)
    return torch.cat([stats6, ok.to(torch.int32)[None],
                      deferred.to(torch.int32)[None]], dim=0)


def extend_scatter(qdev, sdev, desc, cutoff, weights, coverage, *,
                   min_align_size: int, mapping_ratio: float,
                   allow_fullcov: bool, W: int, L: int,
                   rescue_defer: bool = False, cols_guard: bool = False,
                   tail_match: int = TAIL_MATCH, insb_words: int = 1):
    """One correction chunk: extend, accept against the device cutoffs
    f32[TB+1], scatter into weights/coverage in place. desc: int32[PB, 15]
    (DESC_COLS + FUSED_EXTRA) on the device. Returns stats int32[8, PB];
    deferred lanes (see the module docstring) scatter nothing."""
    c, out = _extend(qdev, sdev, desc, W, L, tail_match, insb_words)
    ql, qr, n_cols = out["qoff"], out["qend"], out["n_cols"]
    hang = (ql - c["aq"]).clamp(min=0) + (c["qe"] - qr).clamp(min=0)
    live = c["row"] >= 0
    deferred = (rescue_defer & (hang > 200) & live) \
        | (cols_guard & (n_cols < c["nc0"]) & live)
    return _accept_and_scatter(c, out["stats"], out["ident"], cutoff, weights,
                               coverage, _chunk_bufs(out), min_align_size,
                               mapping_ratio, allow_fullcov, deferred)


def ident_pass(qdev, sdev, desc, ibuf, *, min_align_size: int,
               good_end_margin: int, W: int, L: int, cols_guard: bool = False,
               tail_match: int = TAIL_MATCH):
    """Round-0 identity estimation: extend and write per-template (ident,
    good, span) into ibuf f32[TB+1, IDENT_SLOTS, 3] at (row, slot), in place.
    With cols_guard a lane writes its slot only when it aligned at least nc0
    columns (a rescue rung keeps the better earlier entry). Returns (stats
    int32[6, PB], the chunk's per-column buffers), which accept_scatter
    consumes once the cutoffs are known."""
    c, out = _extend(qdev, sdev, desc, W, L, tail_match, 1)
    TBp1, S, _ = ibuf.shape
    ql, qr = out["qoff"], out["qend"]
    tl = out["toff"] + c["ws"]
    tr = out["tend"] + c["ws"]
    qs, ts = c["qlen"], c["tsfull"]
    ok_align = out["n_cols"] >= min_align_size
    good = is_good_overlap(ql, qr, qs, tl, tr, ts, good_end_margin) & ok_align
    span = (((qr - ql) >= 0.6 * qs) | ((tr - tl) >= 0.6 * ts)) & ok_align
    valid = (c["row"] >= 0) & (c["row"] < TBp1 - 1) & (c["slot"] >= 0) \
        & (c["slot"] < S)
    if cols_guard:
        valid &= out["n_cols"] >= c["nc0"]
    # invalid lanes all write zeros to the trash entry (TB, S-1)
    row = torch.where(valid, c["row"], TBp1 - 1).long()
    slot = torch.where(valid, c["slot"], S - 1).long()
    vals = torch.stack([out["ident"], good.float(), span.float()], dim=1)
    ibuf[row, slot] = torch.where(valid[:, None], vals, 0.0)
    return out["stats"], _chunk_bufs(out)


def accept_scatter(desc, stats6, cutoff, weights, coverage, bufs, *,
                   min_align_size: int, mapping_ratio: float):
    """Round-0 acceptance + tag scatter of an ident_pass chunk's retained
    buffers (no re-extension; the full-coverage exception is off in round
    0, consensus_one_read.c:273-278). Returns stats int32[8, PB]."""
    c = {k: desc[:, i] for k, i in _C.items()}
    n_cols, n_match = stats6[4], stats6[5]
    ident = torch.where(n_cols > 0, 100.0 * n_match / n_cols.clamp(min=1), 0.0)
    return _accept_and_scatter(c, stats6, ident, cutoff, weights, coverage,
                               bufs, min_align_size, mapping_ratio, False)


def cutoff_from_idents(ibuf, *, n_ident: int) -> torch.Tensor:
    """Per-template identity cutoffs f32[TB+1] from the round-0 buffer: the
    first n_ident GOOD overlaps' idents (the first n_ident SPANNING ones when
    good ones are scarce), then mean - 5*stddev over the top 70 % (100 % when
    n < 8), 0 when n < 5 (error_estimate.c:32-64)."""
    ident = ibuf[:, :, 0]
    good = ibuf[:, :, 1] > 0.5
    span = ibuf[:, :, 2] > 0.5
    csum_g = torch.cumsum(good, dim=1)
    csum_s = torch.cumsum(span, dim=1)
    sel_g = good & (csum_g <= n_ident)
    sel_s = span & (csum_s <= n_ident)
    use_span = csum_g[:, -1].clamp(max=n_ident) < n_ident
    sel = torch.where(use_span[:, None], sel_s, sel_g)
    vals = torch.where(sel, ident, -torch.inf)
    vals = torch.sort(vals, dim=1, descending=True).values
    n = sel.sum(dim=1)
    n_use = torch.where(n >= 8, torch.div(n * 7, 10, rounding_mode="floor"), n)
    m = torch.arange(vals.shape[1], device=ibuf.device)[None, :] < n_use[:, None]
    nu = n_use.clamp(min=1).to(torch.float32)
    mean = torch.where(m, vals, 0.0).sum(dim=1) / nu
    # two-pass (shifted) variance: E[x^2] - mean^2 near ident ~100 loses
    # about 7 decimal digits to cancellation in f32
    dv = torch.where(m, vals - mean[:, None], 0.0)
    std = ((dv * dv).sum(dim=1) / nu).clamp(min=0.0).sqrt()
    return torch.where(n >= 5, mean - 5.0 * std, 0.0).to(torch.float32)


# ------------------------------------------------------------- host driver

class FusedChunk:
    """One dispatched chunk: its stats (device), pair indices and window
    starts; ident-pass chunks also keep their desc and per-column buffers
    until scatter_round0 consumes them."""

    __slots__ = ("stats_dev", "sel", "n_real", "ws", "group", "bufs", "desc_dev")

    def __init__(self, stats_dev, sel, n_real, ws, group, bufs=None, desc_dev=None):
        self.stats_dev = stats_dev
        self.sel = sel
        self.n_real = n_real
        self.ws = ws
        self.group = group
        self.bufs = bufs
        self.desc_dev = desc_dev


def dispatch_wave(engines, *, qids, qdir, qsize, tg_base, tsize_full, aq,
                  at_abs, rows, groups, cutoffs: dict, tensors: dict,
                  W: int, insb_words: int, min_align_size: int,
                  mapping_ratio: float, allow_fullcov: bool,
                  slots=None, ibufs: dict | None = None,
                  qend_cand=None, nc0=None,
                  rescue_defer: bool = False, cols_guard: bool = False,
                  good_end_margin: int = 200,
                  tail_match: int = TAIL_MATCH):
    """Run one wave of pairs as chunks of `engines`, a list of ExtendEngines,
    one per device: the chunks of group (bucket) g run on engines[g mod
    len(engines)], where that bucket's tensors live
    (necat_tpu/consensus/fused.py:313-345).

    cutoffs: group -> f32[TB+1] device cutoffs; tensors: group -> (weights,
    coverage), updated in place. With ibufs (round 0) only the ident pass
    runs, writing ibufs[group] in place; `slots` (sequential per-template
    ident slots) is then required. qend_cand (candidate query ends) feeds
    the rescue_defer hang check, nc0 (best earlier column counts) the
    cols_guard. Returns the list of FusedChunk."""
    npairs = len(qids)
    pairs_by_band[W] += npairs
    if ibufs is not None and slots is None:
        raise ValueError("dispatch_wave(ibufs=...) requires per-pair slots")
    zeros = np.zeros(npairs, np.int64)
    extra = dict(row=rows, tsfull=tsize_full, ws=zeros,
                 slot=(slots if slots is not None else zeros),
                 qe=(qend_cand if qend_cand is not None else zeros),
                 nc0=(nc0 if nc0 is not None else zeros))
    planned = engines[0].plan(qids, qdir, qsize, tg_base, tsize_full, aq, at_abs, W,
                          groups=groups, extra_cols=extra)
    chunks = []
    for p in planned:
        desc = p["desc"]
        desc[:p["n_real"], _C["ws"]] = p["ws"]     # this chunk's window starts
        g = p["group"]
        eng = engines[g % len(engines)]
        with timed("cns.fused_dispatch"):
            with timed("cns.fused_desc_up"):
                desc_dev = torch.from_numpy(desc).to(eng.device)
            bufs = None
            with timed("cns.fused_call"):
                if ibufs is not None:
                    stats, bufs = ident_pass(
                        eng.qdev, eng.sdev, desc_dev, ibufs[g],
                        min_align_size=min_align_size, good_end_margin=good_end_margin,
                        W=W, L=p["L"], cols_guard=cols_guard, tail_match=tail_match)
                else:
                    wts, cov = tensors[g]
                    stats = extend_scatter(
                        eng.qdev, eng.sdev, desc_dev, cutoffs[g], wts, cov,
                        min_align_size=min_align_size, mapping_ratio=mapping_ratio,
                        allow_fullcov=allow_fullcov, W=W, L=p["L"],
                        rescue_defer=rescue_defer, cols_guard=cols_guard,
                        tail_match=tail_match, insb_words=insb_words)
            sync_dispatch(f"cns.fused_exec_L{p['L']}_PB{p['PB']}", eng.device)
        count_lanes(p["PB"], p["n_real"], p["L"])
        count_live_cols(desc, p["n_real"])
        chunks.append(FusedChunk(stats, p["take"], p["n_real"], p["ws"], g,
                                 bufs=bufs, desc_dev=desc_dev))
    return chunks


def scatter_round0(chunks, cutoffs: dict, tensors: dict, min_align_size: int,
                   mapping_ratio: float) -> None:
    """Scatter round-0 ident chunks from their retained buffers once the
    device cutoffs exist; replaces each chunk's stats with the 8-row form."""
    for ch in chunks:
        wts, cov = tensors[ch.group]
        with timed("cns.fused_dispatch"), timed("cns.fused_call"):
            ch.stats_dev = accept_scatter(
                ch.desc_dev, ch.stats_dev, cutoffs[ch.group], wts, cov, ch.bufs,
                min_align_size=min_align_size, mapping_ratio=mapping_ratio)
        ch.bufs = None
        ch.desc_dev = None


def release_bufs(chunks) -> None:
    """Drop ident chunks' retained buffers (the rescue path re-extends
    instead of scattering them)."""
    for ch in chunks:
        ch.bufs = None
        ch.desc_dev = None


def new_fused_stats(n_pairs: int) -> dict:
    out = {k: np.zeros(n_pairs, np.int64)
           for k in ("qoff", "qend", "toff", "tend", "n_cols")}
    out["ident"] = np.zeros(n_pairs, np.float64)
    out["ok"] = np.zeros(n_pairs, bool)
    out["deferred"] = np.zeros(n_pairs, bool)
    return out


def collect_fused(chunks, stats: dict, sel=None) -> None:
    """Merge chunk stats into flat per-pair host arrays (one device sync per
    chunk; toff/tend converted to absolute template coordinates). `sel` maps
    the chunks' pair ids into the caller's (a rescue subset's pairs)."""
    for ch in chunks:
        with timed("ext.stats_sync"):
            st = ch.stats_dev.cpu().numpy()
        r = slice(0, ch.n_real)
        idx = ch.sel if sel is None else np.asarray(sel)[ch.sel]
        stats["qoff"][idx] = st[0, r]
        stats["qend"][idx] = st[1, r]
        stats["toff"][idx] = st[2, r] + ch.ws
        stats["tend"][idx] = st[3, r] + ch.ws
        stats["n_cols"][idx] = st[4, r]
        stats["ident"][idx] = np.where(
            st[4, r] > 0, 100.0 * st[5, r] / np.maximum(st[4, r], 1), 0.0)
        if st.shape[0] > 6:          # ident-pass chunks carry only 6 rows
            stats["ok"][idx] = st[6, r].astype(bool)
            stats["deferred"][idx] = st[7, r].astype(bool)
