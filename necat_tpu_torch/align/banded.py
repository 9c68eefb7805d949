"""Batched banded alignment extension from anchors.

Counterpart of necat_tpu/align/banded.py:_extend_batch_jit. Each pair
extends left over the reversed prefixes and right over the suffixes of its
anchors, and each side is clipped back to the last run of TAIL_MATCH matched
columns (oc_aligner.c:223-259 retreat logic). Two bands, as in the JAX
package:
  - the static band (its Pallas branch, the default): the K1 -> K3 kernels
    of banded_kernels (K1 computes the mismatch encoding itself);
  - the adaptive band (its scan branch, under NECAT_TPU_NO_PALLAS, read at
    each call): K1a -> K3a, the band moving toward the argmin third of each
    column.
Each kernel runs its plain version for CPU tensors.
"""

from __future__ import annotations

import os

import torch

from necat_tpu_torch.align import banded_kernels as bk
from necat_tpu_torch.align.banded_kernels import N_INSB, OP_DIAG, OP_PAD

TAIL_MATCH = 8   # kOcaMatCnt (oc_aligner.c:9)


def adaptive_band() -> bool:
    """True under NECAT_TPU_NO_PALLAS: the JAX package's variable, read at
    each call as its _use_pallas reads it, so that one environment runs one
    band in both packages."""
    return bool(os.environ.get("NECAT_TPU_NO_PALLAS"))


def _gather_shifted(batch, src) -> torch.Tensor:
    L = batch.shape[1]
    ok = (src >= 0) & (src < L)
    return torch.where(ok, batch.gather(1, src.clamp(0, L - 1)), 0)


def gather_rev_prefix(batch, anchor) -> torch.Tensor:
    """out[p, t] = batch[p, anchor_p - 1 - t], zero outside the row."""
    t = torch.arange(batch.shape[1], device=batch.device)[None, :]
    return _gather_shifted(batch, anchor[:, None].long() - 1 - t)


def gather_suffix(batch, anchor) -> torch.Tensor:
    """out[p, t] = batch[p, anchor_p + t], zero outside the row."""
    t = torch.arange(batch.shape[1], device=batch.device)[None, :]
    return _gather_shifted(batch, anchor[:, None].long() + t)


def cols_clip_stats(cols, lead, tail_match: int = TAIL_MATCH) -> dict:
    """Tail clip + alignment stats in the per-column domain (counterpart of
    necat_tpu/align/banded.py:cols_clip_stats). Returns dict(jc, q, t,
    n_match, n_cols) of int32[B]: jc = clipped target-column count (= t
    consumed), q = query consumed, n_cols = total ops kept."""
    B, MC = cols.shape
    i32 = torch.int32
    op = cols & 3
    k = cols >> 5
    active = op != OP_PAD
    isdiag = op == OP_DIAG
    jcol = torch.arange(1, MC + 1, dtype=i32, device=cols.device)[None, :]
    dq = isdiag.to(i32) + torch.where(active, k, 0)
    CQ = lead[:, None] + torch.cumsum(dq, dim=1, dtype=i32)
    match = isdiag & (((cols >> 2) & 1) == 1)
    kprev = torch.cat([lead[:, None], k[:, :-1]], dim=1)
    # run of matched columns ending at j, with a half-step barrier when the
    # previous column carried insertions (they break the op-string match run)
    e = torch.where(~match, 2 * jcol, torch.where(kprev > 0, 2 * jcol - 1, -1))
    laste = torch.cummax(e, dim=1).values.clamp(min=1)
    run = torch.div(2 * jcol - laste + 1, 2, rounding_mode="floor")
    good = match & (run >= tail_match)
    jc = torch.where(good, jcol, 0).amax(dim=1).to(i32)
    cum_match = torch.cumsum(match, dim=1, dtype=i32)
    cum_cols = torch.cumsum(torch.where(active, 1 + k, 0), dim=1, dtype=i32)
    sel = (jc - 1).clamp(0, MC - 1).long()[:, None]
    g = lambda x: x.gather(1, sel)[:, 0]
    has = jc > 0
    k_jc = torch.where(has, g(k), 0)
    q = torch.where(has, g(CQ) - k_jc, 0).to(i32)
    n_match = torch.where(has, g(cum_match), 0).to(i32)
    n_cols = torch.where(has, lead + g(cum_cols) - k_jc, 0).to(i32)
    return dict(jc=jc, q=q, t=jc, n_match=n_match, n_cols=n_cols)


def extend_batch(qbatch, qlens, tbatch, tlens, anchor_q, anchor_t,
                 W: int = 128, tail_match: int = TAIL_MATCH,
                 insb_words: int = 1) -> dict:
    """Extend alignments outward from anchors for a batch of pairs.

    qbatch u8[B, LQ] (query on its candidate strand), tbatch u8[B, LT],
    lengths and anchors i32[B], all on one device. Returns the fields of
    necat_tpu's extend_batch: per side (left/right) cols, insb, lead, leadb,
    jc; qoff/qend/toff/tend, n_cols, n_match, ident (f32 percent) and the
    packed stats i32[6, B] = (qoff, qend, toff, tend, n_cols, n_match)."""
    B, LQ = qbatch.shape
    # both sides run as one batch of 2B pairs: left over the reversed
    # prefixes, right over the suffixes
    a = torch.cat([gather_rev_prefix(qbatch, anchor_q),
                   gather_suffix(qbatch, anchor_q)])
    b = torch.cat([gather_rev_prefix(tbatch, anchor_t),
                   gather_suffix(tbatch, anchor_t)])
    la_full = torch.cat([anchor_q, qlens - anchor_q])
    lb_full = torch.cat([anchor_t, tlens - anchor_t])
    # clamp the length mismatch to W/4 so both end points sit near the middle
    # lane of the constant-centre band (in both modes, as the JAX package
    # does); the tail clip removes the pure-indel tails this cuts (see
    # necat_tpu/align/banded.py)
    la = torch.minimum(la_full, lb_full + W // 4).to(torch.int32)
    lb = torch.minimum(lb_full, la_full + W // 4).to(torch.int32)
    if adaptive_band():
        dirs, offs, _, _ = bk.banded_forward_adaptive(a, b, la, lb, W)
        cols, insb, lead = bk.adaptive_backtrack_cols(dirs, offs, a, b, la, lb, W,
                                                      insb_words)
        del offs
    else:
        dirs, _ = bk.banded_forward(a, b, la, lb, W)
        cols, insb, lead = bk.banded_backtrack_cols(dirs, la, lb, W, insb_words)
    del dirs
    out = {}
    for side, rows in (("left", slice(0, B)), ("right", slice(B, 2 * B))):
        st = cols_clip_stats(cols[rows], lead[rows], tail_match)
        # leading-run inserted bases, entry d-1 = base at delta d: right pass
        # a[d-1], left pass a[lead-d] (the tag scatter never gathers the query)
        dl = torch.arange(1, N_INSB * insb_words + 1, device=a.device)[None, :]
        lidx = (dl - 1) if side == "right" else (lead[rows, None] - dl)
        leadb = a[rows].gather(1, lidx.clamp(0, LQ - 1).long().expand(B, -1))
        out[side] = dict(cols=cols[rows], insb=tuple(x[rows] for x in insb),
                         lead=lead[rows], leadb=leadb, **st)

    L_, R_ = out["left"], out["right"]
    qoff = anchor_q - L_["q"]
    toff = anchor_t - L_["t"]
    qend = anchor_q + R_["q"]
    tend = anchor_t + R_["t"]
    n_cols = L_["n_cols"] + R_["n_cols"]
    n_match = L_["n_match"] + R_["n_match"]
    ident = torch.where(n_cols > 0, 100.0 * n_match / n_cols.clamp(min=1), 0.0)
    res = dict(qoff=qoff, qend=qend, toff=toff, tend=tend, n_cols=n_cols,
               n_match=n_match, ident=ident,
               stats=torch.stack([qoff, qend, toff, tend, n_cols, n_match]).to(torch.int32))
    for side, o in (("left", L_), ("right", R_)):
        for key in ("cols", "lead", "leadb", "jc"):
            res[f"{side}_{key}"] = o[key]
        res[f"{side}_insb"] = o["insb"][0]
        for w in range(1, insb_words):   # extra insertion words
            res[f"{side}_insb{w + 1}"] = o["insb"][w]
    return res
