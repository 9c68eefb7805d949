"""Weighted tag scatter of one extension chunk into the consensus tensors.

Counterpart of necat_tpu/consensus/tags.py:scatter_chunk_mm (and its
scatter_pass_cols_mm): the same tags land in the same cells of

    weights[template_row, delta, base, t]   (base 4 = gap)
    coverage[template_row, t]               (delta-0 columns)

from the per-column encodings of both extension passes. The JAX package sums
over pairs with a one-hot matrix product for the TPU's matrix unit; here each
tag plane is one index_add_ on flat indices, computed in the column domain
(column j of the forward pass sits at t = at + j - 1, of the reversed pass at
t = at - j). Each plane's landing tags are listed first (nonzero), so the
additions, atomics on the card, touch only real cells: adding every masked
cell as a 0 to the trash row cost three quarters of the device time of a
correction run on an H100.
"""

from __future__ import annotations

import torch

from necat_tpu_torch.align.banded_kernels import N_INSB, OP_DEL, OP_PAD

GAP_CODE = 4


def _scatter_pass(weights, coverage, cols, insb, lead, leadb, jc, at, pair_row,
                  pair_w, tsize, reversed_part: bool) -> None:
    TBp1, D, _, Lt = weights.shape
    TB = TBp1 - 1
    P, MC = cols.shape
    dev = cols.device
    wflat = weights.view(-1)
    w = pair_w.to(weights.dtype)
    row = pair_row.long()
    tsize = tsize.long()
    j = torch.arange(1, MC + 1, device=dev)[None, :]
    at_ = at.long()[:, None]
    t = (at_ - j) if reversed_part else (at_ + j - 1)
    row_ok = ((pair_row >= 0) & (pair_row < TB))[:, None]

    def add(p, d, base, tpos):
        """weights[row_p, d, base, tpos] += w_p for each listed entry."""
        wflat.index_add_(0, ((row[p] * D + d) * 5 + base) * Lt + tpos, w[p])

    # delta-0 tag of every consumer column (query base for DIAG, gap for DEL)
    op = cols & 3
    ok0 = (row_ok & (t >= 0) & (t < tsize[:, None]) & (t < Lt)
           & (j <= jc[:, None]) & (op != OP_PAD))
    p0, c0 = ok0.nonzero(as_tuple=True)
    t0 = t[p0, c0]
    v0 = cols[p0, c0]
    base0 = torch.where((v0 & 3) == OP_DEL, GAP_CODE, (v0 >> 3) & 3).long()
    add(p0, 0, base0, t0)
    coverage.view(-1).index_add_(0, row[p0] * Lt + t0,
                                 torch.ones_like(t0, dtype=coverage.dtype))

    # insertions after column j (j < jc): forward runs sit at the column's
    # own t with their first bases (insb bits 2(d-1)); reversed runs sit one
    # position further left with their last bases (bits 14 + 2(d-1))
    nd = min(D - 1, N_INSB * len(insb))
    t_ins = t - 1 if reversed_part else t
    k = torch.where(op != OP_PAD, cols >> 5, 0)
    ok_i = (row_ok & (t_ins >= 0) & (t_ins < tsize[:, None]) & (t_ins < Lt)
            & (j <= jc[:, None] - 1) & (k > 0))
    p1, c1 = ok_i.nonzero(as_tuple=True)
    e, dm = (k[p1, c1, None] > torch.arange(nd, device=dev)).nonzero(as_tuple=True)
    p, c = p1[e], c1[e]
    word, dl = torch.div(dm, N_INSB, rounding_mode="floor"), dm % N_INSB
    bits = torch.stack(insb)[word, p, c]
    sh0 = 14 if reversed_part else 0
    add(p, dm + 1, ((bits >> (sh0 + 2 * dl)) & 3).long(), t_ins[p, c])

    # leading insertions (before column 1) at t = at - 1, from leadb
    tl = at.long() - 1
    okl = row_ok[:, 0] & (tl >= 0) & (tl < tsize) & (jc > 0)
    pl, dm = ((lead[:, None] > torch.arange(nd, device=dev)) & okl[:, None]
              ).nonzero(as_tuple=True)
    add(pl, dm + 1, leadb[pl, dm].long(), tl[pl])


def scatter_chunk(weights, coverage,
                  left_cols, left_insb, left_lead, left_leadb, left_jc,
                  right_cols, right_insb, right_lead, right_leadb, right_jc,
                  at, pair_row, pair_w, tsize) -> None:
    """Scatter both extension passes of one chunk into weights
    [TB+1, D, 5, Lt] and coverage i32[TB+1, Lt] IN PLACE (the JAX package
    donates both). left_insb/right_insb: tuples of insb words. pair_row == TB
    (or < 0) drops a pair. weights may hold any float dtype; correct_reads
    accumulates in float64, where these sums are exact and so independent of
    the order of the additions."""
    _scatter_pass(weights, coverage, right_cols, right_insb, right_lead,
                  right_leadb, right_jc, at, pair_row, pair_w, tsize,
                  reversed_part=False)
    _scatter_pass(weights, coverage, left_cols, left_insb, left_lead,
                  left_leadb, left_jc, at, pair_row, pair_w, tsize,
                  reversed_part=True)
