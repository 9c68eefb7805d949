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
correction run on an H100. Each listing is a device-to-host sync, timed as
cns.scatter_sync: eight a chunk.

scatter_pass_cols is the counterpart of the JAX package's scatter formulation
of the same tags (tags.py:447), which its legacy two-program correction runs:
the inserted bases come from the gathered query rows (qbatch) instead of the
insb words, located on the query axis by a running maximum.
"""

from __future__ import annotations

import torch

from necat_tpu_torch.align.banded_kernels import N_INSB, OP_DEL, OP_DIAG, OP_PAD
from necat_tpu_torch.utils.logging import timed

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
    with timed("cns.scatter_sync"):
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
    with timed("cns.scatter_sync"):
        p1, c1 = ok_i.nonzero(as_tuple=True)
    with timed("cns.scatter_sync"):
        e, dm = (k[p1, c1, None] > torch.arange(nd, device=dev)).nonzero(as_tuple=True)
    p, c = p1[e], c1[e]
    word, dl = torch.div(dm, N_INSB, rounding_mode="floor"), dm % N_INSB
    bits = torch.stack(insb)[word, p, c]
    sh0 = 14 if reversed_part else 0
    add(p, dm + 1, ((bits >> (sh0 + 2 * dl)) & 3).long(), t_ins[p, c])

    # leading insertions (before column 1) at t = at - 1, from leadb
    tl = at.long() - 1
    okl = row_ok[:, 0] & (tl >= 0) & (tl < tsize) & (jc > 0)
    with timed("cns.scatter_sync"):
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


def pad_cols_to(x, Lt: int, fill: int):
    """A per-column array's second dim made Lt: sliced when longer, padded
    with `fill` when shorter (necat_tpu/consensus/tags.py:434)."""
    P, MC = x.shape
    if MC == Lt:
        return x
    if MC > Lt:
        return x[:, :Lt]
    return torch.cat([x, x.new_full((P, Lt - MC), fill)], dim=1)


def scatter_pass_cols(weights, coverage, cols, lead, jc, qbatch, aq, at, pair_row,
                      pair_w, tsize, reversed_part: bool) -> None:
    """Scatter one extension pass's tags from its per-column encoding and the
    gathered query rows qbatch u8[P, LQ] into weights [TB+1, D, 5, Lt] and
    coverage i32[TB+1, Lt], IN PLACE (necat_tpu/consensus/tags.py:447).
    aq: each pair's query anchor (a column of qbatch), at its template
    anchor; pair_row == TB (or < 0) drops a pair.

    Two passes:
    * target axis [P, MC]: the delta-0 tag of every consumer column (query
      base for DIAG, gap for DEL) and the coverage count;
    * query axis [P, LQ]: every inserted query base. Each consuming
      column's run start is written at its first query position
      (scatter_reduce_ amax) and carried right by torch.cummax, so that a
      query position knows its column j, the column's start qstart and its
      cumulative consumption CQ, from which delta follows: forward qp -
      qstart (+1 after a DEL), reversed CQ - qp (the reversal flips the
      order of a run)."""
    TBp1, D, _, Lt = weights.shape
    TB = TBp1 - 1
    P, MC = cols.shape
    LQ = qbatch.shape[1]
    dev = cols.device
    wflat = weights.view(-1)
    w = pair_w.to(weights.dtype)
    row = pair_row.long()
    row_ok = ((row >= 0) & (row < TB))[:, None]
    tsz = tsize.long()[:, None]
    at_, aq_, lead_, jc_ = (x.long() for x in (at, aq, lead, jc))
    cols = cols.long()
    op = cols & 3
    k = cols >> 5
    j = torch.arange(1, MC + 1, device=dev)[None, :]
    notpad = op != OP_PAD
    isdiag = (op == OP_DIAG) & notpad
    isdel = (op == OP_DEL) & notpad
    CQ = lead_[:, None] + torch.cumsum(isdiag.long() + torch.where(notpad, k, 0), dim=1)
    # the query consumed up to the clip (insertions of column jc and later
    # columns excluded)
    selj = (jc_ - 1).clamp(0, MC - 1)[:, None]
    qcons = torch.where(jc_ > 0, (CQ.gather(1, selj) - k.gather(1, selj))[:, 0], 0)

    # target axis: delta-0 tags + coverage
    qidx_diag = CQ - k - 1
    if not reversed_part:
        t_pos, q_abs = at_[:, None] + j - 1, aq_[:, None] + qidx_diag
    else:
        t_pos, q_abs = at_[:, None] - j, aq_[:, None] - 1 - qidx_diag
    ok0 = (notpad & (j <= jc_[:, None]) & (t_pos >= 0) & (t_pos < tsz) & (t_pos < Lt)
           & row_ok)
    p0, c0 = ok0.nonzero(as_tuple=True)
    t0 = t_pos[p0, c0]
    qb = qbatch[p0, q_abs[p0, c0].clamp(0, LQ - 1)].long()
    base = torch.where(isdel[p0, c0], GAP_CODE, qb)
    wflat.index_add_(0, (row[p0] * D * 5 + base) * Lt + t0, w[p0])
    coverage.view(-1).index_add_(0, row[p0] * Lt + t0,
                                 torch.ones_like(t0, dtype=coverage.dtype))

    # query axis: insertion tags (delta >= 1). A column's run starts at its
    # own query position (DIAG) or its first inserted one (DEL); columns
    # that consume no query write nothing
    qstart = CQ - k - isdiag.long()
    pc, cc = (notpad & ((k > 0) | isdiag)).nonzero(as_tuple=True)
    lin = pc * LQ + qstart[pc, cc].clamp(0, LQ - 1)

    def run_max(vals):
        buf = torch.full((P * LQ,), -1, dtype=torch.long, device=dev)
        return buf.scatter_reduce_(0, lin, vals[pc, cc], reduce="amax").view(P, LQ)

    m_flag = run_max((j << 1) | isdiag.long())
    m_qst = run_max(qstart)
    m_cq = run_max(CQ)
    # virtual column 0: the leading insertions (qstart 0, j 0, CQ lead)
    qp = torch.arange(LQ, device=dev)[None, :]
    virt = (qp == 0) & (lead_ > 0)[:, None] & (m_qst != 0)
    m_flag = torch.where(virt, 0, m_flag)
    m_cq = torch.where(virt, lead_[:, None], m_cq)
    m_qst = torch.where(virt, 0, m_qst)
    c_flag, c_qst, c_cq = (torch.cummax(x, dim=1).values for x in (m_flag, m_qst, m_cq))
    j_of = c_flag >> 1
    diag_of = (c_flag & 1) == 1
    if not reversed_part:
        delta = qp - c_qst + torch.where(diag_of, 0, 1)
        t_ins, q_abs_i = at_[:, None] + j_of - 1, aq_[:, None] + qp
    else:
        delta = c_cq - qp
        t_ins, q_abs_i = at_[:, None] - j_of - 1, aq_[:, None] - 1 - qp
    okq = (c_flag >= 0) & (qp < qcons[:, None]) & (delta >= 1) & (delta < D)
    if reversed_part:
        # a DIAG column's own query position is its delta-0 tag (scattered
        # above); the reversed formula would give it delta k + 1
        okq &= ~(diag_of & (qp == c_qst))
    okq &= (t_ins >= 0) & (t_ins < tsz) & (t_ins < Lt) & row_ok
    pq, cq = okq.nonzero(as_tuple=True)
    qb_i = qbatch[pq, q_abs_i[pq, cq].clamp(0, LQ - 1)].long()
    wflat.index_add_(0, ((row[pq] * D + delta[pq, cq]) * 5 + qb_i) * Lt + t_ins[pq, cq],
                     w[pq])
