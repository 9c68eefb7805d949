"""The reference's alignment extension, in plain torch and NumPy.

Written from the semantics of the JAX package's static-band extension
(necat_tpu/align/pallas_banded.py's forward and backtrack, banded.py's
extend_batch, ops_to_cols and cols_clip_stats, after NECAT's oc_aligner):

  * a pair extends from its anchor (aq, at) twice: left over the reversed
    prefixes q[:aq], t[:at] and right over the suffixes q[aq:], t[at:];
    each pass aligns la = min(len a, len b + W/4) query bases against
    lb = min(len b, len a + W/4) target bases, end to end;
  * unit edit costs in a static band of W lanes: lane l of target column j
    is query row j - ctr + l, ctr = W/2 - floor((la - lb) / 2); row 0
    holds j (all deletions); rows outside [0, la] are out of the band;
  * a cell's move is the diagonal where it gives the cell's cost, else an
    insertion (up), else a deletion (left); the path is walked back from
    (la, lb), row 0 always by deletions, column 0 by insertions;
  * each pass is clipped back to the end of its last run of 8 matched
    columns (a run breaks at a mismatch, a deletion or insertions before
    the column); its columns, matches and query bases are counted to there.

One call extends every lane given, a lane being one pass of one pair, and
returns per lane the columns' moves, query rows and insertions, with the
clipped counts.
"""

from __future__ import annotations

import numpy as np
import torch

INF = 1 << 20
DIAG, DEL, INS = 0, 1, 2
TAIL_MATCH = 8
BLOCK = 256


def _forward(A, B, la, lb, W: int, device):
    """Moves of the static-band DP for lanes of query A u8[N, LA] against
    target B u8[N, LB]: dirs u8[N, ncol, W] (0 diag, 1 del, 2 ins, 3 none)
    for target columns 1..ncol, and ctr i64[N]."""
    N = A.shape[0]
    ncol = int(lb.max()) if N else 0
    la_t = torch.from_numpy(la).to(device)[:, None]
    lb_t = torch.from_numpy(lb).to(device)[:, None]
    ctr = W // 2 - torch.div(la_t - lb_t, 2, rounding_mode="floor")
    At = torch.from_numpy(A).to(device).long()
    Bt = torch.from_numpy(B).to(device).long()
    lane = torch.arange(W, device=device)[None, :]
    row0 = lane - ctr
    D = torch.where((row0 >= 0) & (row0 <= la_t), row0, INF)
    dirs = torch.full((N, ncol, W), 3, dtype=torch.uint8, device=device)
    inf_col = torch.full((N, 1), INF, dtype=torch.int64, device=device)
    for lo in range(0, ncol, BLOCK):
        hi = min(lo + BLOCK, ncol)
        j = torch.arange(lo + 1, hi + 1, device=device)[:, None, None]     # [c, 1, 1]
        rows = j - ctr[None] + lane[None]                                    # [c, N, W]
        out = (rows < 0) | (rows > la_t[None])
        qb = At.gather(1, (rows - 1).clamp(0, At.shape[1] - 1).permute(1, 0, 2)
                       .reshape(N, -1)).reshape(N, hi - lo, W).permute(1, 0, 2)
        tb = Bt[:, lo:hi].clamp(max=255).T[:, :, None]                       # [c, N, 1]
        sub = ((qb != tb) | (rows < 1)).long()
        is_row0 = rows == 0
        blk = torch.empty((hi - lo, N, W), dtype=torch.uint8, device=device)
        for c in range(hi - lo):
            diag = D + sub[c]
            left = torch.cat([D[:, 1:], inf_col], 1) + 1
            Acell = torch.minimum(diag, left)
            Acell = torch.where(is_row0[c], lo + c + 1, Acell)
            Acell = torch.where(out[c], INF, Acell)
            Dn = (torch.cummin(Acell - lane, 1).values + lane).clamp(max=INF)
            Dn = torch.where(out[c], INF, Dn)
            up = torch.cat([inf_col, Dn[:, :-1]], 1) + 1
            blk[c] = torch.where(Dn == diag, DIAG, torch.where(
                Dn == up, INS, torch.where(Dn == left, DEL, 3))).to(torch.uint8)
            D = Dn
        dirs[:, lo:hi] = blk.permute(1, 0, 2)
    return dirs, ctr[:, 0]


def _walk(dirs, ctr, la, lb, W: int, device):
    """The path back from (la, lb): per lane and target column j (1-based,
    up to lb) the walk's entry slot and its consumer's slot and move (the
    insertions of the column are the lanes between them), and the lead
    (insertions before column 1). Blocks of columns from the last down: in
    each, every entry slot's consumer is tabulated, then walked."""
    N, ncol, _ = dirs.shape
    la_t = torch.from_numpy(la).to(device)
    lb_t = torch.from_numpy(lb).to(device)
    lane = torch.arange(W, device=device)
    ar = torch.arange(N, device=device)
    entry = torch.zeros((N, ncol), dtype=torch.int64, device=device)
    sel = torch.zeros((N, ncol), dtype=torch.int64, device=device)
    op = torch.zeros((N, ncol), dtype=torch.int64, device=device)
    cur = (la_t - lb_t + ctr).clamp(0, W - 1)
    for hi in range(ncol, 0, -1024):
        lo = max(hi - 1024, 0)
        d = dirs[:, lo:hi]
        s_tab = torch.where(d != INS, lane, -1).cummax(2).values           # consumer slot
        j = torch.arange(lo + 1, hi + 1, device=device)[None, :, None]
        o_tab = d.long().gather(2, s_tab.clamp(min=0))
        o_tab = torch.where(j - ctr[:, None, None] + s_tab <= 0, DEL, o_tab)
        for jj in range(hi, lo, -1):
            c = jj - 1 - lo
            s = s_tab[ar, c, cur]
            o = o_tab[ar, c, cur]
            entry[:, jj - 1] = cur
            sel[:, jj - 1] = s
            op[:, jj - 1] = o
            nxt = torch.where(o == DIAG, s, s + 1).clamp(0, W - 1)
            cur = torch.where(jj <= lb_t, nxt, cur)
        del s_tab, o_tab
    lead = torch.minimum((cur - ctr).clamp(min=0), la_t)
    return entry, sel, op, lead


class Lanes:
    """The result of extending lanes: per lane i, columns 1..lb[i] of its
    path (op 0/1, qrow = query row of the consumer, k = insertions after
    it, in rows qrow+1 .. qrow+k), lead, and the clipped counts jc (target
    columns kept), q (query bases kept), n_cols, n_match."""


def extend_lanes(a_list: list, b_list: list, W: int, device) -> Lanes:
    """Align each query a_list[i] against target b_list[i] (u8 arrays, the
    pass's own orientation) from their starts, clamped to W/4 of each
    other."""
    N = len(a_list)
    la_full = np.array([len(a) for a in a_list], np.int64)
    lb_full = np.array([len(b) for b in b_list], np.int64)
    la = np.minimum(la_full, lb_full + W // 4)
    lb = np.minimum(lb_full, la_full + W // 4)
    LA, LB = max(int(la.max(initial=0)), 1), max(int(lb.max(initial=0)), 1)
    A = np.zeros((N, LA), np.uint8)
    B = np.zeros((N, LB), np.uint8)
    for i in range(N):
        A[i, :la[i]] = a_list[i][:la[i]]
        B[i, :lb[i]] = b_list[i][:lb[i]]
    res = Lanes()
    res.la, res.lb, res.A, res.B = la, lb, A, B
    if int(lb.max(initial=0)) == 0:
        res.op = res.qrow = res.k = np.zeros((N, 0), np.int64)
        res.lead = np.minimum(la, np.int64(0))
        _clip(res)
        return res
    dirs, ctr = _forward(A, B, la, lb, W, device)
    entry, sel, op, lead = _walk(dirs, ctr, la, lb, W, device)
    del dirs
    j = torch.arange(1, entry.shape[1] + 1, device=entry.device)[None, :]
    c = ctr[:, None]
    res.op = op.cpu().numpy()
    res.qrow = (j - c + sel).cpu().numpy()
    res.k = (entry - sel).cpu().numpy()
    res.lead = lead.cpu().numpy()
    _clip(res)
    return res


def _clip(r: Lanes) -> None:
    """The tail clip and counts of each lane (host)."""
    N = len(r.la)
    r.jc = np.zeros(N, np.int64)
    r.q = np.zeros(N, np.int64)
    r.n_cols = np.zeros(N, np.int64)
    r.n_match = np.zeros(N, np.int64)
    r.match = []
    for i in range(N):
        n = int(r.lb[i])
        if n == 0:
            r.match.append(np.zeros(0, bool))
            continue
        op, qrow, k = r.op[i, :n], r.qrow[i, :n], r.k[i, :n]
        diag = op == DIAG
        qb = r.A[i][np.clip(qrow - 1, 0, max(len(r.A[i]) - 1, 0))]
        match = diag & (qb == r.B[i, :n])
        r.match.append(match)
        # length of the run of matched columns ending at each column; a
        # column after insertions starts a new run
        kprev = np.r_[r.lead[i], k[:-1]]
        jcol = np.arange(1, n + 1)
        e = np.where(~match, 2 * jcol, np.where(kprev > 0, 2 * jcol - 1, -1))
        run = (2 * jcol - np.maximum(np.maximum.accumulate(e), 1) + 1) // 2
        good = np.flatnonzero(match & (run >= TAIL_MATCH))
        jc = int(good[-1]) + 1 if len(good) else 0
        if jc == 0:
            continue
        r.jc[i] = jc
        kk = k[:jc]
        r.q[i] = r.lead[i] + int(diag[:jc].sum()) + int(kk.sum()) - int(kk[-1])
        r.n_match[i] = int(match[:jc].sum())
        r.n_cols[i] = r.lead[i] + jc + int(kk.sum()) - int(kk[-1])
