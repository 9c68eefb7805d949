"""The banded alignment kernels: CUDA wrappers, plain versions and launch
counters.

The static band, counterpart of necat_tpu/align/pallas_banded.py: lane l of
target column j holds query row i = j + l - ctr with the per-pair band
centre ctr = W/2 - floor((la - lb) / 2) (the extension clamps |la - lb| <=
W/4).

  diag_sub_matrix        (K2)  ENC u8[PB, MC, W] = mismatch | qbase << 1
                               (standalone: K1 computes ENC itself)
  banded_forward         (K1)  dirs u8[PB, MC, W] = op | mismatch << 2 |
                               qbase << 3, and the cost at (la, lb), from
                               the query and target rows
  banded_backtrack_cols  (K3)  cols i32[PB, MC] = op | match << 2 |
                               qbase << 3 | k << 5, `words` insb words, lead

The adaptive band (NECAT_TPU_NO_PALLAS), counterpart of the scan path of
necat_tpu/align/banded.py: lane s of column j holds query row offs[j] + s.

  banded_forward_adaptive (K1a) dirs u8[PB, MC, W] = op, offs i32[PB, MC+1],
                               the last column's S and the cost
  adaptive_backtrack_cols (K3a) cols, insb and lead as K3's, from K1a's dirs
                               and offs and the query and target rows

Each wrapper runs its plain PyTorch version (``*_ref``) for tensors on the
CPU, and launches its CUDA kernel (csrc/banded_kernels.cu) for tensors on a
CUDA device; it raises for anything else. ``launches_by_width`` counts the
kernel launches of each (wrapper, W), ``k3_launches_by_words`` K3's and
``k3a_launches_by_words`` K3a's of each (W, insb words);
``reset_launches`` sets all three to 0.
"""

from __future__ import annotations

from collections import Counter

import torch

from necat_tpu_torch.utils.build import check, launch, on_cpu

INF = 1 << 20
OP_DIAG, OP_DEL, OP_INS, OP_PAD = 0, 1, 2, 3
PAD_BASE = 127       # query padding value (never equals a target base 0..3)
PAD_TARGET = 255     # target padding past b's width
N_INSB = 7           # inserted bases recorded per insb word and run end
# band widths K1 and K3 are built for: a warp per pair up to 1024, a thread
# block per pair for the rescue ladder's 2048 and 4096 (shapes.MAX_BAND)
KERNEL_WIDTHS = (64, 128, 256, 512, 1024, 2048, 4096)

launches_by_width: Counter = Counter()       # (wrapper name, W) -> launches
k3_launches_by_words: Counter = Counter()    # (W, words) -> K3 launches
k3a_launches_by_words: Counter = Counter()   # (W, words) -> K3a launches


def reset_launches() -> None:
    launches_by_width.clear()
    k3_launches_by_words.clear()
    k3a_launches_by_words.clear()


def band_centre(W: int, la: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """ctr = W/2 - floor((la - lb) / 2); floor, not truncation: la - lb is
    often negative."""
    return W // 2 - torch.div(la - lb, 2, rounding_mode="floor")


# ---------------------------------------------------------------- plain versions

def _enc_inputs(a, b, la, lb, W: int, MC: int):
    """(query window view u8[PB, MC, W], target column u8[PB, MC]): the query
    base of lane l at column jc is a[p, jc + l - ctr_p] (PAD_BASE outside
    [0, L)), the target base b[p, jc] (PAD_TARGET past b's width)."""
    PB, L = a.shape
    ctr = band_centre(W, la.long(), lb.long())
    src = torch.arange(MC + W, device=a.device)[None, :] - ctr[:, None]
    ok = (src >= 0) & (src < L)
    a_shift = torch.where(ok, a.gather(1, src.clamp(0, L - 1)), PAD_BASE)
    mc = min(MC, b.shape[1])
    tcol = torch.full((PB, MC), PAD_TARGET, dtype=torch.uint8, device=a.device)
    tcol[:, :mc] = b[:, :mc]
    return a_shift.unfold(1, W, 1)[:, :MC, :], tcol


def _enc(dq, tcol) -> torch.Tensor:
    return (dq != tcol[:, :, None]).to(torch.uint8) | ((dq & 3) << 1)


def diag_sub_matrix_ref(a, b, la, lb, W: int, MC: int) -> torch.Tensor:
    """ENC[p, jc, l] = (aq != tc) | (aq & 3) << 1 with aq = a[p, jc + l - ctr_p]
    (PAD_BASE outside [0, L)) and tc = b[p, jc] (PAD_TARGET past b's width)."""
    return _enc(*_enc_inputs(a, b, la, lb, W, MC))


def _column_blocks(n: int, block: int = 1024):
    """[lo, hi) column ranges: the vectorised passes of the plain versions
    work a block at a time to bound their memory."""
    return [(lo, min(lo + block, n)) for lo in range(0, n, block)]


def banded_forward_ref(a, b, la, lb, W: int, max_cols: int | None = None):
    """Static-band DP of a u8[PB, L] against b u8[PB, Lb] -> (dirs u8[PB, MC,
    W], cost i32[PB]) with MC = max_cols (default Lb): diag_sub_matrix_ref's
    ENC, a block of columns at a time, then one vectorised step per target
    column.

    Each column's D is stored as [PB, W+1] with a spare lane W held at INF,
    in one flat buffer of all columns: the left neighbour (lane l+1) and the
    up neighbour (lane l-1) of every lane are then contiguous slices one
    element off. Lanes below row 0 need no mask before the insertion scan
    (they hold INF or more and cannot lower a finite value); lanes outside
    rows [0, la] are set to INF after it."""
    PB = a.shape[0]
    MC = b.shape[1] if max_cols is None else max_cols
    dev = a.device
    qwin, tcol = _enc_inputs(a, b, la, lb, W, MC)
    i32 = torch.int32
    la = la.to(i32)[:, None]
    lb = lb.to(i32)[:, None]
    ctr = band_centre(W, la, lb)
    ncol = min(MC, int(lb.max())) if PB else 0
    N = PB * (W + 1)
    lane1 = torch.arange(W + 1, dtype=i32, device=dev)[None, :]

    def rows(j):
        """Query row of every lane of columns j; the spare lane is outside."""
        return torch.where(lane1 == W, -1, lane1 + (j - ctr))

    Dall = torch.empty((ncol + 1) * N + 1, dtype=i32, device=dev)
    i0 = rows(torch.zeros((), dtype=i32, device=dev))
    Dall[:N] = torch.where((i0 < 0) | (i0 > la), INF, i0).reshape(-1)
    dirs = torch.full((PB, MC, W), OP_PAD, dtype=torch.uint8, device=dev)
    for lo, hi in _column_blocks(ncol, 256):
        j = torch.arange(lo + 1, hi + 1, dtype=i32, device=dev)[:, None, None]
        i = rows(j)                                           # [cols, PB, W+1]
        outside = (i < 0) | (i > la)
        row0 = (i == 0).reshape(hi - lo, -1)
        enc = _enc(qwin[:, lo:hi], tcol[:, lo:hi]).to(i32)
        e = torch.nn.functional.pad(enc, (0, 1)).transpose(0, 1)
        sub = (e & 1).reshape(hi - lo, -1)
        enc_bits = (e << 2).reshape(hi - lo, -1)
        out = torch.empty((hi - lo, PB, W + 1), dtype=torch.uint8, device=dev)
        for c in range(hi - lo):
            jc = lo + c + 1
            base = jc * N                                   # this column's D
            diag = Dall[base - N:base] + sub[c]
            left = Dall[base - N + 1:base + 1] + 1
            A = torch.minimum(diag, left)
            A.masked_fill_(row0[c], jc)                     # row 0: all deletions
            # insertion chain: D[l] = lane + min over m <= l of (A[m] - m)
            x = torch.cummin(A.view(PB, W + 1).sub_(lane1), dim=1).values
            Dn = x.add_(lane1).clamp_max_(INF).masked_fill_(outside[c], INF).view(-1)
            Dall[base:base + N] = Dn
            upv = Dall[base - 1:base + N - 1] + 1
            op = torch.where(Dn == diag, OP_DIAG,
                             torch.where(Dn == upv, OP_INS,
                                         torch.where(Dn == left, OP_DEL, OP_PAD)))
            out[c] = (op | enc_bits[c]).view(PB, W + 1)
        dirs[:, lo:hi] = out[:, :, :W].transpose(0, 1)
    # columns past lb are padding, and D stops changing there: the cost is
    # read at column min(lb, ncol)
    past_lb = torch.arange(MC, device=dev)[None, :] >= lb
    dirs.masked_fill_(past_lb[:, :, None], OP_PAD)
    Dcols = Dall[:(ncol + 1) * N].view(ncol + 1, PB, W + 1)
    D_end = Dcols[lb[:, 0].clamp(0, ncol).long(), torch.arange(PB, device=dev)]
    l_end = (la - lb + ctr).clamp(0, W - 1)
    return dirs, D_end.gather(1, l_end.long())[:, 0]


def banded_backtrack_cols_ref(dirs, la, lb, W: int, words: int = 1):
    """Walk dirs from (la, lb) back one target column per step -> (cols
    i32[PB, MC], tuple of `words` insb i32[PB, MC], lead i32[PB]).

    At a column with walk slot `cur`, the insertion run under cur ends at
    sel = the highest non-INS lane <= cur (-1 if none), the consumer op sits
    at sel, and the walk moves to sel (diagonal) or sel + 1 (deletion). The
    next slot is thus a per-column function of cur, tabulated for all
    columns at once; the sequential walk is one lookup per column, and the
    column encodings follow from the visited slots."""
    PB, MC, _ = dirs.shape
    dev = dirs.device
    i32 = torch.int32
    la = la.to(i32)[:, None]
    lb = lb.to(i32)[:, None]
    ctr = band_centre(W, la, lb)
    ncol = min(MC, int(lb.max())) if PB else 0
    lane16 = torch.arange(W, dtype=torch.int16, device=dev)
    cols = torch.full((PB, MC), OP_PAD, dtype=i32, device=dev)
    insb = torch.zeros((words, PB, MC), dtype=i32, device=dev)

    def consumer(blk, sel, j):
        """(op, byte at sel) of the consumer op at slot sel of columns j."""
        vsel = blk.gather(2, sel.clamp(min=0).long()).to(i32)
        vsel = torch.where(sel >= 0, vsel, 0)
        o = torch.where(j - ctr[:, :, None] + sel <= 0, OP_DEL, vsel & 3)   # row-0 border
        return o, vsel

    # sel_at[p, jc, c] = sel when the walk enters column jc+1 at slot c,
    # step[p, jc, c] = the slot it leaves at
    sel_at = torch.empty((PB, ncol, W), dtype=torch.int16, device=dev)
    step = torch.empty((PB, ncol, W), dtype=torch.int16, device=dev)
    for lo, hi in _column_blocks(ncol):
        blk = dirs[:, lo:hi]
        s = torch.where((blk & 3) != OP_INS, lane16, -1).cummax(dim=2).values
        j = torch.arange(lo + 1, hi + 1, dtype=i32, device=dev)[None, :, None]
        o, _ = consumer(blk, s, j)
        sel_at[:, lo:hi] = s
        step[:, lo:hi] = torch.where(o == OP_DIAG, s, s + 1).clamp(0, W - 1)
    cur = (la - lb + ctr).clamp(0, W - 1).long()
    visited = torch.empty((PB, ncol), dtype=torch.int64, device=dev)
    for j in range(ncol, 0, -1):
        visited[:, j - 1] = cur[:, 0]
        nxt = step[:, j - 1].gather(1, cur).long()
        cur = torch.where(j <= lb, nxt, cur)
    lead = torch.minimum((cur - ctr).clamp(min=0), la)[:, 0].to(i32)

    for lo, hi in _column_blocks(ncol):
        blk = dirs[:, lo:hi]
        c = visited[:, lo:hi, None]
        sel = sel_at[:, lo:hi].gather(2, c).to(i32)
        j = torch.arange(lo + 1, hi + 1, dtype=i32, device=dev)[None, :, None]
        o, vsel = consumer(blk, sel, j)
        isdiag = o == OP_DIAG
        match = torch.where(isdiag, 1 - ((vsel >> 2) & 1), 0)
        qbase = torch.where(isdiag, (vsel >> 3) & 3, 0)
        k = c.to(i32) - sel
        active = (j[:, :, 0] <= lb)
        val = ((k << 5) | (qbase << 3) | (match << 2) | o)[:, :, 0]
        cols[:, lo:hi] = torch.where(active, val, OP_PAD)
        # inserted bases of the run (lanes sel+1 .. cur): word w holds run
        # ranks 7w+1 .. 7w+7, the first bases at bits 2(d-1) counted from
        # the run start, the last at bits 14+2(d-1) counted from its end
        kc = k.clamp(max=N_INSB * words)
        qb = lambda ln: ((blk.gather(2, ln.clamp(0, W - 1).long()) >> 3) & 3).to(i32)
        for w in range(words):
            acc = torch.zeros_like(k)
            for d in range(1, N_INSB + 1):
                r = N_INSB * w + d                      # rank from the run start
                acc |= torch.where(r <= kc, qb(sel + r) << (2 * (d - 1)), 0)
                acc |= torch.where(r <= kc, qb(c.to(i32) - (r - 1)) << (14 + 2 * (d - 1)), 0)
            insb[w, :, lo:hi] = torch.where(active, acc[:, :, 0], 0)
    return cols, tuple(insb), lead


# ------------------------------------------- adaptive band: plain versions
# Counterparts of the scan path of necat_tpu/align/banded.py (the JAX
# package's extension without Pallas, NECAT_TPU_NO_PALLAS): row coordinates,
# the band of column j covering query rows [offs[j], offs[j] + W).

def _first_argmin(x, lanes) -> torch.Tensor:
    """The first lane of each row's minimum (jnp.argmin's tie rule)."""
    return torch.where(x == x.amin(dim=1, keepdim=True), lanes, x.shape[1]).amin(dim=1)


def banded_forward_adaptive_ref(a, b, la, lb, W: int, max_cols: int | None = None):
    """Adaptive-band DP of a u8[PB, LA] against b u8[PB, LB] from (0, 0)
    toward (la, lb), one vectorised step per target column (necat_tpu's
    banded.banded_forward). Before column j the band moves d = 0, 1 or 2
    rows toward the argmin third of the previous column (d = 0 at column 1),
    off = clip(off + d, 0, max(la, 0)). Returns (dirs u8[PB, MC, W] = the op
    alone, OP_PAD past lb; offs i32[PB, MC+1]; S_fin i32[PB, W], the column
    at min(lb, MC); cost i32[PB] = S_fin at row la), MC = max_cols (default
    LB). Columns past lb freeze S and off."""
    PB, LA = a.shape
    LB = b.shape[1]
    MC = LB if max_cols is None else max_cols
    dev = a.device
    i32 = torch.int32
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    la = la.to(i32)
    lb = lb.to(i32)
    S = torch.where(lanes <= la[:, None], lanes, INF).to(i32)
    off = torch.zeros(PB, dtype=i32, device=dev)
    off_hi = la.clamp(min=0)
    dirs = torch.full((PB, MC, W), OP_PAD, dtype=torch.uint8, device=dev)
    offs = torch.zeros((PB, MC + 1), dtype=i32, device=dev)
    ncol = max(0, min(MC, int(lb.max()))) if PB else 0
    inf2 = torch.full((PB, 2), INF, dtype=i32, device=dev)
    for j in range(1, ncol + 1):
        active = j <= lb
        if j == 1:
            d = torch.zeros_like(off)
        else:
            m = _first_argmin(S, lanes)
            d = torch.where(m > (2 * W) // 3, 2, torch.where(m > W // 3, 1, 0)).to(i32)
        off_j = torch.minimum((off + d).clamp(min=0), off_hi)
        rows = off_j[:, None] + lanes
        # slot s reads the previous column at s + d (left) and s + d - 1
        # (diagonal); INF outside [0, W): Sp[1 + idx] = S_prev[idx]
        Sp = torch.cat([inf2[:, :1], S, inf2], dim=1)
        sd = lanes + (off_j - off)[:, None]
        left = Sp.gather(1, (sd + 1).long()) + 1
        qbase = a.gather(1, (rows - 1).clamp(0, LA - 1).long())
        sub = (qbase != b[:, min(max(j - 1, 0), LB - 1), None]).to(i32)
        diag = torch.where(rows >= 1, Sp.gather(1, sd.long()) + sub, INF)
        outside = rows > la[:, None]
        A = torch.minimum(left, diag).masked_fill_(outside, INF)
        # insertions within the column: S[s] = min(A[s], S[s-1] + 1)
        Sc = (torch.cummin(A - lanes, dim=1).values + lanes).clamp_(max=INF)
        Sc.masked_fill_(outside, INF)
        up = torch.cat([inf2[:, :1], Sc[:, :-1] + 1], dim=1)
        op = torch.where(Sc == diag, OP_DIAG,
                         torch.where(Sc == up, OP_INS,
                                     torch.where(Sc == left, OP_DEL, OP_PAD)))
        dirs[:, j - 1] = torch.where(active[:, None], op, OP_PAD).to(torch.uint8)
        S = torch.where(active[:, None], Sc, S)
        off = torch.where(active, off_j, off)
        offs[:, j] = off
    offs[:, ncol + 1:] = off[:, None]
    slot = (la - off).clamp(0, W - 1).long()
    return dirs, offs, S, S.gather(1, slot[:, None])[:, 0]


def banded_traceback_ref(dirs, offs, la, lb, max_ops: int):
    """Walk dirs/offs from (la, lb) back to (0, 0), one op per step
    (necat_tpu's banded.banded_traceback): slot clip(r - offs[j], 0, W-1) of
    column j, the op bits of its byte, DEL forced on row 0 and INS on
    column 0. Returns (ops u8[PB, max_ops] start -> end, OP_PAD after them;
    n_ops i32[PB]). A pair that reads OP_PAD stays where it is, as the JAX
    walk does."""
    B, LB, W = dirs.shape
    dev = dirs.device
    r = la.to(torch.int32).clone()
    j = lb.to(torch.int32).clone()
    done = (r == 0) & (j == 0)
    ops_rev = torch.full((B, max_ops), OP_PAD, dtype=torch.uint8, device=dev)
    bidx = torch.arange(B, device=dev)
    moved = ~done                    # the pairs the last step moved
    for k in range(max_ops):
        # stop once no pair moves: every pair is home or held on an OP_PAD
        # for good; asked every 32 steps (a host sync per step would set the
        # pace on a GPU), the steps in between write OP_PAD
        if k % 32 == 0 and not bool(moved.any()):
            break
        slot = (r - offs.gather(1, j[:, None].long())[:, 0]).clamp(0, W - 1)
        op = (dirs[bidx, (j - 1).clamp(0, LB - 1).long(), slot.long()] & 3).to(torch.int32)
        op = torch.where(r == 0, OP_DEL, op)
        op = torch.where(j == 0, OP_INS, op)
        op = torch.where(done, OP_PAD, op)
        dr = (op == OP_DIAG) | (op == OP_INS)
        dj = (op == OP_DIAG) | (op == OP_DEL)
        r -= dr.to(torch.int32)
        j -= dj.to(torch.int32)
        done |= (r == 0) & (j == 0)
        ops_rev[:, k] = op.to(torch.uint8)
        moved = dr | dj
    n_ops = (ops_rev != OP_PAD).sum(dim=1).to(torch.int32)
    idx = n_ops[:, None] - 1 - torch.arange(max_ops, device=dev)[None, :]
    ops = torch.where(idx >= 0, ops_rev.gather(1, idx.clamp(0, max_ops - 1).long()), OP_PAD)
    return ops.to(torch.uint8), n_ops


def clip_tail(ops, n_ops, a, b, tail_match: int = 8):
    """(n_clip i32[B], match bool[B, L]): each op string cut back to the end
    of its last run of tail_match consecutive matches (necat_tpu's
    banded.clip_tail, oc_aligner.c:223-259)."""
    B, L = ops.shape
    dev = ops.device
    real = ops != OP_PAD
    qpos = torch.cumsum((ops != OP_DEL) & real, dim=1)
    tpos = torch.cumsum((ops != OP_INS) & real, dim=1)
    qb = a.gather(1, (qpos - 1).clamp(0, a.shape[1] - 1))
    tb = b.gather(1, (tpos - 1).clamp(0, b.shape[1] - 1))
    idx = torch.arange(L, device=dev)[None, :]
    match = (ops == OP_DIAG) & (qb == tb) & (idx < n_ops[:, None])
    last_nonmatch = torch.cummax(torch.where(match, -1, idx), dim=1).values
    good = idx - last_nonmatch >= tail_match
    last_good = torch.where(good, idx, -1).amax(dim=1)
    n_clip = torch.where(good.any(dim=1), last_good + 1, 0).to(torch.int32)
    return n_clip, match


def ops_to_cols_ref(ops, n_ops, a, b, MC: int, words: int = 1):
    """An op string in the per-column encoding (necat_tpu's
    banded.ops_to_cols): cols i32[B, MC], entry j-1 for target column j =
    op | match << 2 | qbase << 3 | k << 5 (the column's DIAG or DEL, and the
    k INS ops after it); `words` insb i32[B, MC], word w holding run ranks
    7w+1 .. 7w+7 counted from the run's start at bits 2(d-1) and from its
    end at bits 14+2(d-1); lead i32[B], the INS ops before column 1.
    Columns are counted from the start of the op string."""
    B, LOPS = ops.shape
    dev = ops.device
    i = torch.arange(LOPS, device=dev)[None, :]
    valid = (i < n_ops[:, None]) & (ops != OP_PAD)
    consume_t = (ops != OP_INS) & valid
    consume_q = (ops != OP_DEL) & valid
    is_ins = (ops == OP_INS) & valid
    isdiag = (ops == OP_DIAG) & valid
    ct = torch.cumsum(consume_t, dim=1)
    cq = torch.cumsum(consume_q, dim=1)
    ctc = ct.clamp(0, MC)

    def col_sum(v):
        return torch.zeros((B, MC + 1), dtype=torch.int32, device=dev).scatter_add_(
            1, ctc, v.to(torch.int32))

    qb_op = a.to(torch.int32).gather(1, (cq - 1).clamp(0, a.shape[1] - 1))
    tb_op = b.to(torch.int32).gather(1, (ct - 1).clamp(0, b.shape[1] - 1))
    kflat = col_sum(is_ins)
    present = col_sum(consume_t)
    opflat = col_sum(torch.where(consume_t, ops.to(torch.int32), 0))
    matchflat = col_sum(isdiag & (qb_op == tb_op))
    qbaseflat = col_sum(torch.where(isdiag, qb_op, 0))
    # rank of each INS within its run (1-based): distance to the last non-INS op
    last_non_ins = torch.cummax(torch.where(~is_ins & valid, i, -1), dim=1).values
    m = torch.where(is_ins, i - last_non_ins, 0)
    k_of = kflat.gather(1, ctc)
    insb = []
    for w in range(words):
        acc = torch.zeros((B, MC + 1), dtype=torch.int32, device=dev)
        for d in range(1, N_INSB + 1):
            dd = w * N_INSB + d
            acc |= col_sum(torch.where(is_ins & (m == dd), qb_op, 0)) << (2 * (d - 1))
            acc |= col_sum(torch.where(is_ins & (m == k_of - dd + 1), qb_op, 0)) \
                << (14 + 2 * (d - 1))
        insb.append(acc[:, 1:])
    op_col = torch.where(present[:, 1:] > 0, opflat[:, 1:], OP_PAD)
    cols = (kflat[:, 1:] << 5) | (qbaseflat[:, 1:] << 3) | (matchflat[:, 1:] << 2) | op_col
    return cols, tuple(insb), kflat[:, 0].clone()


def adaptive_backtrack_cols_ref(dirs, offs, a, b, la, lb, W: int, words: int = 1):
    """Plain version of K3a: ops_to_cols_ref(banded_traceback_ref(...)) with
    the JAX extension's bound of LQ + MC ops -> (cols i32[PB, MC], `words`
    insb i32[PB, MC], lead i32[PB])."""
    MC = dirs.shape[1]
    ops, n_ops = banded_traceback_ref(dirs, offs, la, lb, a.shape[1] + MC)
    return ops_to_cols_ref(ops, n_ops, a, b, MC, words)


# -------------------------------------------------------------- CUDA wrappers

def _check_width(W: int) -> None:
    if W not in KERNEL_WIDTHS:
        raise ValueError(f"band width {W}: the CUDA kernels take W in {KERNEL_WIDTHS}")


def diag_sub_matrix(a, b, la, lb, W: int, MC: int) -> torch.Tensor:
    """K2: ENC u8[PB, MC, W] from a u8[PB, L], b u8[PB, Lb], la/lb i32[PB]."""
    if on_cpu(a, b, la, lb):
        return diag_sub_matrix_ref(a, b, la, lb, W, MC)
    PB, L = a.shape
    check(a, "a", torch.uint8, (PB, L))
    check(b, "b", torch.uint8, (PB, b.shape[1]))
    check(la, "la", torch.int32, (PB,))
    check(lb, "lb", torch.int32, (PB,))
    if W % 4 or MC * (W // 4) >= 1 << 31:
        raise ValueError(f"diag_sub_matrix: W={W} must be a multiple of 4 and "
                         f"MC * W / 4 below 2^31 (MC={MC})")
    out = torch.empty((PB, MC, W), dtype=torch.uint8, device=a.device)
    if out.numel() == 0:
        return out
    launch("necat_diag_sub_matrix", a.device, a.data_ptr(), L, b.data_ptr(),
           b.shape[1], la.data_ptr(), lb.data_ptr(), out.data_ptr(), PB, MC, W)
    launches_by_width[("diag_sub_matrix", W)] += 1
    return out


def banded_forward(a, b, la, lb, W: int, max_cols: int | None = None):
    """K1: (dirs u8[PB, MC, W], cost i32[PB]) from a u8[PB, L], b u8[PB, Lb],
    la/lb i32[PB]; MC = max_cols, b's width by default (the signature of
    necat_tpu's banded_forward_pallas)."""
    if on_cpu(a, b, la, lb):
        return banded_forward_ref(a, b, la, lb, W, max_cols)
    PB, L = a.shape
    MC = b.shape[1] if max_cols is None else max_cols
    _check_width(W)
    check(a, "a", torch.uint8, (PB, L))
    check(b, "b", torch.uint8, (PB, b.shape[1]))
    check(la, "la", torch.int32, (PB,))
    check(lb, "lb", torch.int32, (PB,))
    dirs = torch.empty((PB, MC, W), dtype=torch.uint8, device=a.device)
    cost = torch.empty((PB,), dtype=torch.int32, device=a.device)
    launch("necat_banded_forward", a.device, a.data_ptr(), L, b.data_ptr(),
           b.shape[1], la.data_ptr(), lb.data_ptr(), dirs.data_ptr(),
           cost.data_ptr(), PB, MC, W)
    launches_by_width[("banded_forward", W)] += 1
    return dirs, cost


def banded_backtrack_cols(dirs, la, lb, W: int, words: int = 1):
    """K3: (cols i32[PB, MC], tuple of `words` insb i32[PB, MC], lead i32[PB])."""
    if on_cpu(dirs, la, lb):
        return banded_backtrack_cols_ref(dirs, la, lb, W, words)
    PB, MC, _ = dirs.shape
    _check_width(W)
    check(dirs, "dirs", torch.uint8, (PB, MC, W))
    check(la, "la", torch.int32, (PB,))
    check(lb, "lb", torch.int32, (PB,))
    if not 1 <= words <= 3:
        raise ValueError(f"words={words}: 1..3 insb words")
    cols = torch.empty((PB, MC), dtype=torch.int32, device=dirs.device)
    insb = torch.empty((words, PB, MC), dtype=torch.int32, device=dirs.device)
    lead = torch.empty((PB,), dtype=torch.int32, device=dirs.device)
    launch("necat_banded_backtrack", dirs.device, dirs.data_ptr(), la.data_ptr(),
           lb.data_ptr(), cols.data_ptr(), insb.data_ptr(), lead.data_ptr(),
           PB, MC, W, words)
    launches_by_width[("banded_backtrack_cols", W)] += 1
    k3_launches_by_words[(W, words)] += 1
    return cols, tuple(insb), lead


def banded_forward_adaptive(a, b, la, lb, W: int, max_cols: int | None = None):
    """K1a: (dirs u8[PB, MC, W], offs i32[PB, MC+1], S_fin i32[PB, W], cost
    i32[PB]) from a u8[PB, L], b u8[PB, Lb], la/lb i32[PB]; MC = max_cols,
    b's width by default (the signature of necat_tpu's banded_forward)."""
    if on_cpu(a, b, la, lb):
        return banded_forward_adaptive_ref(a, b, la, lb, W, max_cols)
    PB, L = a.shape
    Lb = b.shape[1]
    MC = Lb if max_cols is None else max_cols
    _check_width(W)
    check(a, "a", torch.uint8, (PB, L))
    check(b, "b", torch.uint8, (PB, Lb))
    check(la, "la", torch.int32, (PB,))
    check(lb, "lb", torch.int32, (PB,))
    if L < 1 or Lb < 1:
        raise ValueError(f"banded_forward_adaptive: empty rows (L={L}, Lb={Lb})")
    dirs = torch.empty((PB, MC, W), dtype=torch.uint8, device=a.device)
    offs = torch.empty((PB, MC + 1), dtype=torch.int32, device=a.device)
    s_fin = torch.empty((PB, W), dtype=torch.int32, device=a.device)
    cost = torch.empty((PB,), dtype=torch.int32, device=a.device)
    if PB:
        launch("necat_banded_forward_adaptive", a.device, a.data_ptr(), L, b.data_ptr(),
               Lb, la.data_ptr(), lb.data_ptr(), dirs.data_ptr(), offs.data_ptr(),
               s_fin.data_ptr(), cost.data_ptr(), PB, MC, W)
        launches_by_width[("banded_forward_adaptive", W)] += 1
    return dirs, offs, s_fin, cost


def adaptive_backtrack_cols(dirs, offs, a, b, la, lb, W: int, words: int = 1):
    """K3a: (cols i32[PB, MC], tuple of `words` insb i32[PB, MC], lead
    i32[PB]) from K1a's dirs and offs and the pairs' rows a u8[PB, L], b
    u8[PB, Lb] (adaptive dirs carry the op alone: match and query bases
    come from the rows)."""
    if on_cpu(dirs, offs, a, b, la, lb):
        return adaptive_backtrack_cols_ref(dirs, offs, a, b, la, lb, W, words)
    PB, MC, _ = dirs.shape
    L, Lb = a.shape[1], b.shape[1]
    _check_width(W)
    check(dirs, "dirs", torch.uint8, (PB, MC, W))
    check(offs, "offs", torch.int32, (PB, MC + 1))
    check(a, "a", torch.uint8, (PB, L))
    check(b, "b", torch.uint8, (PB, Lb))
    check(la, "la", torch.int32, (PB,))
    check(lb, "lb", torch.int32, (PB,))
    if not 1 <= words <= 3:
        raise ValueError(f"words={words}: 1..3 insb words")
    if L < 1 or Lb < 1:
        raise ValueError(f"adaptive_backtrack_cols: empty rows (L={L}, Lb={Lb})")
    cols = torch.empty((PB, MC), dtype=torch.int32, device=dirs.device)
    insb = torch.empty((words, PB, MC), dtype=torch.int32, device=dirs.device)
    lead = torch.empty((PB,), dtype=torch.int32, device=dirs.device)
    if PB:
        launch("necat_adaptive_backtrack", dirs.device, dirs.data_ptr(), offs.data_ptr(),
               a.data_ptr(), L, b.data_ptr(), Lb, la.data_ptr(), lb.data_ptr(),
               cols.data_ptr(), insb.data_ptr(), lead.data_ptr(), PB, MC, W, words)
        launches_by_width[("adaptive_backtrack_cols", W)] += 1
        k3a_launches_by_words[(W, words)] += 1
    return cols, tuple(insb), lead
