"""The least time the card could take for the work a call needs: the
benchmark's frozen copy of the bound arithmetic of chip_smoke.py (bound,
PEAK_BYTES_S, PEAK_INT_OPS_S, OPS_PER_CELL, OPS_PER_WALK_LANE; copied from
chip_smoke.py at commit 6202318), applied to a whole extend_batch call.

The work is counted from the call's arguments and its cols output, so that
the same work is counted whatever implements it: each base of the pairs'
rows read once, each walked column's outputs written once, a DP cell per
band lane of each target column the pair consumes, and the walk's lane
tests. The intermediate dirs are not counted: a design that never stores
them does the same work.
"""

from __future__ import annotations

# H100 SXM peaks: HBM3 bytes/s (NVIDIA H100 datasheet) and INT32 operations/s
# (132 SMs x 64 INT32 lanes x 1.98 GHz, NVIDIA H100 white paper)
PEAK_BYTES_S = 3.35e12
PEAK_INT_OPS_S = 132 * 64 * 1.98e9
# Integer operations a cell needs, the fewest it can be done in. An ENC byte
# (mismatch | qbase << 1) costs 9 operations per 4 bytes packed in a word;
# a static-band DP cell adds the diag add, left add, min, the insertion
# chain's prefix-min step and the op select (5). An adaptive-band cell needs
# the mismatch compare, the diag add, left add, min, the chain's prefix-min
# step, the op select and the compare of the next column's argmin (7). The
# walk tests, per walked column, the lanes from its slot down to the end of
# the insertion run there (k + 1 of them): op bits and a compare each.
ENC_OPS = 9 / 4
OPS_PER_CELL = {"static": ENC_OPS + 5, "adaptive": 7}
OPS_PER_WALK_LANE = 2


def extend_work(qlens, tlens, anchor_q, anchor_t, W: int, insb_words: int, cols,
                band: str = "static"):
    """(bytes, operations) as 0-d int64 and float64 tensors on the call's
    device, of one extend_batch call: both sides of every pair (left over the
    reversed prefixes, right over the suffixes), lengths clamped as the call
    clamps them (|la - lb| <= W/4). cols: the call's per-column output of
    both sides stacked, int32[2B, MC]. Nothing is read back to the host."""
    import torch
    la_full = torch.cat([anchor_q, qlens - anchor_q]).long()
    lb_full = torch.cat([anchor_t, tlens - anchor_t]).long()
    la = torch.minimum(la_full, lb_full + W // 4).clamp(min=0)
    lb = torch.minimum(lb_full, la_full + W // 4)
    MC = cols.shape[1]
    ncol = lb.clamp(min=0, max=MC)
    cells = ncol.sum() * W
    in_walk = torch.arange(MC, device=cols.device)[None, :] < ncol[:, None]
    walk = torch.where(in_walk, (cols >> 5).long() + 1, 0).sum()
    ops = cells.double() * OPS_PER_CELL[band] + walk.double() * OPS_PER_WALK_LANE
    # in: the rows (la + lb bases a side) and each pair's four int32
    # lengths and anchors; out: cols and the insb words of each walked
    # column, and each side's lead
    nbytes = (la.sum() + ncol.sum() + 8 * la.numel()
              + 4 * (1 + insb_words) * ncol.sum() + 4 * la.numel())
    return nbytes, ops

