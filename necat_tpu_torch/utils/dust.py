"""DUST low-complexity masking, on the host (the port's copy of
necat_tpu/utils/dust.py).

Role of the reference's SDUST port (src/common/symdust.{hpp,cpp}, used by
oc2pprr via is_nonrepeat_sequence, src/common/check_nonrepeat_suffix.cpp:8-21):
mask low-complexity regions so preprocessing can drop reads that are almost
entirely repeats. This is the windowed DUST score formulation (score =
sum_t c_t*(c_t-1)/2 over triplet counts c_t, normalized by window_len-3;
threshold 2.0 == the classic "20" setting) rather than SDUST's perfect-interval
refinement — equivalent for the keep/drop decision, and fully vectorizable."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

WINDOW = 64
THRESHOLD = 2.0  # score units (SDUST's T=20 divided by its x10 fixed point)


def triplet_codes(seq: np.ndarray) -> np.ndarray:
    """Rolling 3-mer codes (0..63) of a 0..3 base array; empty if len < 3."""
    n = len(seq)
    if n < 3:
        return np.zeros(0, np.int32)
    s = seq.astype(np.int32)
    return s[:-2] * 16 + s[1:-1] * 4 + s[2:]


def window_scores(seq: np.ndarray, window: int = WINDOW) -> np.ndarray:
    """DUST score of every `window`-length window (stride 1)."""
    t = triplet_codes(seq)
    nt = len(t)
    wt = min(window - 2, nt)  # triplets per window
    if nt == 0 or wt < 2:
        return np.zeros(0, np.float64)
    n_win = nt - wt + 1
    # counts via cumulative one-hot sums: [nt+1, 64]
    onehot = np.zeros((nt + 1, 64), np.int32)
    onehot[np.arange(1, nt + 1), t] = 1
    csum = np.cumsum(onehot, axis=0)
    c = csum[wt:] - csum[:-wt]            # [n_win, 64] triplet counts
    sc = (c * (c - 1) // 2).sum(axis=1).astype(np.float64)
    return sc / (wt - 1)


def dust_intervals(seq: np.ndarray, window: int = WINDOW,
                   threshold: float = THRESHOLD) -> List[Tuple[int, int]]:
    """Merged [start, end) base intervals whose windows exceed the threshold."""
    sc = window_scores(seq, window)
    if len(sc) == 0:
        return []
    hot = sc > threshold
    if not hot.any():
        return []
    wt = min(window - 2, len(triplet_codes(seq)))
    idx = np.flatnonzero(hot)
    starts = idx
    ends = idx + wt + 2  # window covers bases [i, i + wt + 2)
    merged = []
    cs, ce = int(starts[0]), int(ends[0])
    for s, e in zip(starts[1:], ends[1:]):
        if s <= ce:
            ce = int(e)
        else:
            merged.append((cs, ce))
            cs, ce = int(s), int(e)
    merged.append((cs, min(ce, len(seq))))
    return merged


def masked_size(seq: np.ndarray, window: int = WINDOW,
                threshold: float = THRESHOLD) -> int:
    return sum(e - s for s, e in dust_intervals(seq, window, threshold))


def is_nonrepeat_sequence(seq: np.ndarray) -> bool:
    """check_nonrepeat_suffix.cpp:15-21: keep iff masked size + 200 < length."""
    return masked_size(seq) + 200 < len(seq)
