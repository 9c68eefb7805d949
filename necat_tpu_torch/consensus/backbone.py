"""Consensus calling from the dense tag tensor (counterpart of
necat_tpu/consensus/backbone.py, packed branch).

Per template column a thresholded weighted majority: delta 0 emits the
argmax base (a gap wins as a deletion) where coverage >= min_cov; delta
k >= 1 emits its argmax ACGT where the weight clears ins_frac * cov +
ins_offset. The calls are packed into one int32 per column for the host
decode compact_from_packed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def call_consensus(weights, coverage, min_cov, ins_frac, ins_offset=1.0):
    """weights f32[TB, D, 5, L], coverage i32[TB, L] -> (emit bool[TB, L, D],
    base uint8[TB, L, D]). argmax takes the first maximum, as jnp.argmax."""
    w0 = weights[:, 0]                                   # [TB, 5, L]
    b0 = torch.argmax(w0, dim=1)
    covered = coverage >= min_cov
    emit0 = covered & (b0 < 4) & (w0.amax(dim=1) > 0)
    wk = weights[:, 1:, :4, :]                           # [TB, D-1, 4, L]
    bk = torch.argmax(wk, dim=2)
    thr = ins_frac * coverage.clamp(min=1)[:, None, :] + ins_offset
    emitk = covered[:, None, :] & (wk.amax(dim=2) >= thr)
    emit = torch.cat([emit0[:, None], emitk], dim=1)     # [TB, D, L]
    base = torch.cat([b0[:, None], bk], dim=1).to(torch.uint8)
    return emit.permute(0, 2, 1), base.permute(0, 2, 1)


def consensus_packed(weights, coverage, min_cov, ins_frac, ins_offset):
    """call_consensus packed as int32[TB, L], 3-bit field d at bits 3d:
    field 0 = emitted base 0..3 | 5 covered but no emission | 7 uncovered;
    field d >= 1 = inserted base 0..3 | 7 none."""
    emit, base = call_consensus(weights, coverage, min_cov, ins_frac, ins_offset)
    D = emit.shape[2]
    fields = torch.where(emit, base.to(torch.int32), 7)
    covered = coverage >= min_cov
    fields[:, :, 0] = torch.where(emit[:, :, 0], base[:, :, 0].to(torch.int32),
                                  torch.where(covered, 5, 7))
    shifts = 3 * torch.arange(D, dtype=torch.int32, device=weights.device)
    return (fields << shifts).sum(dim=2, dtype=torch.int32)


def compact_from_packed(
    packed: np.ndarray,    # int32[TB, L] (host)
    tlens: np.ndarray,
    templates: np.ndarray,
    min_size: int,
    raw_min_gap: int,
    max_delta: int = 8,
    min_run: int | None = None,
) -> List[Tuple[List[Tuple[int, int, np.ndarray]], List[Tuple[int, int, np.ndarray]]]]:
    """Host decode of consensus_packed: per template (cns_pieces, raw_pieces),
    each piece (from, to, seq codes). Covered runs of >= min_run columns
    (default min_size) become corrected pieces of >= min_size bases
    (consensus_broken, cbcns.c:108-170); gaps of >= raw_min_gap between them
    pass through uncorrected (get_raw_intvs, consensus_one_read.c:19-65)."""
    if min_run is None:
        min_run = min_size
    out = []
    for b in range(len(tlens)):
        n = int(tlens[b])
        cns_pieces: List[Tuple[int, int, np.ndarray]] = []
        raw_pieces: List[Tuple[int, int, np.ndarray]] = []
        if n == 0:
            out.append((cns_pieces, raw_pieces))
            continue
        p = packed[b, :n]
        cov = (p & 7) != 7
        dif = np.diff(np.r_[0, cov.astype(np.int8), 0])
        starts = np.flatnonzero(dif == 1)
        ends = np.flatnonzero(dif == -1)
        for s, e in zip(starts, ends):
            if e - s < min_run:
                continue
            fields = (p[s:e, None] >> (3 * np.arange(max_delta)[None, :])) & 7
            seq = fields[fields < 4]            # row-major: t asc, delta asc
            if len(seq) >= min_size:
                cns_pieces.append((int(s), int(e), seq.astype(np.uint8)))
        prev = 0
        for s, e in [(s, e) for (s, e, _) in cns_pieces] + [(n, n)]:
            if s - prev >= raw_min_gap:
                raw_pieces.append((prev, s, templates[b, prev:s].astype(np.uint8)))
            prev = max(prev, e)
        out.append((cns_pieces, raw_pieces))
    return out
