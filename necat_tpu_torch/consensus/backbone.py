"""Consensus calling from the dense tag tensor (counterpart of
necat_tpu/consensus/backbone.py).

Per template column a thresholded weighted majority: delta 0 emits the
argmax base (a gap wins as a deletion) where coverage >= min_cov; delta
k >= 1 emits its argmax ACGT where the weight clears ins_frac * cov +
ins_offset. The correction path compacts the emitted bases on the device,
for every max_delta, into a stream (consensus_stream) that the host only
slices into pieces (compact_from_stream), reading the templates in place;
with wide deltas (polish, 22) hot_insertion_mask also marks the columns the
host link DP repairs. consensus_packed (3-bit fields in one int32 per
column, up to max_delta 10) and its host decode compact_from_packed are the
JAX package's counterparts and the stream path's oracle.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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
        if n == 0:
            out.append((cns_pieces, []))
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
        out.append((cns_pieces, _raw_pieces(cns_pieces, n, templates[b], raw_min_gap)))
    return out


def compact_consensus(
    emit: np.ndarray,       # bool[TB, L, D]
    base: np.ndarray,       # uint8[TB, L, D]
    coverage: np.ndarray,   # int32[TB, L]
    tlens: np.ndarray,      # int32[TB]
    templates: np.ndarray,  # uint8[TB, L] the templates' codes
    min_cov: int,
    min_size: int,
    raw_min_gap: int,
) -> List[Tuple[List[Tuple[int, int, np.ndarray]], List[Tuple[int, int, np.ndarray]]]]:
    """Host compaction of call_consensus' dense output (the oracle of
    compact_from_packed and compact_from_stream;
    necat_tpu/consensus/backbone.py:307): per template (cns_pieces,
    raw_pieces) as compact_from_packed gives them, with runs of coverage >=
    min_cov of >= min_size columns."""
    out = []
    for b in range(emit.shape[0]):
        n = int(tlens[b])
        cns_pieces: List[Tuple[int, int, np.ndarray]] = []
        if n == 0:
            out.append((cns_pieces, []))
            continue
        cov = coverage[b, :n] >= min_cov
        dif = np.diff(np.r_[0, cov.astype(np.int8), 0])
        for s, e in zip(np.flatnonzero(dif == 1), np.flatnonzero(dif == -1)):
            if e - s < min_size:
                continue
            seq = base[b, s:e][emit[b, s:e]]     # row-major: t asc, delta asc
            if len(seq) >= min_size:
                cns_pieces.append((int(s), int(e), seq.astype(np.uint8)))
        out.append((cns_pieces, _raw_pieces(cns_pieces, n, templates[b], raw_min_gap)))
    return out


def _raw_pieces(cns_pieces, n: int, template: np.ndarray, raw_min_gap: int):
    """The uncorrected passthrough of a template's gaps of >= raw_min_gap
    between its corrected pieces (get_raw_intvs, consensus_one_read.c:19-65)."""
    raw_pieces: List[Tuple[int, int, np.ndarray]] = []
    prev = 0
    for s, e in [(s, e) for (s, e, _) in cns_pieces] + [(n, n)]:
        if s - prev >= raw_min_gap:
            raw_pieces.append((prev, s, template[prev:s].astype(np.uint8)))
        prev = max(prev, e)
    return raw_pieces


def hot_insertion_mask(weights, coverage, min_cov) -> torch.Tensor:
    """bool[TB, L]: columns whose total insertion weight is >= 0.5 * cov, or
    where no base (nor the gap) reaches 0.45 * cov at coverage >= 3 (a
    collapsed repeat longer than the band smears into mismatches), at
    coverage >= max(min_cov, 2). The per-column majority fragments such runs
    across co-optimal alignment phasings; these columns get the host
    link-DP repair. The insertion weights are summed in float64."""
    ins_w = weights[:, 1:, :4, :].sum(dim=(1, 2), dtype=torch.float64)
    covf = coverage.clamp(min=1).to(torch.float32)
    weak = (weights[:, 0].amax(dim=1) < 0.45 * covf) & (coverage >= 3)
    return ((ins_w >= 0.5 * covf) | weak) & (coverage >= max(min_cov, 2))


def consensus_stream(weights, coverage, min_cov, ins_frac, ins_offset):
    """call_consensus compacted on the device: (stream u8[TB, SL], cum_t
    i32[TB, L], n_emit i32[TB], cov8 u8[TB, L]). Row b of the stream holds
    its emitted bases in (t asc, delta asc) order; cum_t[b, t] counts them
    through column t, so a piece (s, e) is stream[b, cum_t[b, s-1]:cum_t[b,
    e-1]]. SL = max(n_emit), read with one sync: no emitted base is dropped
    (necat_tpu sizes the stream in advance and drops what overflows it)."""
    emit, base = call_consensus(weights, coverage, min_cov, ins_frac, ins_offset)
    TB, L, D = emit.shape
    em = emit.reshape(TB, L * D)
    idx = torch.cumsum(em, dim=1, dtype=torch.int32) - 1
    n_emit = idx[:, -1] + 1
    SL = int(n_emit.max()) if TB else 0
    stream = torch.zeros((TB, SL + 1), dtype=torch.uint8, device=weights.device)
    stream.scatter_(1, torch.where(em, idx, SL).long(), base.reshape(TB, L * D))
    cum_t = torch.cumsum(emit.sum(dim=2, dtype=torch.int32), dim=1, dtype=torch.int32)
    cov8 = coverage.clamp(max=255).to(torch.uint8)      # only >= min_cov is read
    return stream[:, :SL], cum_t, n_emit, cov8


def compact_from_stream(
    stream: np.ndarray,    # uint8[TB, SL] (host)
    cum_t: np.ndarray,     # int32[TB, L]
    coverage: np.ndarray,  # int[TB, L]
    tlens: np.ndarray,
    templates: Sequence[np.ndarray],   # uint8[TB, L], or one row (a view) a template
    min_cov: int,
    min_size: int,
    raw_min_gap: int,
    overrides: dict | None = None,   # row -> {t -> np.ndarray of bases}
    cut_at: dict | None = None,      # row -> template positions to cut runs at
    min_run: int | None = None,
) -> List[Tuple[List[Tuple[int, int, np.ndarray]], List[Tuple[int, int, np.ndarray]]]]:
    """Host side of consensus_stream: per template (cns_pieces, raw_pieces)
    as compact_from_packed gives them, with the same min_run (covered runs
    shorter than it are dropped; default min_size). `overrides` replaces the
    emitted bases of single template positions (the link-DP hotspot repair,
    consensus/correct.py _bucket_hot_overrides); `cut_at` splits covered
    runs at the given positions so that no piece spans them (the window
    seams of polish/polish.py)."""
    if min_run is None:
        min_run = min_size
    out = []
    for b in range(stream.shape[0]):
        n = int(tlens[b])
        cov = coverage[b, :n] >= min_cov
        cns_pieces: List[Tuple[int, int, np.ndarray]] = []
        if n == 0:
            out.append((cns_pieces, []))
            continue
        ovr = (overrides or {}).get(b) or {}
        dif = np.diff(np.r_[0, cov.astype(np.int8), 0])
        starts = np.flatnonzero(dif == 1)
        ends = np.flatnonzero(dif == -1)
        cuts = sorted((cut_at or {}).get(b) or [])
        if cuts:
            s2, e2 = [], []
            for s, e in zip(starts, ends):
                prev = int(s)
                for c in cuts:
                    if prev < c < e:
                        s2.append(prev)
                        e2.append(c)
                        prev = c
                s2.append(prev)
                e2.append(int(e))
            starts, ends = s2, e2
        for s, e in zip(starts, ends):
            if e - s < min_run:
                continue
            lo = int(cum_t[b, s - 1]) if s > 0 else 0
            hi = int(cum_t[b, e - 1])
            touched = sorted(t for t in ovr if s <= t < e)
            if touched:
                parts = []
                prev = int(s)
                for t in touched:
                    plo = int(cum_t[b, prev - 1]) if prev > 0 else 0
                    tlo = int(cum_t[b, t - 1]) if t > 0 else 0
                    parts.append(stream[b, plo:tlo])
                    parts.append(np.asarray(ovr[t], np.uint8))
                    prev = t + 1
                plo = int(cum_t[b, prev - 1]) if prev > 0 else 0
                parts.append(stream[b, plo:hi])
                seq = np.concatenate(parts)
            else:
                seq = stream[b, lo:hi]
            if len(seq) >= min_size:
                cns_pieces.append((int(s), int(e), seq.astype(np.uint8)))
        out.append((cns_pieces, _raw_pieces(cns_pieces, n, templates[b], raw_min_gap)))
    return out
