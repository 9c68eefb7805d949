"""TRIM_METHOD=accurate: largest cover range + per-read re-consensus (the
port's copy of necat_tpu/trim/accurate.py; the consensus runs on a device
the caller names).

Rebuild of the reference's accurate trim path (necat.pl:945-1110
runTrimAccurate; src/trim_bases_accurate/): unlike the fast path (trim/lcr.py),
the accurate variant does not clip the raw read, it re-corrects it over the
cover range:

  1. overlaps filtered at error cutoff 0.09 (necat.pl:1033, oc2pm4 errCut),
  2. per read: overlaps sorted by identity, capped at 300
     (largest_cover_range.c:12 kMaxM4PerRead),
  3. accurate largest_cover_range: plain interval algebra over all its
     overlaps (no dovetail qualification or chimera pass in this variant,
     trim_bases_accurate/largest_cover_range.c:14-117),
  4. a consensus pass over [left, right): covering reads re-aligned in waves
     of 50 until max_cov=12, acceptance at identity >= 90, FALCON-sense tag
     consensus, and the single largest min_cov-covered run >= 500 bp emitted
     as the trimmed read (consensus_one_read_m4,
     src/consensus/consensus_one_read.c:409-544).

Step 4 reuses the correction engine (consensus/correct.py) with fixed-cutoff
options on window-clipped templates, appended to the read store after the
reads.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from necat_tpu_torch.consensus.correct import correct_reads
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.candidates import Candidates
from necat_tpu_torch.overlap.m4 import M4Records
from necat_tpu_torch.trim.lcr import largest_cover_range


@dataclasses.dataclass(frozen=True)
class TrimAccurateOptions:
    min_ident: float = 91.0      # 100*(1 - 0.09), necat.pl:1033
    min_ovlp: int = 1
    min_cov: int = 1
    min_size: int = 500
    max_m4_per_read: int = 300   # kMaxM4PerRead
    # consensus_one_read_m4 constants (consensus_one_read.c:439-441, 495)
    cns_min_ident: float = 90.0
    cns_max_cov: int = 12
    cns_min_align_size: int = 400


def trim_reads_accurate(store: ReadStore, m4: M4Records,
                        opts: TrimAccurateOptions = TrimAccurateOptions(),
                        cns_overrides: dict | None = None, *,
                        device="cuda") -> Tuple[ReadStore, np.ndarray, np.ndarray]:
    """Accurate-trim every read, the consensus on `device`. `m4` holds each
    overlap once (role expansion happens here, the oc2pm4 duplication).
    Returns (trimmed_store, kept_read_ids, cover_ranges[N, 2]); the output
    sequences are consensus sequences over the cover range, not raw clips."""
    full = M4Records.concat([m4, m4.swap_roles()])
    full = full.take(np.flatnonzero(full.ident >= opts.min_ident))
    empty = (ReadStore.from_seqs([]), np.zeros(0, np.int64),
             np.zeros((0, 2), np.int64))
    if len(full) == 0:
        return empty

    # per-subject groups, identity-descending, capped (lcr_worker ordering)
    order = np.lexsort((-full.ident, full.sid))
    sid_sorted = full.sid[order]
    bounds = np.flatnonzero(np.r_[True, sid_sorted[1:] != sid_sorted[:-1]])
    bounds = np.r_[bounds, len(order)]

    tpl_ids = []          # original read id per emitted template
    ranges = []
    tpl_m4_idx = []       # rows of `full` per template (capped)
    for i in range(len(bounds) - 1):
        s, e = bounds[i], bounds[i + 1]
        idx = order[s:min(e, s + opts.max_m4_per_read)]
        r = largest_cover_range(full.soff[idx], full.send[idx],
                                opts.min_cov, opts.min_ovlp)
        if r is None or r[1] - r[0] < opts.min_size:
            continue
        tpl_ids.append(int(sid_sorted[s]))
        ranges.append(r)
        tpl_m4_idx.append(idx)
    if not tpl_ids:
        return empty
    ranges = np.array(ranges, np.int64).reshape(-1, 2)

    # window-clipped templates appended after the reads in a combined store
    tpl_seqs = [store.get(t)[l:r] for t, (l, r) in zip(tpl_ids, ranges)]
    tpls = ReadStore.from_seqs(tpl_seqs, [store.names[t] for t in tpl_ids])
    offset = store.n_reads
    combined = ReadStore(
        bases=np.concatenate([store.bases, tpls.bases]),
        offsets=np.concatenate([store.offsets,
                                tpls.offsets[1:] + store.offsets[-1]]),
        names=store.names + tpls.names)

    # overlaps -> candidates against the clipped templates (anchor at the
    # overlap's start corner, coordinates shifted by the window start)
    parts = []
    for ti, idx in enumerate(tpl_m4_idx):
        sub = full.take(idx)
        l, r = ranges[ti]
        keep = np.flatnonzero((sub.send > l) & (sub.soff < r))
        if len(keep) == 0:
            continue
        sub = sub.take(keep)
        sb = np.clip(sub.soff - l, 0, r - l)
        se = np.clip(sub.send - l, 0, r - l)
        # clip the query range proportionally to the subject clipping
        span = np.maximum(sub.send - sub.soff, 1)
        qb = sub.qoff + (sub.qend - sub.qoff) * np.maximum(l - sub.soff, 0) // span
        qe = sub.qend - (sub.qend - sub.qoff) * np.maximum(sub.send - r, 0) // span
        parts.append(Candidates(
            qid=sub.qid.astype(np.int32),
            sid=np.full(len(sub), ti + offset, np.int32),
            qdir=sub.qdir.astype(np.int8),
            score=sub.vscore.astype(np.int32),
            qbeg=qb.astype(np.int32), qend=qe.astype(np.int32),
            sbeg=sb.astype(np.int32), send=se.astype(np.int32),
            qsize=sub.qsize.astype(np.int32),
            ssize=(r - l) * np.ones(len(sub), np.int32)))
    cands = Candidates.concat(parts)

    cns_opts = CnsOptions(
        use_fixed_ident_cutoff=True,
        error=1.0 - opts.cns_min_ident / 100.0,
        min_cov=opts.min_cov, max_cov=opts.cns_max_cov,
        min_size=opts.min_size, min_align_size=opts.cns_min_align_size,
        raw_min_gap=1 << 30)
    if cns_overrides:
        cns_opts = dataclasses.replace(cns_opts, **cns_overrides)
    recs = correct_reads(combined, cands, cns_opts, device=device, min_cov_for_template=1,
                         emit_uncorrected=False)

    # one output read per template: the largest covered consensus run
    # (consensus_one_read.c:508-531 max_from/max_to selection)
    best: dict = {}
    for rec in recs:
        if not rec.corrected or rec.tid < offset:
            continue
        ti = rec.tid - offset
        if ti not in best or len(rec.seq) > len(best[ti].seq):
            best[ti] = rec
    kept, seqs, names, out_ranges = [], [], [], []
    for ti in sorted(best):
        rec = best[ti]
        if len(rec.seq) < opts.min_size:
            continue
        kept.append(tpl_ids[ti])
        seqs.append(rec.seq)
        names.append(store.names[tpl_ids[ti]])
        out_ranges.append((ranges[ti][0] + rec.left, ranges[ti][0] + rec.right))
    return (ReadStore.from_seqs(seqs, names), np.array(kept, np.int64),
            np.array(out_ranges, np.int64).reshape(-1, 2))
