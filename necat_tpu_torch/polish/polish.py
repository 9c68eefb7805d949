"""Contig polishing, the ctgcns stage (counterpart of necat_tpu/polish/polish.py).

Rebuild of src/ctg_cns/ (runPolishContigs, necat.pl:1382-1430): contigs are cut
into fixed windows (kCtgSegmentSize = 1 Mb in the reference, cns_one_ctg.c:14;
configurable here), reads are mapped to the windows, and each window runs the
same tag-tensor consensus as read correction with weight-1 alignments and a
fixed identity cutoff (consensus_one_read_m4, consensus/consensus_one_read.c:
409-544: min_cov=1, max_cov=12, min_size=500, ident >= 90). Uncovered window
stretches keep the input contig bases so polished contigs stay full-length.
The mapping and the correction run on `device`; the correction takes its
wide-delta path (max_delta 22: the stream consensus and the host link-DP
repair of insertion hotspots).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

import numpy as np

from necat_tpu_torch.consensus.correct import correct_reads, seconds_by_part
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.candidates import Candidates
from necat_tpu_torch.overlap.options import MapOptions
from necat_tpu_torch.overlap.overlapper import find_all_candidates


@dataclasses.dataclass(frozen=True)
class PolishOptions:
    segment_size: int = 262144     # contig window (reference: 1 Mb)
    min_ident: float = 80.0        # fixed acceptance cutoff for read->ctg alignments
    min_cov: int = 1               # consensus_one_read_m4 constants
    max_cov: int = 12
    min_size: int = 500
    templates_per_batch: int = 4
    pairs_per_chunk: int = 32
    band_width: int = 256          # raw reads vs contig: wider band
    # insertion states per template position: the reference's ctg_cns uses
    # u16 deltas (fc_correct_one_read.h:17-19) because contigs can miss
    # multi-base chunks that every read shows as a long insertion run; 22
    # covers runs up to 21 inserted bases (3 insb words x 7)
    max_delta: int = 22
    # windows overlap by `halo` on each side so reads near a seam align with
    # full context; only the core [halo, halo+segment) of each window is kept
    halo: int = 5000
    # filter_m4 role (src/ctg_cns/filter_m4.c:63-118): a read's candidates
    # survive only toward its best-scoring contig, and reads whose
    # second-best contig scores >= ambiguity_ratio x best are dropped
    unique_placement: bool = True
    ambiguity_ratio: float = 0.8


def split_contigs(contigs: ReadStore, seg_len: int, halo: int = 0
                  ) -> Tuple[ReadStore, List[Tuple[int, int, int]]]:
    """Cut contigs into windows of `seg_len` cores with `halo` extra context
    on each side; returns (segments, [(ctg, core_start, win_start)])."""
    seqs, names, info = [], [], []
    for c in range(contigs.n_reads):
        seq = contigs.get(c)
        for s in range(0, len(seq), seg_len):
            w0 = max(0, s - halo)
            w1 = min(len(seq), s + seg_len + halo)
            seqs.append(seq[w0:w1])
            names.append(f"{contigs.names[c]}:{s}")
            info.append((c, s, w0))
    return ReadStore.from_seqs(seqs, names), info


def _filter_unique_placement(cands: Candidates, info,
                             ambiguity_ratio: float) -> Candidates:
    """filter_m4 role (src/ctg_cns/filter_m4.c): per read, keep candidates
    only toward its best-scoring contig; drop reads whose second-best contig
    is within ambiguity_ratio of the best (the reference's exactly-one-full-
    mapping rule, :109-118)."""
    seg_ctg = np.array([c for (c, _, _) in info], dtype=np.int64)
    ctg = seg_ctg[cands.sid]
    qid = cands.qid.astype(np.int64)
    # per (read, contig) total score via sorted segment reduction
    order = np.lexsort((ctg, qid))
    q_s, c_s, sc_s = qid[order], ctg[order], cands.score[order].astype(np.int64)
    new_grp = np.r_[True, (q_s[1:] != q_s[:-1]) | (c_s[1:] != c_s[:-1])]
    gidx = np.cumsum(new_grp) - 1
    tot = np.zeros(int(gidx[-1]) + 1, np.int64)
    np.add.at(tot, gidx, sc_s)
    g_q = q_s[new_grp]
    g_c = c_s[new_grp]
    # best / second-best contig per read
    go = np.lexsort((-tot, g_q))
    first = np.r_[True, g_q[go][1:] != g_q[go][:-1]]
    best_i = go[first]
    n_reads = int(qid.max()) + 1
    best_ctg = np.full(n_reads, -1, np.int64)
    best_sc = np.zeros(n_reads, np.int64)
    second_sc = np.zeros(n_reads, np.int64)
    best_ctg[g_q[best_i]] = g_c[best_i]
    best_sc[g_q[best_i]] = tot[best_i]
    starts = np.flatnonzero(first)
    pos_in_read = np.arange(len(go)) - np.repeat(starts, np.diff(np.r_[starts, len(go)]))
    sec = go[pos_in_read == 1]
    second_sc[g_q[sec]] = tot[sec]
    ambiguous = second_sc >= ambiguity_ratio * np.maximum(best_sc, 1)
    keep = (ctg == best_ctg[qid]) & ~ambiguous[qid]
    return cands.take(np.flatnonzero(keep))


def polish_contigs(contigs: ReadStore, reads: ReadStore, *, device="cuda",
                   map_opts: MapOptions | None = None,
                   opts: PolishOptions = PolishOptions()) -> ReadStore:
    """Polish contigs with reads on `device`; returns the polished contigs."""
    if contigs.n_reads == 0:
        return contigs
    if map_opts is None:
        map_opts = MapOptions(scan_window=5, ncan=20, block_score_cutoff=2,
                              max_hits=1 << 20, max_pairs=8192)
    segments, info = split_contigs(contigs, opts.segment_size, opts.halo)

    # read -> segment candidates; the combined store puts segments after reads
    t0 = time.perf_counter()
    cands = find_all_candidates(reads, segments, map_opts, pairwise=False,
                                device=device)
    if opts.unique_placement and len(cands):
        cands = _filter_unique_placement(cands, info, opts.ambiguity_ratio)
    seconds_by_part["map"] += time.perf_counter() - t0
    offset = reads.n_reads
    cands = dataclasses.replace(cands, sid=cands.sid + offset)
    combined = ReadStore.concat([reads, segments])

    cns_opts = CnsOptions(
        use_fixed_ident_cutoff=True, error=1.0 - opts.min_ident / 100.0,
        min_cov=opts.min_cov, max_cov=opts.max_cov, min_size=opts.min_size,
        raw_min_gap=1 << 30,  # gaps are filled from the template below instead
        max_delta=opts.max_delta,
        templates_per_batch=opts.templates_per_batch,
        pairs_per_chunk=opts.pairs_per_chunk,
        band_width=opts.band_width,
        # the reference's ctg_cns aligns with the unbounded DALIGNER wave
        # (fc_correct_one_read.h:17-20): without the band-doubling ladder, a
        # collapsed repeat longer than band/2 never threads as a clean
        # insertion run, so the hotspot reassembly never sees it
        rescue_long_indels=True)
    # pieces are cut exactly at each window's core edges, so that the halo
    # parts can be dropped whole
    cuts = {}
    for seg_idx, (ctg, start, w0) in enumerate(info):
        core_lo = start - w0
        core_hi = core_lo + opts.segment_size
        cc = [c for c in (core_lo, core_hi) if 0 < c < int(segments.lengths[seg_idx])]
        if cc:
            cuts[seg_idx + offset] = cc
    recs = correct_reads(combined, cands, cns_opts, device=device,
                         min_cov_for_template=1, emit_uncorrected=False,
                         template_cuts=cuts)

    # stitch: per segment core, covered spans from the consensus, the rest
    # from the template; halo regions belong to the neighbouring windows
    by_seg = {}
    for r in recs:
        if r.corrected:
            by_seg.setdefault(r.tid - offset, []).append(r)
    polished_seqs: List[list] = [[] for _ in range(contigs.n_reads)]
    for seg_idx in range(segments.n_reads):
        ctg, start, w0 = info[seg_idx]
        template = segments.get(seg_idx)
        core_lo = start - w0
        core_hi = min(core_lo + opts.segment_size, len(template))
        pieces = sorted((r for r in by_seg.get(seg_idx, [])
                         if r.left >= core_lo and r.right <= core_hi),
                        key=lambda r: r.left)
        out = []
        pos = core_lo
        for p in pieces:
            if p.left > pos:
                out.append(template[pos:p.left])
            out.append(p.seq)
            pos = max(pos, p.right)
        if pos < core_hi:
            out.append(template[pos:core_hi])
        polished_seqs[ctg].append(
            np.concatenate(out) if out else template[core_lo:core_hi])
    final = [np.concatenate(parts) for parts in polished_seqs]
    return ReadStore.from_seqs(final, [f"{n}_polished" for n in contigs.names])
