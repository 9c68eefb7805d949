"""Read correction driver: candidates -> wave-based extension -> tag consensus.

Counterpart of necat_tpu/consensus/correct.py, fused single-device mode:
templates are bucketed (TB rows per consensus tensor) in descending length
order; per supergroup, the reference's per-template wave loop
(consensus_one_read.c:317-372) runs as host-side selection over a coverage
mirror, every chunk of a wave runs gather -> extend -> accept -> scatter on
the device (consensus/fused.py), and the consensus of each bucket comes back
as one packed int32 per template column. With rescue_long_indels, pairs
whose extension stops > 200 bp short of the candidate climb a band-doubling
ladder (W0 * rescue_band_scale, doubling up to rescue_band_max_scale and
shapes.MAX_BAND).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List

import numpy as np
import torch

from necat_tpu_torch.align.banded_kernels import N_INSB
from necat_tpu_torch.align.engine import ExtendEngine, rescue_widths
from necat_tpu_torch.consensus import fused
from necat_tpu_torch.consensus.backbone import compact_from_packed, consensus_packed
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.io.devstore import DeviceReadStore
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.candidates import Candidates
from necat_tpu_torch.utils import shapes
from necat_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class CnsRecord:
    tid: int
    left: int
    right: int
    org_size: int
    seq: np.ndarray
    corrected: bool


def group_by_template(cands: Candidates, max_examined: int) -> Dict[int, np.ndarray]:
    """Sort candidates by (sid, score desc), keep the best candidate per
    (sid, qid) (each query extended at most once per template,
    consensus_one_read.c:330-338), cap at max_examined. Returns sid ->
    candidate index array."""
    if len(cands) == 0:
        return {}
    order = np.lexsort((-cands.score, cands.qid, cands.sid))
    sid_s, qid_s = cands.sid[order], cands.qid[order]
    first = np.r_[True, (sid_s[1:] != sid_s[:-1]) | (qid_s[1:] != qid_s[:-1])]
    order = order[first]
    order = order[np.lexsort((-cands.score[order], cands.sid[order]))]
    sid_sorted = cands.sid[order]
    bounds = np.flatnonzero(np.r_[True, sid_sorted[1:] != sid_sorted[:-1]])
    bounds = np.r_[bounds, len(order)]
    groups: Dict[int, np.ndarray] = {}
    for i in range(len(bounds) - 1):
        s, e = bounds[i], bounds[i + 1]
        groups[int(sid_sorted[s])] = order[s:min(e, s + max_examined)]
    return groups


def _check_supported(opts: CnsOptions, store: ReadStore, device) -> None:
    """The port runs the default configuration on one device only; refuse the
    others rather than run something else."""
    if not isinstance(opts, CnsOptions) or not isinstance(store, ReadStore):
        raise TypeError("correct_reads takes necat_tpu_torch's CnsOptions and ReadStore, "
                        f"not {type(opts).__module__}/{type(store).__module__}")
    unsupported = {
        "more than one device": isinstance(device, (list, tuple)),
        "small_memory": opts.small_memory or store.total_bases >= (1 << 31),
        "fused=False": opts.fused is False,
        "3*max_delta > 30 (stream consensus)": 3 * opts.max_delta > 30,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"necat_tpu_torch.correct_reads: {', '.join(bad)} "
                                  "not ported")


def correct_reads(store: ReadStore, cands: Candidates,
                  opts: CnsOptions = CnsOptions(), *, device,
                  min_cov_for_template: int | None = None,
                  emit_uncorrected: bool = True) -> List[CnsRecord]:
    """Correct all templates that have candidates, on one `device`. `cands`
    must be role-expanded (each overlap present for both reads as templates).
    Records come in the order of necat_tpu's correct_reads: uncorrected
    passthrough first, then templates by descending length."""
    _check_supported(opts, store, device)
    dev = resolve_device(device)
    groups = group_by_template(cands, opts.max_examined)
    min_need = opts.min_cov if min_cov_for_template is None else min_cov_for_template
    tids_all = np.array([t for t in sorted(groups) if len(groups[t]) >= min_need],
                        dtype=np.int64)
    records: List[CnsRecord] = []
    if emit_uncorrected:
        have = set(tids_all.tolist())
        for r in range(store.n_reads):
            if r not in have:
                records.append(CnsRecord(tid=r, left=0, right=int(store.lengths[r]),
                                         org_size=int(store.lengths[r]),
                                         seq=store.get(r), corrected=False))
    if not len(tids_all):
        return records
    tids_sorted = tids_all[np.argsort(-store.lengths[tids_all], kind="stable")]
    qdev = DeviceReadStore(store, dev)
    engine = ExtendEngine(qdev, qdev, opts.pairs_per_chunk)
    SG = opts.templates_per_batch * (opts.buckets_per_supergroup or 1)
    for s in range(0, len(tids_sorted), SG):
        buckets = _run_supergroup(store, engine, cands, groups,
                                  tids_sorted[s:s + SG], opts)
        records.extend(_compact_supergroup(store, buckets, opts))
    return records


class _Bucket:
    """TB template rows with their consensus tensors on the device. Weights
    accumulate in float64: the sums of the f32 pair weights are exact there,
    so the result does not depend on the order of the additions (atomics on
    the card, sequential on the CPU); consensus_packed reads them as f32."""

    def __init__(self, store, ids, TB, D, device):
        self.n_real = len(ids)
        self.ids = (np.concatenate([ids, np.repeat(ids[-1:], TB - len(ids))])
                    if len(ids) < TB else ids)
        self.Lt = shapes.length_tier(int(store.lengths[self.ids].max()))
        self.tlens = store.lengths[self.ids].astype(np.int64).copy()
        self.tlens[self.n_real:] = 0     # padding rows emit nothing
        self.weights = torch.zeros((TB + 1, D, 5, self.Lt), dtype=torch.float64,
                                   device=device)
        self.covten = torch.zeros((TB + 1, self.Lt), dtype=torch.int32,
                                  device=device)
        self.packed = None


class _Tpl:
    __slots__ = ("tid", "bucket", "row", "n", "cand_idx")

    def __init__(self, tid, bucket, row, n, cand_idx):
        self.tid = tid
        self.bucket = bucket
        self.row = row
        self.n = n
        self.cand_idx = cand_idx


class _SelState:
    """Vectorised wave-selection state of one supergroup: flat candidate
    arrays and one concatenated per-template coverage mirror (cov_buf)."""

    def __init__(self, tpls):
        self.n_tpl = len(tpls)
        lens = np.array([len(t.cand_idx) for t in tpls], dtype=np.int64)
        self.cand_len = lens
        self.cand_start = np.zeros(self.n_tpl, np.int64)
        if self.n_tpl > 1:
            np.cumsum(lens[:-1], out=self.cand_start[1:])
        self.cand_li = np.repeat(np.arange(self.n_tpl, dtype=np.int64), lens)
        self.cand_ci = (np.concatenate([np.asarray(t.cand_idx) for t in tpls])
                        if self.n_tpl else np.zeros(0, np.int64)).astype(np.int64)
        self.cand_pos = (np.arange(int(lens.sum()), dtype=np.int64)
                         - np.repeat(self.cand_start, lens))
        self.cursor = np.zeros(self.n_tpl, np.int64)
        self.tpl_n = np.array([t.n for t in tpls], dtype=np.int64)
        self.tpl_off = np.zeros(self.n_tpl + 1, np.int64)
        np.cumsum(self.tpl_n, out=self.tpl_off[1:])
        self.cov_buf = np.zeros(int(self.tpl_n.sum()), np.int32)
        self.tpl_row = np.array([t.row for t in tpls], dtype=np.int64)
        self.tpl_bucket = np.array([t.bucket for t in tpls], dtype=np.int64)
        self.tpl_tid = np.array([t.tid for t in tpls], dtype=np.int64)


def _select_wave(st: _SelState, cands, round_id: int, wave: int, max_cov: int):
    """One wave of (template, candidate) pairs: per template, scan pending
    candidates in score order, skip those whose span is already at max_cov
    (rounds > 0), take up to `wave`; skipped and taken are both consumed.
    Returns (p_tpl, p_ci, slots), slots = per-template take rank (the
    round-0 ident-buffer slot)."""
    empty = (np.zeros(0, np.int64),) * 3
    if st.n_tpl == 0 or len(st.cand_li) == 0:
        return empty
    pend = st.cand_pos >= st.cursor[st.cand_li]
    if not pend.any():
        return empty
    if round_id > 0:
        # a candidate is skippable iff its span holds no under-covered column
        U = np.empty(len(st.cov_buf) + 1, np.int64)
        U[0] = 0
        np.cumsum(st.cov_buf < max_cov, out=U[1:])
        off = st.tpl_off[st.cand_li]
        n = st.tpl_n[st.cand_li]
        sb = np.clip(cands.sbeg[st.cand_ci], 0, n)
        se = np.clip(cands.send[st.cand_ci], 0, n)
        elig = pend & ((U[off + se] - U[off + sb]) > 0)
    else:
        elig = pend
    cs = np.cumsum(elig)
    pre = np.concatenate([[0], cs])[st.cand_start]
    rank = cs - np.repeat(pre, st.cand_len)          # 1-based among eligible
    take = elig & (rank <= wave)
    idx = np.flatnonzero(take)
    tk_li = st.cand_li[idx]
    cnt = np.bincount(tk_li, minlength=st.n_tpl)
    last = np.full(st.n_tpl, -1, np.int64)
    np.maximum.at(last, tk_li, st.cand_pos[idx])
    act = np.zeros(st.n_tpl, bool)
    act[st.cand_li[pend]] = True
    newcur = np.where(cnt >= wave, last + 1, st.cand_len)
    st.cursor = np.where(act, newcur, st.cursor)
    return tk_li, st.cand_ci[idx], (rank[idx] - 1)


def _apply_cov(st: _SelState, li_acc, tl_acc, tr_acc) -> None:
    """cov[tl:tr] += 1 for every accepted pair, as one diff + cumsum pass."""
    if len(li_acc) == 0:
        return
    d = np.zeros(len(st.cov_buf) + 1, np.int32)
    off = st.tpl_off[li_acc]
    n = st.tpl_n[li_acc]
    np.add.at(d, off + np.clip(tl_acc, 0, n), 1)
    np.add.at(d, off + np.clip(tr_acc, 0, n), -1)
    st.cov_buf += np.cumsum(d[:len(st.cov_buf)], dtype=np.int32)


def _insb_words(opts: CnsOptions) -> int:
    return min(max(-(-max(opts.max_delta - 1, 1) // N_INSB), 1), 3)


def _rungs(opts: CnsOptions):
    return rescue_widths(opts.band_width, opts.rescue_band_scale,
                         opts.rescue_band_max_scale)


def _hang(stats, cands, p_ci):
    """Query bases of each pair's candidate range left unaligned."""
    return (np.maximum(stats["qoff"] - cands.qbeg[p_ci], 0)
            + np.maximum(cands.qend[p_ci] - stats["qend"], 0))


def _ident_ladder(run, ident_chunks, npairs, cands, p_ci, slots,
                  opts: CnsOptions) -> np.ndarray:
    """Round-0 rescue: lanes of the ident pass that hang re-run the ident
    pass on the rungs (cols_guard keeps each lane's best rung in the ident
    buffer). Returns the band each lane scatters at: its best rung."""
    fused.release_bufs(ident_chunks)
    s0 = fused.new_fused_stats(npairs)
    fused.collect_fused(ident_chunks, s0)
    lane_w = np.full(npairs, opts.band_width, np.int64)
    best_c = s0["n_cols"].copy()
    bad = np.flatnonzero(_hang(s0, cands, p_ci) > 200)
    for Wx in _rungs(opts):
        if not len(bad):
            break
        wch = run(bad, W=Wx, slots=slots[bad], nc0=best_c[bad], cols_guard=True)
        fused.release_bufs(wch)
        s1 = fused.new_fused_stats(npairs)
        fused.collect_fused(wch, s1, sel=bad)
        imp = s1["n_cols"][bad] >= best_c[bad]
        lane_w[bad[imp]] = Wx
        best_c[bad] = np.maximum(best_c[bad], s1["n_cols"][bad])
        h1 = _hang(s1, cands, p_ci)[bad]
        bad = bad[(h1 > 200) | ~imp]     # a rung counts only if it kept the result
    return lane_w


def _defer_ladder(run, stats, cands, p_ci, opts: CnsOptions) -> None:
    """Rounds > 0: deferred lanes climb the rungs with the hang check and the
    best-cols guard (the last rung defers no more); lanes still deferred
    after the ladder replay at their best band."""
    npairs = len(p_ci)
    di = np.flatnonzero(stats["deferred"])
    best_w = np.full(npairs, opts.band_width, np.int64)
    best_c = stats["n_cols"].copy()
    rungs = list(_rungs(opts))
    for r, Wx in enumerate(rungs):
        if not len(di):
            break
        ch = run(di, W=Wx, qend_cand=cands.qend[p_ci[di]].astype(np.int64),
                 nc0=best_c[di], cols_guard=True,
                 rescue_defer=r + 1 < len(rungs))
        prev_c = best_c[di].copy()
        fused.collect_fused(ch, stats, sel=di)
        new_c = stats["n_cols"][di]
        best_w[di[new_c >= prev_c]] = Wx
        best_c[di] = np.maximum(new_c, prev_c)
        di = di[stats["deferred"][di]]
    for Wx in np.unique(best_w[di]):
        sel_w = di[best_w[di] == Wx]
        fused.collect_fused(run(sel_w, W=int(Wx)), stats, sel=sel_w)


def _run_waves(engine, cands, buckets, opts: CnsOptions, st: _SelState) -> None:
    """Waves until no template has pending candidates: round 0 estimates the
    identity cutoffs (unless fixed) and scatters from the ident pass's
    retained buffers; later rounds extend, accept and scatter in one step.
    Without rescue the only host syncs are the per-chunk stats that feed the
    coverage mirror; the rescue ladder reads each rung's stats."""
    TB = opts.templates_per_batch
    dev = engine.device
    estimating = not opts.use_fixed_ident_cutoff
    cut0 = 0.0 if estimating else 100.0 * (1.0 - opts.error)
    cutoffs = {bi: torch.full((TB + 1,), cut0, dtype=torch.float32, device=dev)
               for bi in range(len(buckets))}
    tensors = {bi: (b.weights, b.covten) for bi, b in enumerate(buckets)}
    insb_words = _insb_words(opts)
    rescue = opts.rescue_long_indels
    W0 = opts.band_width
    round_id = 0 if estimating else 1        # consensus_one_read.c:273-278
    max_rounds = -(-opts.max_examined // opts.wave_size) + 1
    offsets = engine.qdev.offsets
    while round_id <= max_rounds:
        wave = (opts.n_ident + 10) if round_id == 0 else opts.wave_size
        p_tpl, p_ci, slots = _select_wave(st, cands, round_id, wave, opts.max_cov)
        if len(p_tpl) == 0:
            if round_id == 0:
                round_id += 1
                continue
            break
        base = dict(qids=cands.qid[p_ci], qdir=cands.qdir[p_ci].astype(np.int32),
                    qsize=cands.qsize[p_ci].astype(np.int64),
                    tg_base=offsets[st.tpl_tid[p_tpl]],
                    tsize_full=st.tpl_n[p_tpl],
                    aq=cands.qbeg[p_ci].astype(np.int64),
                    at_abs=cands.sbeg[p_ci].astype(np.int64),
                    rows=st.tpl_row[p_tpl], groups=st.tpl_bucket[p_tpl],
                    insb_words=insb_words, min_align_size=opts.min_align_size,
                    mapping_ratio=opts.mapping_ratio,
                    good_end_margin=opts.good_end_margin,
                    cutoffs=cutoffs, tensors=tensors,
                    allow_fullcov=round_id > 0)

        def run(idx, base=base, **kw):
            """dispatch_wave over the pairs idx of this wave."""
            d = {k: (v[idx] if isinstance(v, np.ndarray) else v)
                 for k, v in base.items()}
            return fused.dispatch_wave(engine, **d, **kw)

        npairs = len(p_ci)
        stats = fused.new_fused_stats(npairs)
        if round_id == 0:
            if wave > fused.IDENT_SLOTS:
                raise ValueError("n_ident + 10 must fit fused.IDENT_SLOTS")
            ibufs = {bi: torch.zeros((TB + 1, fused.IDENT_SLOTS, 3),
                                     dtype=torch.float32, device=dev)
                     for bi in sorted({int(g) for g in base["groups"]})}
            chunks = fused.dispatch_wave(engine, **base, W=W0, slots=slots,
                                         ibufs=ibufs)
            run0 = functools.partial(run, ibufs=ibufs)
            lane_w = (_ident_ladder(run0, chunks, npairs, cands, p_ci, slots,
                                    opts) if rescue else None)
            for bi, ib in ibufs.items():
                cutoffs[bi] = fused.cutoff_from_idents(ib, n_ident=opts.n_ident)
            if lane_w is None:
                fused.scatter_round0(chunks, cutoffs, tensors, opts.min_align_size,
                                     opts.mapping_ratio)
                fused.collect_fused(chunks, stats)
            else:        # the band of each lane is decided: scatter at it
                for Wx in np.unique(lane_w):
                    idx = np.flatnonzero(lane_w == Wx)
                    fused.collect_fused(run(idx, W=int(Wx)), stats, sel=idx)
        else:
            chunks = fused.dispatch_wave(
                engine, **base, W=W0, rescue_defer=rescue,
                qend_cand=cands.qend[p_ci].astype(np.int64))
            fused.collect_fused(chunks, stats)
            if rescue:
                _defer_ladder(run, stats, cands, p_ci, opts)
        acc = np.flatnonzero(stats["ok"])
        _apply_cov(st, p_tpl[acc], stats["toff"][acc], stats["tend"][acc])
        round_id += 1


def _run_supergroup(store, engine, cands, groups, sg_ids, opts: CnsOptions):
    """Waves of one supergroup, then the consensus call of each bucket;
    returns the buckets with their packed consensus on the device."""
    TB = opts.templates_per_batch
    buckets: List[_Bucket] = []
    tpls: List[_Tpl] = []
    for bi in range(0, len(sg_ids), TB):
        b = _Bucket(store, sg_ids[bi:bi + TB], TB, opts.max_delta, engine.device)
        buckets.append(b)
        for row in range(b.n_real):
            tid = int(b.ids[row])
            tpls.append(_Tpl(tid, len(buckets) - 1, row, int(b.tlens[row]),
                             groups[tid]))
    _run_waves(engine, cands, buckets, opts, _SelState(tpls))
    for b in buckets:
        b.packed = consensus_packed(b.weights[:TB].to(torch.float32),
                                    b.covten[:TB], opts.min_cov, opts.ins_frac,
                                    opts.ins_offset)
        b.weights = b.covten = None      # free the tensors early
    return buckets


def _compact_supergroup(store, buckets, opts: CnsOptions) -> List[CnsRecord]:
    records: List[CnsRecord] = []
    for b in buckets:
        tbatch_np, _ = store.padded_batch(b.ids, pad_to=b.Lt, multiple=1)
        # full consensus (-f 1) keeps reads whole: covered-run threshold
        # drops to 0.85*min_size (cbcns.c:200)
        min_run = (max(1, int(opts.min_size * 0.85))
                   if opts.full_consensus else None)
        pieces = compact_from_packed(b.packed.cpu().numpy(), b.tlens, tbatch_np,
                                     opts.min_size, opts.raw_min_gap,
                                     max_delta=opts.max_delta, min_run=min_run)
        records.extend(_emit_records(b, pieces, tbatch_np, opts))
    return records


def _emit_records(b: _Bucket, pieces, tbatch_np, opts: CnsOptions) -> List[CnsRecord]:
    records = []
    for r_, (cns_p, raw_p) in enumerate(pieces[:b.n_real]):
        tid = int(b.ids[r_])
        n = int(b.tlens[r_])
        if opts.full_consensus:
            # consensus_unbroken (cbcns.c:171-252): one whole read, consensus
            # fragments joined by the raw template between them
            if not cns_p:
                records.append(CnsRecord(tid=tid, left=0, right=n, org_size=n,
                                         seq=tbatch_np[r_, :n].astype(np.uint8),
                                         corrected=False))
                continue
            parts = []
            prev = 0
            for (s, e, seq) in cns_p:
                if s > prev:
                    parts.append(tbatch_np[r_, prev:s].astype(np.uint8))
                parts.append(seq)
                prev = e
            if prev < n:
                parts.append(tbatch_np[r_, prev:n].astype(np.uint8))
            records.append(CnsRecord(tid=tid, left=0, right=n, org_size=n,
                                     seq=np.concatenate(parts), corrected=True))
            continue
        for (s, e, seq) in cns_p:
            records.append(CnsRecord(tid=tid, left=s, right=e, org_size=n,
                                     seq=seq, corrected=True))
        for (s, e, seq) in raw_p:
            records.append(CnsRecord(tid=tid, left=s, right=e, org_size=n,
                                     seq=seq, corrected=False))
    return records
