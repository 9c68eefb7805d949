"""Read correction driver: candidates -> wave-based extension -> tag consensus.

Counterpart of necat_tpu/consensus/correct.py, on one device or several:
templates are bucketed (TB rows per consensus tensor) in
descending length order, buckets_per_supergroup (default: one per device)
buckets a supergroup, bucket g on device g mod the devices with its
tensors, chunks and consensus call (necat_tpu/consensus/fused.py:313-345);
per supergroup, the reference's per-template wave loop
(consensus_one_read.c:317-372) runs as host-side selection over a coverage
mirror, every chunk of a wave runs gather -> extend -> accept -> scatter on
the device (consensus/fused.py), and the consensus of each bucket is
compacted on the device into a stream of its emitted bases
(backbone.consensus_stream), which the host slices into pieces beside the
templates' rows, read in place from the store. With rescue_long_indels, pairs
whose extension stops > 200 bp short of the candidate climb a band-doubling
ladder (W0 * rescue_band_scale, doubling up to rescue_band_max_scale and
shapes.MAX_BAND).

The legacy two-program flow (fused=False or NECAT_TPU_FUSED=0, fused_mode),
the oracle the fused path is held to, runs on one device instead: each wave
extends its chunks (ExtendEngine.submit), decides the identity cutoffs and
acceptance on the host from the chunks' stats, then scatters each chunk's
accepted lanes from its per-column buffers and gathered query rows
(tags.scatter_pass_cols); its rescue ladder re-extends the hanging pairs on
the same rungs and keeps the better result by splicing lanes
(engine.splice_rescue).

Wide insertion channels (3 * max_delta > 30, the polish stage's 22, past
the JAX package's packed int32): columns with strong insertion evidence or
no clear majority (hot_insertion_mask) are re-derived on the host by the
reference link DP over the accepted alignments (_bucket_hot_overrides), and
pieces are cut at the polish windows' seams.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from necat_tpu_torch.align.banded_kernels import N_INSB, OP_DEL, OP_DIAG
from necat_tpu_torch.align.engine import (ExtendEngine, collect_stats, new_stats,
                                         rescue_widths, splice_rescue)
from necat_tpu_torch.consensus import fused, tags
from necat_tpu_torch.consensus.backbone import (compact_from_stream, consensus_stream,
                                               hot_insertion_mask)
from necat_tpu_torch.consensus.linkdp import (consensus_linkdp, host_edit_ops,
                                             tags_from_ops)
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.io.devstore import DeviceReadStore
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.candidates import Candidates
from necat_tpu_torch.utils import shapes
from necat_tpu_torch.utils.device import resolve_devices
from necat_tpu_torch.utils.logging import count, logger, sync_dispatch, timed

# seconds spent in each part of correct_reads, added up over its calls (the
# polish stage clears it and records it in its manifest): "waves" (extension
# and scatter on the device, wave selection on the host), "consensus" (the
# call on the device and its download), "overrides" (the host link-DP repair
# of wide-delta hotspots), "compact" (host decoding into records); polish
# adds "map" (its reads mapped to the contig windows)
seconds_by_part: Counter = Counter()


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


def estimate_ident_cutoff(idents: np.ndarray) -> float:
    """error_estimate.c:32-64 on the host in float64: mean - 5 * stddev
    (population) over the top 70 % of idents (all of them when n < 8), 0
    when n < 5."""
    n = len(idents)
    if n < 5:
        return 0.0
    idents = np.sort(idents)[::-1]
    if n >= 8:
        n = int(n * 0.7)
    sel = idents[:n]
    return float(sel.mean() - 5.0 * sel.std())


def fused_mode(opts: CnsOptions) -> bool:
    """True for the fused path (consensus/fused.py), the default; False for
    the legacy two-program flow. NECAT_TPU_FUSED decides first ("0" and
    "false" select the legacy flow, any other value the fused one), then
    opts.fused (necat_tpu/consensus/correct.py:114-124)."""
    v = os.environ.get("NECAT_TPU_FUSED")
    if v is not None:
        return v not in ("0", "false")
    if opts.fused is not None:
        return opts.fused
    return True


def _check_supported(opts: CnsOptions, store: ReadStore) -> None:
    if not isinstance(opts, CnsOptions) or not isinstance(store, ReadStore):
        raise TypeError("correct_reads takes necat_tpu_torch's CnsOptions and ReadStore, "
                        f"not {type(opts).__module__}/{type(store).__module__}")


def correct_reads(store: ReadStore, cands: Candidates,
                  opts: CnsOptions = CnsOptions(), *, device="cuda",
                  min_cov_for_template: int | None = None,
                  emit_uncorrected: bool = True, template_ids=None,
                  template_cuts: dict | None = None) -> List[CnsRecord]:
    """Correct all templates that have candidates, on `device`: one device,
    a list of them or a comma-separated string (each device holds the read
    store and runs its buckets). `cands` must be role-expanded (each overlap
    present for both reads as templates). Records come in the order of
    necat_tpu's correct_reads: uncorrected passthrough first, then templates
    by descending length; they do not depend on the devices.

    template_ids restricts the templates, and the uncorrected passthrough,
    to those read ids: a process's stripe in a multi-process run (the
    reference's `-mn node_id num_nodes`, src/consensus/main.c:71-73), so
    that the stripes' records together are the whole run's.

    SMALL_MEMORY (opts.small_memory, or a store at or past
    shapes.DEVICE_STORE_MAX_BASES; oc2cns -s, read_id_pool.h:29-63): each
    supergroup uploads only the reads it touches, its templates and their
    queries, to each device, and extends on local ids. Supergroups run one
    at a time, so at most one supergroup's device arrays are alive.

    template_cuts (template id -> positions; wide-delta mode only) splits
    corrected pieces at those positions: the polish stage cuts its windows'
    pieces at the core edges.

    The legacy two-program flow (fused_mode false) runs on one device, the
    first of a list, as the JAX package runs it on its default device."""
    _check_supported(opts, store)
    devs = resolve_devices(device)
    if not fused_mode(opts):
        devs = devs[:1]
    groups = group_by_template(cands, opts.max_examined)
    min_need = opts.min_cov if min_cov_for_template is None else min_cov_for_template
    stripe = None if template_ids is None else {int(t) for t in template_ids}
    tids_all = np.array([t for t in sorted(groups) if len(groups[t]) >= min_need
                         and (stripe is None or t in stripe)], dtype=np.int64)
    records: List[CnsRecord] = []
    if emit_uncorrected:
        have = set(tids_all.tolist())
        for r in range(store.n_reads):
            if r not in have and (stripe is None or r in stripe):
                records.append(CnsRecord(tid=r, left=0, right=int(store.lengths[r]),
                                         org_size=int(store.lengths[r]),
                                         seq=store.get(r), corrected=False))
    if not len(tids_all):
        return records
    tids_sorted = tids_all[np.argsort(-store.lengths[tids_all], kind="stable")]
    small_memory = (opts.small_memory
                    or store.total_bases >= shapes.DEVICE_STORE_MAX_BASES)
    engines = id_map = None

    def engines_of(st: ReadStore):
        with timed("cns.devstore_init"):
            return [ExtendEngine(q, q, opts.pairs_per_chunk)
                    for q in (DeviceReadStore(st, d) for d in devs)]

    if not small_memory:
        engines = engines_of(store)
    # buckets are the unit of multi-device data parallelism
    # (necat_tpu/consensus/correct.py:171-185)
    SG = opts.templates_per_batch * (opts.buckets_per_supergroup or len(devs))
    for s in range(0, len(tids_sorted), SG):
        sg_ids = tids_sorted[s:s + SG]
        if small_memory:
            id_map = np.unique(np.concatenate(
                [sg_ids] + [cands.qid[groups[int(t)]] for t in sg_ids]).astype(np.int64))
            engines = engines_of(store.subset(id_map))
        buckets, tpls = _run_supergroup(store, engines, cands, groups, sg_ids, opts, id_map)
        records.extend(_compact_supergroup(store, buckets, tpls, opts,
                                           template_cuts or {}))
    return records


class _Bucket:
    """TB template rows with their consensus tensors on the device. Weights
    accumulate in float64: the sums of the f32 pair weights are exact there,
    so the result does not depend on the order of the additions (atomics on
    the card, sequential on the CPU); the consensus call reads them as f32."""

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
        # consensus_stream's (stream, cum_t, cov8), and on the wide-delta
        # path hot_insertion_mask's hot, on the host
        self.stream = None


class _Tpl:
    __slots__ = ("tid", "bucket", "row", "n", "cand_idx", "cutoff", "accepted")

    def __init__(self, tid, bucket, row, n, cand_idx):
        self.tid = tid
        self.bucket = bucket
        self.row = row
        self.n = n
        self.cand_idx = cand_idx
        self.cutoff = np.nan     # the legacy flow's identity cutoff
        # wide delta: (qid, qdir, qoff, qend, toff, tend, weight) of each
        # accepted alignment, in wave order, for the hotspot repair
        self.accepted = []


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


def _wide_delta(opts: CnsOptions) -> bool:
    """The wide-delta mode (polish): past D = 10, where the JAX package's
    3-bit fields of max_delta columns no longer fit an int32, the hotspot
    repair and the window cuts apply."""
    return 3 * opts.max_delta > 30


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


def _run_waves(engines, cands, buckets, tpls, opts: CnsOptions, st: _SelState,
               id_map) -> None:
    """Waves until no template has pending candidates: round 0 estimates the
    identity cutoffs (unless fixed) and scatters from the ident pass's
    retained buffers; later rounds extend, accept and scatter in one step.
    Without rescue the only host syncs are the per-chunk stats that feed the
    coverage mirror; the rescue ladder reads each rung's stats. id_map (the
    sorted global ids of a SMALL_MEMORY supergroup's store, else None) maps
    the ids the device store is read by. Bucket bi's cutoffs and ident
    buffer live on its tensors' device, engines[bi mod len(engines)]'s."""
    TB = opts.templates_per_batch
    estimating = not opts.use_fixed_ident_cutoff
    cut0 = 0.0 if estimating else 100.0 * (1.0 - opts.error)
    cutoffs = {bi: torch.full((TB + 1,), cut0, dtype=torch.float32, device=b.weights.device)
               for bi, b in enumerate(buckets)}
    tensors = {bi: (b.weights, b.covten) for bi, b in enumerate(buckets)}
    insb_words = _insb_words(opts)
    rescue = opts.rescue_long_indels
    W0 = opts.band_width
    round_id = 0 if estimating else 1        # consensus_one_read.c:273-278
    max_rounds = -(-opts.max_examined // opts.wave_size) + 1
    offsets = engines[0].qdev.offsets
    local = (lambda ids: ids) if id_map is None else (
        lambda ids: np.searchsorted(id_map, ids))
    while round_id <= max_rounds:
        wave = (opts.n_ident + 10) if round_id == 0 else opts.wave_size
        with timed("cns.wave_build"):
            p_tpl, p_ci, slots = _select_wave(st, cands, round_id, wave, opts.max_cov)
        if len(p_tpl) == 0:
            if round_id == 0:
                round_id += 1
                continue
            break
        base = dict(qids=local(cands.qid[p_ci]), qdir=cands.qdir[p_ci].astype(np.int32),
                    qsize=cands.qsize[p_ci].astype(np.int64),
                    tg_base=offsets[local(st.tpl_tid[p_tpl])],
                    tsize_full=st.tpl_n[p_tpl],
                    aq=cands.qbeg[p_ci].astype(np.int64),
                    at_abs=cands.sbeg[p_ci].astype(np.int64),
                    rows=st.tpl_row[p_tpl], groups=st.tpl_bucket[p_tpl],
                    insb_words=insb_words, min_align_size=opts.min_align_size,
                    mapping_ratio=opts.mapping_ratio,
                    good_end_margin=opts.good_end_margin,
                    cutoffs=cutoffs, tensors=tensors,
                    allow_fullcov=round_id > 0)

        def run(idx, base=base, replay=False, **kw):
            """dispatch_wave over the pairs idx of this wave (the rescue's
            dispatches: counted in cns.replay_lanes for round 0's second
            dispatch, else in cns.rung_lanes above W0)."""
            d = {k: (v[idx] if isinstance(v, np.ndarray) else v)
                 for k, v in base.items()}
            if replay:
                count("cns.replay_lanes", len(idx))
            elif kw["W"] > W0:
                count("cns.rung_lanes", len(idx))
            return fused.dispatch_wave(engines, **d, **kw)

        npairs = len(p_ci)
        stats = fused.new_fused_stats(npairs)
        if round_id == 0:
            if wave > fused.IDENT_SLOTS:
                raise ValueError("n_ident + 10 must fit fused.IDENT_SLOTS")
            ibufs = {bi: torch.zeros((TB + 1, fused.IDENT_SLOTS, 3), dtype=torch.float32,
                                     device=buckets[bi].weights.device)
                     for bi in sorted({int(g) for g in base["groups"]})}
            with timed("cns.extend_pairs_total"):
                chunks = fused.dispatch_wave(engines, **base, W=W0, slots=slots,
                                             ibufs=ibufs)
                lane_w = None
                if rescue:
                    with timed("cns.ident_ladder"):
                        lane_w = _ident_ladder(functools.partial(run, ibufs=ibufs), chunks,
                                               npairs, cands, p_ci, slots, opts)
            for bi, ib in ibufs.items():
                cutoffs[bi] = fused.cutoff_from_idents(ib, n_ident=opts.n_ident)
            with timed("cns.extend_pairs_total"):
                if lane_w is None:
                    fused.scatter_round0(chunks, cutoffs, tensors, opts.min_align_size,
                                         opts.mapping_ratio)
                    fused.collect_fused(chunks, stats)
                else:        # the band of each lane is decided: scatter at it
                    with timed("cns.round0_replay"):
                        for Wx in np.unique(lane_w):
                            idx = np.flatnonzero(lane_w == Wx)
                            fused.collect_fused(run(idx, W=int(Wx), replay=True), stats,
                                                sel=idx)
        else:
            with timed("cns.extend_pairs_total"):
                chunks = fused.dispatch_wave(
                    engines, **base, W=W0, rescue_defer=rescue,
                    qend_cand=cands.qend[p_ci].astype(np.int64))
                fused.collect_fused(chunks, stats)
                if rescue:
                    with timed("cns.defer_ladder"):
                        _defer_ladder(run, stats, cands, p_ci, opts)
        with timed("cns.accept"):
            acc = np.flatnonzero(stats["ok"])
            _apply_cov(st, p_tpl[acc], stats["toff"][acc], stats["tend"][acc])
            if _wide_delta(opts) and len(acc):
                w_acc = fused.calc_cns_weight(torch.from_numpy(stats["ident"][acc])).numpy()
                for j, i in enumerate(acc):
                    ci = p_ci[i]
                    tpls[p_tpl[i]].accepted.append(
                        (int(cands.qid[ci]), int(cands.qdir[ci]),
                         int(stats["qoff"][i]), int(stats["qend"][i]),
                         int(stats["toff"][i]), int(stats["tend"][i]), float(w_acc[j])))
        round_id += 1


def _run_waves_legacy(engines, cands, buckets, tpls, opts: CnsOptions, st: _SelState,
                      id_map) -> None:
    """The legacy two-program flow on engines[0]'s device
    (necat_tpu/consensus/correct.py:369-499): per wave, every chunk is
    extended, the stats of all of them are read, the identity cutoffs
    (round 0) and acceptance are decided on the host in float64, and each
    chunk's accepted lanes are then scattered by tags.scatter_pass_cols. With
    rescue_long_indels the pairs that hang re-extend at each rung in turn;
    splice_rescue keeps a rung's result where it aligned at least as many
    columns and kills the losing lane. Every chunk of a wave, rescue chunks
    included, holds its buffers on the device until its scatter."""
    engine = engines[0]
    TB = opts.templates_per_batch
    estimating = not opts.use_fixed_ident_cutoff
    if not estimating:
        for t in tpls:
            t.cutoff = 100.0 * (1.0 - opts.error)
    round_id = 0 if estimating else 1        # consensus_one_read.c:273-278
    max_rounds = -(-opts.max_examined // opts.wave_size) + 1
    insb_words = _insb_words(opts)
    local = (lambda ids: ids) if id_map is None else (
        lambda ids: np.searchsorted(id_map, ids))
    while round_id <= max_rounds:
        wave = (opts.n_ident + 10) if round_id == 0 else opts.wave_size
        with timed("cns.wave_build"):
            p_tpl, p_ci, _ = _select_wave(st, cands, round_id, wave, opts.max_cov)
        if len(p_tpl) == 0:
            if round_id == 0:
                round_id += 1
                continue
            break
        npairs = len(p_ci)
        tsize = st.tpl_n[p_tpl]
        pairs = dict(qids=local(cands.qid[p_ci]), qdir=cands.qdir[p_ci].astype(np.int32),
                     qsize=cands.qsize[p_ci].astype(np.int64),
                     tg_base=engine.qdev.offsets[local(st.tpl_tid[p_tpl])], tsize=tsize,
                     aq=cands.qbeg[p_ci].astype(np.int64),
                     at_abs=cands.sbeg[p_ci].astype(np.int64), groups=st.tpl_bucket[p_tpl])

        def submit(sel, W, pairs=pairs):
            """Extend the pairs sel of this wave at band W."""
            fused.pairs_by_band[W] += len(sel)
            return engine.submit(sel, **{k: v[sel] for k, v in pairs.items()}, W=W,
                                 insb_words=insb_words)

        with timed("cns.extend_pairs_total"):
            chunks = submit(np.arange(npairs), opts.band_width)
            stats = new_stats(npairs)
            collect_stats(chunks, stats)
            if opts.rescue_long_indels:      # consensus_aux.c:152-157
                for Wx in _rungs(opts):
                    bad = np.flatnonzero(_hang(stats, cands, p_ci) > 200)
                    if not len(bad):
                        break
                    splice_rescue(chunks, submit(bad, Wx), stats)

        with timed("cns.accept"):
            ql, qr, tl, tr = stats["qoff"], stats["qend"], stats["toff"], stats["tend"]
            ident = stats["ident"]
            qs = cands.qsize[p_ci]
            ok_align = stats["n_cols"] >= opts.min_align_size
            if round_id == 0:            # the identity cutoffs
                good = fused.is_good_overlap(ql, qr, qs, tl, tr, tsize,
                                             opts.good_end_margin) & ok_align
                span = (((qr - ql) >= 0.6 * qs) | ((tr - tl) >= 0.6 * tsize)) & ok_align
                for li in np.unique(p_tpl):
                    sel = p_tpl == li
                    idents = ident[sel][good[sel]][:opts.n_ident]
                    if len(idents) < opts.n_ident:
                        idents = ident[sel][span[sel]][:opts.n_ident]
                    tpls[li].cutoff = estimate_ident_cutoff(idents)
            cut = np.array([tpls[li].cutoff for li in p_tpl])
            pass_ident = ident >= np.where(np.isnan(cut), 0.0, cut)
            if round_id > 0:
                pass_ident |= fused.is_full_cov_ovlp(ql, qr, qs, tl, tr, tsize, 5000, 100)
            ok = ok_align & pass_ident & fused.check_mapping_range(
                ql, qr, qs, tl, tr, tsize, opts.min_align_size, opts.mapping_ratio)
            acc = np.flatnonzero(ok)
            _apply_cov(st, p_tpl[acc], tl[acc], tr[acc])
            w_all = fused.calc_cns_weight(torch.from_numpy(ident)).numpy()
            if _wide_delta(opts):
                for i in acc:
                    ci = p_ci[i]
                    tpls[p_tpl[i]].accepted.append(
                        (int(cands.qid[ci]), int(cands.qdir[ci]), int(ql[i]), int(qr[i]),
                         int(tl[i]), int(tr[i]), float(w_all[i])))

        with timed("cns.scatter_round_total"):
            for ch in chunks:
                PB, r = len(ch.live), slice(0, ch.n_real)
                lanes = np.zeros((4, PB), np.int64)      # row, tsize, at, aq
                lanes[0] = TB
                lanes[0, r] = np.where(ok[ch.sel] & ch.live[r], st.tpl_row[p_tpl[ch.sel]], TB)
                lanes[1, r] = tsize[ch.sel]
                lanes[2] = ch.at
                lanes[2, r] += ch.ws
                lanes[3] = ch.aq
                w = np.zeros(PB, np.float32)
                w[r] = w_all[ch.sel]
                _scatter_chunk(buckets[ch.group], ch, lanes, w)
                ch.release()
        round_id += 1


def _scatter_chunk(b: _Bucket, ch, lanes: np.ndarray, w: np.ndarray) -> None:
    """Scatter one extended chunk into its bucket's tensors, both passes
    (necat_tpu/consensus/correct.py:956-999, the scatter_pass_cols branch):
    lanes int64[4, PB] = template row (TB drops the lane), template length,
    template anchor, query anchor; w f32[PB] the pair weights."""
    o = ch.out
    dev = b.weights.device
    row, tsz, at, aq = torch.from_numpy(lanes).to(dev)
    w = torch.from_numpy(w).to(dev)
    with timed("cns.scatter"):
        for side, rev in (("right", False), ("left", True)):
            tags.scatter_pass_cols(b.weights, b.covten, o[f"{side}_cols"], o[f"{side}_lead"],
                                   o[f"{side}_jc"], o["qbatch"], aq, at, row, w, tsz,
                                   reversed_part=rev)
        sync_dispatch("cns.scatter_exec", dev)


def _run_supergroup(store, engines, cands, groups, sg_ids, opts: CnsOptions, id_map):
    """Waves of one supergroup, then the consensus call of each bucket on its
    device; returns the buckets, their consensus downloaded, and the
    templates."""
    TB = opts.templates_per_batch
    buckets: List[_Bucket] = []
    tpls: List[_Tpl] = []
    with timed("cns.bucket_setup"):
        for bi in range(0, len(sg_ids), TB):
            b = _Bucket(store, sg_ids[bi:bi + TB], TB, opts.max_delta,
                        engines[len(buckets) % len(engines)].device)
            buckets.append(b)
            for row in range(b.n_real):
                tid = int(b.ids[row])
                tpls.append(_Tpl(tid, len(buckets) - 1, row, int(b.tlens[row]),
                                 groups[tid]))
    t0 = time.perf_counter()
    run = _run_waves if fused_mode(opts) else _run_waves_legacy
    run(engines, cands, buckets, tpls, opts, _SelState(tpls), id_map)
    t1 = time.perf_counter()
    with timed("cns.call_consensus"):
        for b in buckets:
            w, cov = b.weights[:TB].to(torch.float32), b.covten[:TB]
            stream, cum_t, _, cov8 = consensus_stream(w, cov, opts.min_cov, opts.ins_frac,
                                                      opts.ins_offset)
            out = [stream, cum_t, cov8]
            if _wide_delta(opts):
                out.append(hot_insertion_mask(w, cov, opts.min_cov))
            elif opts.min_cov > 255:     # cov8 saturates; coverage is read exactly here
                out[2] = cov
            with timed("cns.download"):
                b.stream = tuple(x.cpu().numpy() for x in out)
            count("cns.download_MB", sum(x.nbytes for x in b.stream) / 1e6)
            b.weights = b.covten = w = cov = stream = cum_t = cov8 = out = None   # free early
    seconds_by_part["waves"] += t1 - t0
    seconds_by_part["consensus"] += time.perf_counter() - t1
    return buckets, tpls


def _compact_supergroup(store, buckets, tpls, opts: CnsOptions,
                        template_cuts: dict) -> List[CnsRecord]:
    records: List[CnsRecord] = []
    for bi, b in enumerate(buckets):
        # cns.compact keeps the JAX package's extent; its children
        # cns.padded_batch (the template rows, views of the store) and
        # cns.compact_packed (the stream sliced into pieces) and the emission
        # after it are the port's own (logging.PORT_ONLY)
        with timed("cns.compact"):
            with timed("cns.padded_batch"):
                rows = [store.get(int(tid)) for tid in b.ids]
            stream, cum_t, cov8, *hot = b.stream
            overrides = cuts = min_run = None
            if hot:
                t0 = time.perf_counter()
                overrides = _bucket_hot_overrides(store, bi, tpls, hot[0], rows)
                seconds_by_part["overrides"] += time.perf_counter() - t0
                cuts = {r_: template_cuts[int(b.ids[r_])] for r_ in range(b.n_real)
                        if int(b.ids[r_]) in template_cuts}
            elif opts.full_consensus:
                # full consensus (-f 1) keeps reads whole: covered-run
                # threshold drops to 0.85*min_size (cbcns.c:200)
                min_run = max(1, int(opts.min_size * 0.85))
            t1 = time.perf_counter()
            with timed("cns.compact_packed"):
                pieces = compact_from_stream(stream, cum_t, cov8, b.tlens, rows,
                                             opts.min_cov, opts.min_size, opts.raw_min_gap,
                                             overrides=overrides, cut_at=cuts,
                                             min_run=min_run)
        with timed("cns.emit_records"):
            records.extend(_emit_records(b, pieces, rows, opts))
        seconds_by_part["compact"] += time.perf_counter() - t1
    return records


def _bucket_hot_overrides(store, bi: int, tpls, hot: np.ndarray, rows, pad: int = 60) -> dict:
    """Link-DP repair of the insertion hotspots of bucket bi (wide-delta
    mode): row -> {template position -> bases it emits instead}.

    Long insertion runs (a contig missing a chunk every read contains) split
    across co-optimal alignment phasings, so no single (t, delta) cell wins
    the majority vote. For each hotspot region the covering read segments
    are re-aligned to the local template on the host (one aligner, one
    phasing), the reference link DP (consensus_linkdp) reassembles them, and
    the result overrides the region's emissions. Reference: ctg_cns u16-delta
    consensus (fc_correct_one_read.c) + cns_aux.c:127-217."""
    overrides: dict = {}
    for t_ in tpls:
        if t_.bucket != bi or not t_.accepted:
            continue
        row = t_.row
        n = t_.n
        hot_pos = np.flatnonzero(hot[row, :n])
        if len(hot_pos) == 0:
            continue
        # the query surplus (a collapsed repeat's length) from the accepted
        # alignments' skew: the region window must reach further than the
        # surplus on each side, or every semiglobal alignment prefers
        # truncating the window (cost = remaining context) over threading
        # the insertion (cost = surplus)
        surplus = 0
        for (qid, qdir, qo, qe, to, te, w) in t_.accepted:
            surplus = max(surplus, (qe - qo) - (te - to))
        rpad = pad + min(int(surplus * 3 // 2), 5000)
        gap_merge = max(50, rpad)
        regions = []                     # hot positions clustered
        rs = re = int(hot_pos[0])
        for t in hot_pos[1:]:
            if t - re <= gap_merge:
                re = int(t)
            else:
                regions.append((rs, re + 1))
                rs = re = int(t)
        regions.append((rs, re + 1))
        row_ovr: dict = {}
        for (rs, re) in regions:
            lo, hi = max(0, rs - rpad), min(n, re + rpad)
            if hi - lo > 100000:
                logger.warning("hotspot region %d bp at row %d skipped (>100 kb)",
                               hi - lo, row)
                continue
            t_local = rows[row][lo:hi].astype(np.uint8)
            # 1. the read segments spanning the window (a semiglobal trim
            # against the draft absorbs the interpolation drift)
            segs = []
            for (qid, qdir, qo, qe, to, te, w) in t_.accepted:
                if to >= hi or te <= lo:
                    continue
                span_t = max(te - to, 1)
                drift = 60 + span_t // 100
                qs = qo + (qe - qo) * (lo - to) // span_t
                q2 = qo + (qe - qo) * (hi - to) // span_t
                qs = max(qo, qs - drift)
                q2 = min(qe, q2 + drift)
                if q2 - qs < (min(hi, te) - max(lo, to)) // 2:
                    continue
                seq = store.get(qid)
                if qdir:
                    seq = (3 - seq[::-1]).astype(np.uint8)
                qseg = np.asarray(seq[qs:q2], np.uint8)
                ops, q_start, q_end = host_edit_ops(qseg, t_local)
                if q_end - q_start < (hi - lo) // 2:
                    continue
                segs.append((qseg[q_start:q_end], float(w)))
            if len(segs) < 2:
                # two concordant segments already outvote the draft's omission
                continue
            # 2. local reassembly against the median segment as backbone: it
            # contains what the draft misses, so the segments' alignments
            # have no systematic insertion runs and the link DP threads them
            segs.sort(key=lambda s: len(s[0]))
            backbone = segs[len(segs) // 2][0]
            all_tags = []
            for (sg, w) in segs:
                ops, q_start, _ = host_edit_ops(sg, backbone)
                tg = tags_from_ops(ops, len(ops), sg, qoff=q_start, toff=0,
                                   weight=w, max_delta=65535)
                if tg:
                    all_tags.extend(tg)
            S, _, _ = consensus_linkdp(all_tags, len(backbone))
            if len(S) < (hi - lo) // 2:
                continue
            # 3. the reassembly aligned back to the draft window: its
            # emissions per template column become the overrides
            ops2, _, _ = host_edit_ops(S, t_local)
            per_t: dict = {}
            j = -1
            qp = 0
            for op in ops2:
                if op == OP_DIAG:
                    j += 1
                    per_t.setdefault(j, []).append(int(S[qp]))
                    qp += 1
                elif op == OP_DEL:
                    j += 1
                    per_t.setdefault(j, [])
                else:            # OP_INS: after column j's emissions
                    if j >= 0:
                        per_t.setdefault(j, []).append(int(S[qp]))
                    qp += 1
            for t in range(rs, re):
                if (t - lo) in per_t:
                    row_ovr[t] = np.array(per_t[t - lo], np.uint8)
        if row_ovr:
            overrides[row] = row_ovr
    return overrides


def _emit_records(b: _Bucket, pieces, rows, opts: CnsOptions) -> List[CnsRecord]:
    """The records of one bucket's pieces; rows[r] holds row r's template
    bases (at least its tlens)."""
    records = []
    for r_, (cns_p, raw_p) in enumerate(pieces[:b.n_real]):
        tid = int(b.ids[r_])
        n = int(b.tlens[r_])
        if opts.full_consensus:
            # consensus_unbroken (cbcns.c:171-252): one whole read, consensus
            # fragments joined by the raw template between them
            if not cns_p:
                records.append(CnsRecord(tid=tid, left=0, right=n, org_size=n,
                                         seq=rows[r_][:n].astype(np.uint8),
                                         corrected=False))
                continue
            parts = []
            prev = 0
            for (s, e, seq) in cns_p:
                if s > prev:
                    parts.append(rows[r_][prev:s].astype(np.uint8))
                parts.append(seq)
                prev = e
            if prev < n:
                parts.append(rows[r_][prev:n].astype(np.uint8))
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
