"""Read sets -> candidates -> extended M4 overlaps, on one device or several
(counterpart of necat_tpu/overlap/overlapper.py: find_all_candidates,
candidates_by_volumes, extend_candidates with its long-indel rescue
ladder, which the JAX package's callers all leave on at its default scales,
overlap_all_vs_all and map_reads_to_reference).

`device` is one device, a list of them or a comma-separated string
(utils/device.resolve_devices). With several, the subject's k-mer index is
split into a read range per device (parallel/mesh.py) and the extension's
chunks go round-robin over the devices; the results equal one device's,
field for field and in order."""

from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch

from necat_tpu_torch.align.engine import (ExtendEngine, collect_stats, new_stats,
                                          rescue_widths)
from necat_tpu_torch.index.kmer_index import KmerIndex
# the seconds of each k-mer index build (kmer_index.build_index: one per
# subject volume or shard), which the stages' reports read here
from necat_tpu_torch.index.kmer_index import index_build_s  # noqa: F401
from necat_tpu_torch.io.devstore import DeviceReadStore
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.candidates import (Candidates, stats_to_candidates,
                                                top_n_per_query)
from necat_tpu_torch.overlap.m4 import M4Records
from necat_tpu_torch.overlap.options import MapOptions
from necat_tpu_torch.parallel.mesh import Shard, ShardedIndex, device_threads, shard_stats
from necat_tpu_torch.utils import shapes
from necat_tpu_torch.utils.device import resolve_devices
from necat_tpu_torch.utils.logging import timed


def find_all_candidates(qstore: ReadStore, sstore: ReadStore, opts: MapOptions,
                        pairwise: bool, *, device="cuda", query_batch_size: int = 256,
                        index: Optional[KmerIndex] = None, subject_read_start: int = 0,
                        query_ids: Optional[np.ndarray] = None) -> Candidates:
    """Candidates of qstore reads against sstore (one subject volume), on
    `device` (several: the subject split into a shard per device, its
    ShardedIndex; `index`, an index built by the caller, serves one device).

    pairwise=True means both stores share one id space: each overlap is
    found once, from the read positioned later (hits at subject positions
    >= the query read's own start are dropped, word_finder.c:121-127).
    subject_read_start is the global id of sstore's first read (oc2pmov's
    volume offset): sstore may be a volume of qstore. query_ids restricts
    the queries to those global ids. Queries run in batches of
    query_batch_size in ascending length order, both strands per batch; the
    best opts.ncan candidates per query are kept (pm_worker.c:163-186)."""
    cands, _ = _search(qstore, sstore, opts, pairwise, resolve_devices(device),
                       query_batch_size, index, subject_read_start, query_ids)
    with timed("cand.topn"):
        return top_n_per_query(cands, opts.ncan)


def _search(qstore, sstore, opts, pairwise, devs, query_batch_size, index,
            subject_read_start, query_ids, qdevs=None, packed=None):
    """find_all_candidates before its top-n cut: (candidates, the chain of
    each), in the order of the search on one device (query batch, strand,
    chain, query, subject). qdevs: qstore on each device, made here unless
    qstore is at or past shapes.DEVICE_STORE_MAX_BASES (its batches are then
    read on the host and uploaded). packed: sstore's reads on each device,
    for the index build (qdevs when sstore is qstore)."""
    if not isinstance(opts, MapOptions):
        raise TypeError(f"find_all_candidates takes necat_tpu_torch's MapOptions, not "
                        f"{type(opts).__module__}.{type(opts).__name__}")
    if index is not None and len(devs) != 1:
        raise ValueError("a k-mer index built by the caller serves one device")
    if qdevs is None and qstore.total_bases < shapes.DEVICE_STORE_MAX_BASES:
        with timed("cand.devstore_init"):
            qdevs = [DeviceReadStore(qstore, d) for d in devs]
    if packed is None and sstore is qstore:
        packed = qdevs
    with timed("cand.index_build"):
        if index is not None:
            shards = [Shard.of(sstore, 0, sstore.n_reads, 0, devs[0], index)]
        else:
            shards = ShardedIndex(devs, sstore, opts.kmer_size, opts.occ_cutoff,
                                  n_bucket_bits=22 if len(devs) == 1 else 14,
                                  packed=packed).shards
    ns = sstore.n_reads
    int32_max = np.iinfo(np.int32).max
    all_q = np.arange(qstore.n_reads) if query_ids is None else np.asarray(query_ids)
    order = all_q[np.argsort(qstore.lengths[all_q], kind="stable")]
    parts, chains = [], []
    with device_threads(shards) as pool:
        for bs in range(0, len(order) if shards else 0, query_batch_size):
            qidx = order[bs:bs + query_batch_size]
            pad = shapes.length_tier(int(qstore.lengths[qidx].max()))
            lens = qstore.lengths[qidx].astype(np.int32)
            limit = np.full(len(qidx), int32_max, np.int64)
            if pairwise:
                # a query outside the subject volume has no limit there
                # (necat_tpu/overlap/candidates.py:292-304)
                local = qidx - subject_read_start
                in_vol = (local >= 0) & (local < ns)
                limit[in_vol] = sstore.offsets[local[in_vol]]
            for qdir in (0, 1):
                with timed("cand.batch_total"):       # one strand of the batch
                    with timed("cand.read_rows"):
                        rc = np.full(len(qidx), bool(qdir))
                        if qdevs is not None:
                            batches = [qdevs[sh.slot].read_rows(qidx, rc, pad) for sh in shards]
                        else:
                            host = torch.from_numpy(qstore.padded_batch(
                                qidx, pad_to=pad, multiple=1, rc=bool(qdir))[0])
                            batches = [host.to(sh.device) for sh in shards]
                    with timed("cand.dispatch_total"):
                        stats = shard_stats(shards, batches, lens, limit, opts, pool)
                    got = []
                    for sh, st in zip(shards, stats):
                        # the stats hold chain 0 of every pair, then chain 1, ...
                        chain = (np.arange(st.shape[1])
                                 // max(st.shape[1] // opts.n_chains_per_pair, 1))
                        kept, c = stats_to_candidates(st, qidx.astype(np.int32), lens, qdir,
                                                      sh.sizes, subject_read_start + sh.lo, opts)
                        got.append((c, chain[kept], st[0][kept]))
                    c = Candidates.concat([g[0] for g in got])
                    chain = np.concatenate([g[1] for g in got])
                    if len(got) > 1:
                        # the shards' union in the one-device order: chain,
                        # then query row, then subject (group_pairs' sort)
                        o = np.lexsort((c.sid, np.concatenate([g[2] for g in got]), chain))
                        c, chain = c.take(o), chain[o]
                parts.append(c)
                chains.append(chain)
    chain = np.concatenate(chains) if chains else np.zeros(0, np.int64)
    return Candidates.concat(parts), chain


def candidates_by_volumes(store: ReadStore, opts: MapOptions, vol_size: int, *,
                          device="cuda", query_batch_size: int = 256) -> Candidates:
    """Pairwise candidates with the subject side tiled into <= vol_size-base
    volumes (oc2mkdb + per-volume oc2pmov, pm_worker.c:283-335), on
    `device` (several: volume v on the v-th mod their count): one k-mer
    index at a time, each of its volume's own reads (hashed from the
    device's packed store), searched by every read from the volume's first
    read on (the pairwise limit covers the volume's own reads). The union
    holds exactly the untiled candidates; it is put in the order the untiled
    search emits them (query batch, strand, chain, query, subject) before
    the top-n cut, so that every later stage sees the same rows in the same
    order (the JAX package concatenates the volumes' top-n sets, the same
    set in another order)."""
    devs = resolve_devices(device)
    qdevs = ([DeviceReadStore(store, d) for d in devs]
             if store.total_bases < shapes.DEVICE_STORE_MAX_BASES else None)
    parts, chains = [], []
    for v, (slo, shi) in enumerate(store.volumes(vol_size)):
        s = v % len(devs)
        c, chain = _search(store, store.slice(slo, shi), opts, True, [devs[s]],
                           query_batch_size, None, slo, np.arange(slo, store.n_reads),
                           qdevs=None if qdevs is None else [qdevs[s]],
                           packed=None if qdevs is None else [qdevs[s].slice(slo, shi)])
        parts.append(c)
        chains.append(chain)
    cands = Candidates.concat(parts)
    if not len(cands):
        return cands
    pos = np.empty(store.n_reads, np.int64)      # each read's place in the untiled order
    pos[np.argsort(store.lengths, kind="stable")] = np.arange(store.n_reads)
    qpos = pos[cands.qid]
    order = np.lexsort((cands.sid, qpos % query_batch_size, np.concatenate(chains),
                        cands.qdir, qpos // query_batch_size))
    with timed("cand.topn"):
        return top_n_per_query(cands.take(order), opts.ncan)


# bytes of per-column buffers a slice of extension chunks may hold (about 20
# bytes per pair and tier column): slices bound the device memory of a pass
EXT_SLICE_BYTES = 2 << 30
# pairs extend_candidates extended at each band width (the ladder's rungs
# included), for the callers' reports; never cleared here
pairs_by_band: Counter = Counter()


def _extend_subset(cands: Candidates, engine: ExtendEngine, idxs: np.ndarray,
                   band_width: int, out: dict) -> None:
    """Extend the candidates idxs at band width band_width into the per-pair
    arrays of `out` (from new_stats, indexed by candidate row). Chunks are
    submitted a slice of at most 8192 pairs at a time; a slice's stats are
    read, and its buffers dropped, once the next slice is submitted."""
    slice_pairs = 8192
    pairs_by_band[band_width] += len(idxs)
    if len(idxs):
        L_est = shapes.length_tier(
            min(int(cands.qsize[idxs].max()) * 14 // 10 + 600, 1 << 18))
        slice_pairs = max(512, min(slice_pairs, EXT_SLICE_BYTES // (20 * L_est)))

    def submit(sel):
        return engine.submit(
            sel=sel, qids=cands.qid[sel], qdir=cands.qdir[sel].astype(np.int32),
            qsize=cands.qsize[sel].astype(np.int64),
            tg_base=engine.sdev.offsets[cands.sid[sel]],
            tsize=cands.ssize[sel].astype(np.int64),
            aq=cands.qbeg[sel].astype(np.int64),
            at_abs=cands.sbeg[sel].astype(np.int64), W=band_width)

    pending = []
    for s0 in range(0, len(idxs), slice_pairs):
        chunks = submit(idxs[s0:s0 + slice_pairs])
        collect_stats(pending, out)
        for ch in pending:
            ch.release()
        pending = chunks
    collect_stats(pending, out)
    for ch in pending:
        ch.release()


def rescue_hangs(cands: Candidates, idxs: np.ndarray, qoff: np.ndarray,
                 qend: np.ndarray) -> np.ndarray:
    """Candidates whose aligned query range fell short of the chain-predicted
    range by > 200 bp in all: the cns_extension long-indel rescue trigger
    (consensus_aux.c:152-157)."""
    lhang = np.maximum(qoff[idxs] - cands.qbeg[idxs], 0)
    rhang = np.maximum(cands.qend[idxs] - qend[idxs], 0)
    return idxs[(lhang + rhang) > 200]


def extend_candidates(cands: Candidates, qstore: ReadStore, sstore: ReadStore, *,
                      device="cuda", min_align_size: int = 400, min_ident: float = 0.0,
                      band_width: int = 128) -> M4Records:
    """Banded-extend candidates into M4 records (end points and identity), on
    `device` (several: the chunks round-robin over them, ExtendEngine).

    Pairs whose alignment stopped > 200 bp short of the chain-predicted query
    range are extended again with doubled bands (band_width * 4, then x2 each
    rung, up to band_width * 32 and shapes.MAX_BAND) until they reach it: the
    stand-in for the reference's DALIGNER rescue (consensus_aux.c:123-215).
    A rung's result is kept only where it aligned at least as many columns
    as the best so far (consensus_aux.c:203-213)."""
    devs = resolve_devices(device)
    n = len(cands)
    out = new_stats(n)
    qdevs = [DeviceReadStore(qstore, d) for d in devs]
    sdevs = qdevs if sstore is qstore else [DeviceReadStore(sstore, d) for d in devs]
    engine = ExtendEngine(qdevs, sdevs)
    _extend_subset(cands, engine, np.arange(n), band_width, out)
    bad = rescue_hangs(cands, np.arange(n), out["qoff"], out["qend"])
    for Wx in rescue_widths(band_width, 4, 32):
        if not len(bad):
            break
        prev = {k: out[k][bad].copy() for k in out if k != "lane"}
        _extend_subset(cands, engine, bad, Wx, out)
        worse = out["n_cols"][bad] < prev["n_cols"]
        for k in prev:
            out[k][bad[worse]] = prev[k][worse]
        bad = rescue_hangs(cands, bad, out["qoff"], out["qend"])
    ki = np.flatnonzero((out["n_cols"] >= min_align_size) & (out["ident"] >= min_ident))
    return M4Records(
        qid=cands.qid[ki], sid=cands.sid[ki],
        ident=out["ident"][ki].astype(np.float32), vscore=cands.score[ki],
        qdir=cands.qdir[ki], qoff=out["qoff"][ki].astype(np.int32),
        qend=out["qend"][ki].astype(np.int32), qsize=cands.qsize[ki],
        sdir=np.zeros(len(ki), np.int8), soff=out["toff"][ki].astype(np.int32),
        send=out["tend"][ki].astype(np.int32), ssize=cands.ssize[ki])


def overlap_all_vs_all(store: ReadStore, opts: MapOptions, *, device="cuda",
                       vol_size: int = 0) -> M4Records:
    """All-vs-all overlaps of one read set on `device`, each reported once
    (from the read later in the store); M4Records.swap_roles gives the other
    read's view. Every caller of the JAX package's version takes its default
    extension (band 128, min_align_size 400, min_ident 0). vol_size > 0
    tiles the subject side into <= vol_size-base volumes
    (candidates_by_volumes), bounding the k-mer index; the extension still
    uploads the whole store, which must stay below
    shapes.DEVICE_STORE_MAX_BASES (as in the JAX package)."""
    if vol_size > 0:
        cands = candidates_by_volumes(store, opts, vol_size, device=device)
    else:
        cands = find_all_candidates(store, store, opts, pairwise=True, device=device)
    return extend_candidates(cands, store, store, device=device)


def map_reads_to_reference(qstore: ReadStore, refstore: ReadStore, opts: MapOptions, *,
                           device="cuda", min_align_size: int = 400, min_ident: float = 0.0,
                           band_width: int = 128) -> M4Records:
    """Reads mapped to a reference set (contigs) on `device`, the oc2rm
    role: candidates of every read against refstore, then the banded
    extension with its rescue ladder."""
    cands = find_all_candidates(qstore, refstore, opts, pairwise=False, device=device)
    return extend_candidates(cands, qstore, refstore, device=device,
                             min_align_size=min_align_size, min_ident=min_ident,
                             band_width=band_width)
