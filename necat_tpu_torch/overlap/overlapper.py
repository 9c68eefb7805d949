"""Candidate detection over whole read sets (counterpart of
necat_tpu/overlap/overlapper.py:find_all_candidates on one device)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from necat_tpu.io.readstore import ReadStore
from necat_tpu.overlap.options import MapOptions
from necat_tpu.utils import shapes
from necat_tpu_torch.index.kmer_index import KmerIndex
from necat_tpu_torch.io.devstore import DeviceReadStore
from necat_tpu_torch.overlap.candidates import (Candidates, candidates_forward,
                                                stats_to_candidates, top_n_per_query)
from necat_tpu_torch.utils.device import resolve_device


def find_all_candidates(qstore: ReadStore, sstore: ReadStore, opts: MapOptions,
                        pairwise: bool, *, device, query_batch_size: int = 256,
                        index: Optional[KmerIndex] = None) -> Candidates:
    """Candidates of qstore reads against sstore, on `device`.

    pairwise=True means qstore is sstore (one id space): each overlap is
    found once, from the read positioned later in the store (hits at
    subject positions >= the query read's own start are dropped,
    word_finder.c:121-127). Queries run in batches of query_batch_size in
    ascending length order, both strands per batch; the best opts.ncan
    candidates per query are kept (pm_worker.c:163-186)."""
    dev = resolve_device(device)
    if index is None:
        index = KmerIndex.build(sstore.bases, sstore.offsets, device=dev,
                                k=opts.kmer_size, occ_cutoff=opts.occ_cutoff)
    qdev = DeviceReadStore(qstore, dev)
    sub_offsets = torch.as_tensor(sstore.offsets.astype(np.int64), device=dev)
    sub_sizes = sstore.lengths.astype(np.int32)
    int32_max = np.iinfo(np.int32).max
    order = np.argsort(qstore.lengths, kind="stable")
    parts = []
    for bs in range(0, len(order), query_batch_size):
        qidx = order[bs:bs + query_batch_size]
        n_real = len(qidx)
        if n_real < query_batch_size:  # the JAX package's fixed batch shape
            qidx = np.concatenate([qidx, np.repeat(qidx[-1:], query_batch_size - n_real)])
        pad = shapes.length_tier(int(qstore.lengths[qidx].max()))
        lens = qstore.lengths[qidx].astype(np.int32)
        lens[n_real:] = 0          # padding rows produce no k-mers, hence no hits
        if pairwise:
            limit = sstore.offsets[qidx].astype(np.int64)
        else:
            limit = np.full(len(qidx), int32_max, np.int64)
        soff_limit = torch.as_tensor(limit, device=dev)
        lens_dev = torch.as_tensor(lens, device=dev)
        for qdir in (0, 1):
            batch = qdev.read_rows(qidx, np.full(len(qidx), bool(qdir)), pad)
            st = candidates_forward(index, sub_offsets, batch, lens_dev,
                                    soff_limit, opts)
            parts.append(stats_to_candidates(st.cpu().numpy(), qidx.astype(np.int32),
                                             lens, qdir, sub_sizes, 0, opts))
    return top_n_per_query(Candidates.concat(parts), opts.ncan)
