"""Several devices: the subject k-mer index split into read ranges, one per
device, and the candidate pass over those shards.

Counterpart of necat_tpu/parallel/mesh.py without a mesh. Where the JAX
package runs one shard_map program over its device mesh, the port keeps one
shard per device of the caller's list and runs each shard's pass on its own
device, from a host thread per device: candidates_forward reads its counts
to size its buffers, so one host thread would serialise the devices. The
queries are replicated; the union of the shards' candidates is put in the
single-device search's order by the caller (overlapper._search). The
pair-parallel extension is ExtendEngine's (chunks round-robin over the
devices), the correction's bucket round-robin correct_reads'.

A k-mer's occurrences are counted per shard, so occ_cutoff suppresses a
repeat only where one shard holds more than occ_cutoff of it (the
reference's per-volume lookup tables do the same): the sharded search equals
the single-device one while no k-mer of the subject reaches the cutoff.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from necat_tpu_torch.index.kmer_index import KmerIndex, build_index
from necat_tpu_torch.io.devstore import DeviceReadStore
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.candidates import candidates_forward
from necat_tpu_torch.overlap.options import MapOptions
from necat_tpu_torch.utils.logging import sync_dispatch, timed

INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass
class Shard:
    """Reads lo..hi-1 of a subject store: their k-mer index and read
    offsets on `device`, the slot-th device of the caller's list."""

    slot: int
    device: torch.device
    index: KmerIndex
    lo: int
    hi: int
    base: int                 # offset of read lo's first base in the store
    offsets: torch.Tensor     # int64[hi - lo + 1] on device, from 0
    sizes: np.ndarray         # int32[hi - lo] read lengths

    @classmethod
    def of(cls, store: ReadStore, lo: int, hi: int, slot: int, device,
           index: KmerIndex) -> "Shard":
        off = store.offsets[lo:hi + 1].astype(np.int64)
        return cls(slot=slot, device=device, index=index, lo=lo, hi=hi, base=int(off[0]),
                   offsets=torch.as_tensor(off - off[0], device=device),
                   sizes=np.diff(off).astype(np.int32))


class ShardedIndex:
    """Per-device k-mer index shards of one subject store: ceil(n_reads / D)
    contiguous reads each (necat_tpu/parallel/mesh.py:132-175), each built
    on its own device by build_index (on the card up to
    shapes.DEVICE_INDEX_MAX_BASES bases a shard). packed: per device, the
    store's reads already on that device, hashed instead of uploaded. A
    device left without reads gets no shard."""

    def __init__(self, devices: Sequence[torch.device], sstore: ReadStore, k: int,
                 occ_cutoff: int, n_bucket_bits: int = 14,
                 packed: Optional[Sequence[DeviceReadStore]] = None):
        n = sstore.n_reads
        per = -(-n // len(devices))
        self.shards: List[Shard] = []
        for s, dev in enumerate(devices):
            lo, hi = min(s * per, n), min((s + 1) * per, n)
            if hi == lo:
                continue
            index = build_index(sstore.slice(lo, hi), device=dev, k=k, occ_cutoff=occ_cutoff,
                                n_bucket_bits=n_bucket_bits,
                                packed=None if packed is None else packed[s].slice(lo, hi))
            self.shards.append(Shard.of(sstore, lo, hi, s, dev, index))


@contextlib.contextmanager
def device_threads(shards: Sequence[Shard]):
    """A pool of one host thread per distinct device of the shards, for
    shard_stats, or None where they share one device (shards on one card
    share its stream: threads would only contend for the interpreter)."""
    n = len({sh.device for sh in shards})
    if n <= 1:
        yield None
        return
    with ThreadPoolExecutor(n) as pool:
        yield pool


def shard_stats(shards: Sequence[Shard], batches: Sequence[torch.Tensor], lens: np.ndarray,
                limit: np.ndarray, opts: MapOptions,
                pool: Optional[ThreadPoolExecutor] = None) -> List[np.ndarray]:
    """One query batch's candidate pass against every shard, each on its
    device: the stats int32[9, P] of each shard, on the host. batches[i] is
    the batch u8[B, L] on shards[i]'s device. limit int64[B]: the pairwise
    limits in the store's base coordinates (INT32_MAX: none), made local to
    each shard; a query whose limit falls before the shard gets 0 there
    (necat_tpu/parallel/mesh.py:246-257). With a pool (device_threads), each
    device's shards run in turn in a thread of their own, the devices at
    once."""

    def run(i: int) -> np.ndarray:
        sh = shards[i]
        on_card = (torch.cuda.device(sh.device) if sh.device.type == "cuda"
                   else contextlib.nullcontext())
        with on_card:
            with timed("cand.limits"):
                lim = torch.as_tensor(np.minimum(np.maximum(limit - sh.base, 0), INT32_MAX),
                                      device=sh.device)
            with timed("cand.dispatch"):
                st = candidates_forward(sh.index, sh.offsets, batches[i],
                                        torch.as_tensor(lens, device=sh.device), lim, opts)
            sync_dispatch("cand.exec", sh.device)
            with timed("cand.stats_sync"):
                return st.cpu().numpy()

    if pool is None:
        return [run(i) for i in range(len(shards))]
    by_device: dict = {}
    for i, sh in enumerate(shards):
        by_device.setdefault(sh.device, []).append(i)
    tasks = [pool.submit(lambda idx=idx: [run(i) for i in idx]) for idx in by_device.values()]
    out: List[Optional[np.ndarray]] = [None] * len(shards)
    for idx, task in zip(by_device.values(), tasks):
        for i, st in zip(idx, task.result()):
            out[i] = st
    return out
