"""k-mer lookup table of one subject volume: (hash, position) pairs sorted by
hash, a top-bits bucket directory and per-entry run ends, on the device.

Counterpart of necat_tpu/index/kmer_index.py. build_index picks the build
as the JAX package's build_index does: on the card (build_on_device: torch
ops over the 2-bit packed words, one stable torch.sort) for a volume of at
most shapes.DEVICE_INDEX_MAX_BASES bases, otherwise on the host by the
native radix sort (necat_tpu_torch/native.py; _build_numpy is its plain
NumPy version, which the tests hold both builds against), then moved to the
device. index_from_numpy takes index arrays as they are, so that the tests
can hand both packages one index. k-mers occurring more than occ_cutoff
times are disabled at query time (lookup_table.c:14-57 kmer_cnt_cutoff).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from necat_tpu_torch import native
from necat_tpu_torch.io.devstore import DeviceReadStore
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.utils import shapes
from necat_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class KmerIndex:
    k: int
    occ_cutoff: int
    n_bucket_bits: int
    sorted_hashes: torch.Tensor      # int32[M]
    sorted_positions: torch.Tensor   # int32[M], offsets into the volume's bases
    bucket_starts: torch.Tensor      # int32[2^B + 1], directory over hash top bits
    run_end: torch.Tensor            # int32[M], end of the equal-hash run of i
    n_search_steps: int              # binary-search steps within one bucket

    @classmethod
    def build(cls, bases: np.ndarray, offsets: np.ndarray, *, device, k: int = 15,
              occ_cutoff: int = 500, n_bucket_bits: int = 22) -> "KmerIndex":
        """Index of every k-mer that does not span a read boundary."""
        if k > 15:
            raise ValueError("k must fit 30 bits (int32 hashes)")
        n_bucket_bits = min(n_bucket_bits, 2 * k)
        sh, sp, bucket_starts = native.build_kmer_index(bases, offsets, k, n_bucket_bits)
        return index_from_numpy(k=k, occ_cutoff=occ_cutoff,
                                n_bucket_bits=n_bucket_bits, sorted_hashes=sh,
                                sorted_positions=sp, bucket_starts=bucket_starts,
                                run_end=_run_ends(sh),
                                n_search_steps=_search_steps(bucket_starts),
                                device=device)

    @classmethod
    def build_on_device(cls, store, *, device, k: int = 15, occ_cutoff: int = 500,
                        n_bucket_bits: int = 22) -> "KmerIndex":
        """The same index as build, built with torch ops on `device` from the 2-bit
        packed words: `store` is a DeviceReadStore on `device` (a slice of
        one indexes its reads, positions from its first base) or a
        ReadStore, whose words are packed and uploaded. The arrays equal
        the host build's, array for array (only the valid k-mers: the JAX
        version's pow2 padding serves XLA's shared executables, which
        PyTorch does not need); n_search_steps takes one host read of the
        largest bucket (necat_tpu/index/kmer_index.py:143-184)."""
        if k > 15:
            raise ValueError("k must fit 30 bits (int32 hashes)")
        n_bucket_bits = min(n_bucket_bits, 2 * k)
        dev = resolve_device(device)
        if isinstance(store, ReadStore):
            store = DeviceReadStore(store, dev)
        elif not isinstance(store, DeviceReadStore) or store.device != dev:
            raise ValueError(f"build_on_device on {dev} takes a ReadStore or a "
                             f"DeviceReadStore on {dev}")
        base_lo = int(store.offsets[0])
        ends = torch.as_tensor(store.offsets[1:] - base_lo, device=dev)
        sh, sp, bucket_starts, run_end = _build_device(
            store.words, base_lo, int(store.offsets[-1]) - base_lo, ends, k, n_bucket_bits)
        largest = int(torch.diff(bucket_starts).max())
        return cls(k=k, occ_cutoff=occ_cutoff, n_bucket_bits=n_bucket_bits,
                   sorted_hashes=sh, sorted_positions=sp, bucket_starts=bucket_starts,
                   run_end=run_end, n_search_steps=_steps_for(largest))

    @property
    def n_kmers(self) -> int:
        """Entries of the index: the valid k-mers of the volume."""
        return int(self.sorted_hashes.shape[0])

    @property
    def avg_multiplicity(self) -> float:
        """Mean positions per distinct k-mer (about the read set's
        coverage; necat_tpu/index/kmer_index.py:64-75). One device read."""
        sh = self.sorted_hashes
        distinct = int((sh[1:] != sh[:-1]).sum()) + 1 if self.n_kmers else 1
        return self.n_kmers / distinct

    def lookup_ranges(self, qh: torch.Tensor):
        """(start, count) in the sorted lists for each query hash; counts above
        occ_cutoff are zeroed (repeat suppression). A binary search for the
        left bound within the hash's bucket, then one run_end gather."""
        sh = self.sorted_hashes
        M = sh.shape[0]
        bucket = (qh >> (2 * self.k - self.n_bucket_bits)).long()
        lo = self.bucket_starts[bucket].long()
        hi = self.bucket_starts[bucket + 1].long()
        lo_l, hi_l = lo, hi
        for _ in range(self.n_search_steps):
            mid = torch.div(lo_l + hi_l, 2, rounding_mode="floor")
            go_right = sh[mid.clamp(0, M - 1)] < qh     # JAX clamps gather indices
            lo_l, hi_l = torch.where(go_right, mid + 1, lo_l), torch.where(go_right, hi_l, mid)
        safe = lo_l.clamp(0, M - 1)
        hit = (lo_l < hi) & (sh[safe] == qh)
        count = torch.where(hit, self.run_end[safe] - lo_l, 0)
        count = torch.where(count > self.occ_cutoff, 0, count)
        return lo_l, count


def index_from_numpy(*, k, occ_cutoff, n_bucket_bits, sorted_hashes,
                     sorted_positions, bucket_starts, run_end, n_search_steps,
                     device) -> KmerIndex:
    """KmerIndex on `device` from host arrays (the tests hand it the JAX
    package's index fields as numpy arrays)."""
    dev = resolve_device(device)
    as_dev = lambda x: torch.as_tensor(np.asarray(x).astype(np.int32), device=dev)
    return KmerIndex(k=int(k), occ_cutoff=int(occ_cutoff),
                     n_bucket_bits=int(n_bucket_bits),
                     sorted_hashes=as_dev(sorted_hashes),
                     sorted_positions=as_dev(sorted_positions),
                     bucket_starts=as_dev(bucket_starts), run_end=as_dev(run_end),
                     n_search_steps=int(n_search_steps))


# seconds of each k-mer index build of build_index, in order (one per
# subject volume or shard), for the callers' reports; never cleared here
index_build_s: List[float] = []


def build_index(store: ReadStore, *, device, k: int, occ_cutoff: int,
                n_bucket_bits: int = 22,
                packed: Optional[DeviceReadStore] = None) -> KmerIndex:
    """The index of store's reads on `device`, built where the JAX package's
    build_index builds it (necat_tpu/overlap/overlapper.py:33-46): on the
    card (build_on_device) when `device` is CUDA and the store holds at most
    shapes.DEVICE_INDEX_MAX_BASES bases, otherwise on the host by the native
    radix sort, then uploaded. packed: the store's reads already on `device`
    (a DeviceReadStore, or a slice of one), hashed instead of uploading them.
    Appends the build's seconds to index_build_s; a device build's clock
    stops after a synchronize."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if dev.type == "cuda" and store.total_bases <= shapes.DEVICE_INDEX_MAX_BASES:
        index = KmerIndex.build_on_device(store if packed is None else packed,
                                          device=dev, k=k, occ_cutoff=occ_cutoff,
                                          n_bucket_bits=n_bucket_bits)
        torch.cuda.synchronize(dev)
    else:
        index = KmerIndex.build(store.bases, store.offsets, device=dev, k=k,
                                occ_cutoff=occ_cutoff, n_bucket_bits=n_bucket_bits)
    index_build_s.append(time.perf_counter() - t0)
    return index


def _build_device(words, base_lo: int, total: int, ends, k: int, n_bucket_bits: int):
    """(sorted_hashes, sorted_positions, bucket_starts, run_end), int32 on
    words' device, of the bases [base_lo, base_lo + total) of the packed
    words (16 a word, base 0 in the high bits) whose reads end at `ends`
    (relative to base_lo): _build_numpy's arrays, from torch ops."""
    dev = words.device
    i32 = torch.int32
    n = total - k + 1
    nb = 1 << n_bucket_bits
    if n <= 0:
        z = torch.zeros(0, dtype=i32, device=dev)
        return z, z, torch.zeros(nb + 1, dtype=i32, device=dev), z
    w0 = base_lo >> 4
    shifts = 30 - 2 * torch.arange(16, dtype=i32, device=dev)
    # words hold uint32 bit patterns as int32: >> sign-extends, & 3 drops it
    bases = ((words[w0:(base_lo + total + 15) >> 4, None] >> shifts) & 3).to(torch.uint8)
    bases = bases.reshape(-1)[base_lo - 16 * w0:base_lo - 16 * w0 + total]
    h = torch.zeros(n, dtype=i32, device=dev)
    for j in range(k):
        h.bitwise_left_shift_(2).bitwise_or_(bases[j:j + n])
    # k-mers spanning a read end start at end-k+1 .. end-1 of some read (a
    # mark may fall into the read before a short one, where it is invalid too)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    bad = (ends[None, :] - torch.arange(1, k, device=dev)[:, None]).reshape(-1)
    valid[bad[(bad >= 0) & (bad < n)]] = False
    pos = torch.nonzero(valid)[:, 0]
    del valid, bases
    # stable: positions ascend within a hash, as in the native LSD radix sort
    sh, order = torch.sort(h[pos], stable=True)
    del h
    sp = pos[order].to(i32)
    del pos, order
    bucket_starts = torch.searchsorted(
        sh >> (2 * k - n_bucket_bits), torch.arange(nb + 1, dtype=i32, device=dev)).to(i32)
    _, counts = torch.unique_consecutive(sh, return_counts=True)
    run_end = torch.repeat_interleave(torch.cumsum(counts, 0), counts).to(i32)
    return sh, sp, bucket_starts, run_end


def _build_numpy(bases, offsets, k, n_bucket_bits):
    """Plain NumPy version of the native build: stable sort by hash, so
    positions ascend within a hash."""
    n = len(bases) - k + 1
    h = np.zeros(max(n, 0), dtype=np.int64)
    for j in range(k):
        h = (h << 2) | bases[j:j + n]
    pos = np.arange(len(h), dtype=np.int64)
    valid = pos + k <= offsets[np.searchsorted(offsets, pos, side="right")]
    hashes = h[valid]
    order = np.argsort(hashes, kind="stable")
    sh = hashes[order].astype(np.int32)
    sp = pos[valid][order].astype(np.int32)
    bucket_starts = np.zeros((1 << n_bucket_bits) + 1, dtype=np.int64)
    np.add.at(bucket_starts, (sh >> (2 * k - n_bucket_bits)).astype(np.int64) + 1, 1)
    np.cumsum(bucket_starts, out=bucket_starts)
    return sh, sp, bucket_starts


def _run_ends(sh: np.ndarray) -> np.ndarray:
    """run_end[i] = one past the last index of the equal-hash run holding i."""
    if len(sh) == 0:
        return np.zeros(0, np.int32)
    change = np.r_[sh[1:] != sh[:-1], True]
    ends = np.flatnonzero(change) + 1
    return ends[np.cumsum(np.r_[False, change[:-1]])].astype(np.int32)


def _search_steps(bucket_starts) -> int:
    """_steps_for the largest bucket of a host directory."""
    counts = np.diff(np.asarray(bucket_starts))
    return _steps_for(int(counts.max()) if len(counts) else 1)


def _steps_for(largest_bucket: int) -> int:
    """ceil(log2(largest bucket)) + 1, rounded up to {8, 12, 16, 24, 32} as
    the JAX package rounds it."""
    steps = int(np.ceil(np.log2(max(2, largest_bucket)))) + 1
    return next((r for r in (8, 12, 16, 24, 32) if steps <= r), 32)


def query_kmer_hashes(batch: torch.Tensor, lens: torch.Tensor, k: int,
                      scan_window: int):
    """Sampled k-mer hashes of a padded query batch u8[B, L] at positions
    0, w, 2w, ... (word_finder.c:65-82): (hashes i32[B, S], qoffs i32[S],
    valid bool[B, S]) with S = (L - k) // w + 1."""
    B, L = batch.shape
    dev = batch.device
    S = max(1, (L - k) // scan_window + 1)
    qoffs = torch.arange(S, dtype=torch.int32, device=dev) * scan_window
    cols = torch.minimum(qoffs[:, None] + torch.arange(k, dtype=torch.int32,
                                                       device=dev)[None, :],
                         torch.tensor(L - 1, dtype=torch.int32, device=dev))
    sub = batch[:, cols.long()].to(torch.int32)                   # [B, S, k]
    weights = 1 << (2 * torch.arange(k - 1, -1, -1, dtype=torch.int32, device=dev))
    h = (sub * weights).sum(-1, dtype=torch.int32)
    valid = (qoffs[None, :] + k) <= lens[:, None]
    return h, qoffs, valid
