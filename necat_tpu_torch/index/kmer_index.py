"""k-mer lookup table of one subject volume: (hash, position) pairs sorted by
hash, a top-bits bucket directory and per-entry run ends, on the device.

Counterpart of necat_tpu/index/kmer_index.py. The index is built on the host
by the native radix sort (necat_tpu_torch/native.py; _build_numpy is its
plain NumPy version, which the tests hold it against), then moved to the
device; index_from_numpy takes index arrays as they are, so that the tests
can hand both packages one index. k-mers occurring more than occ_cutoff times
are disabled at query time (lookup_table.c:14-57 kmer_cnt_cutoff).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from necat_tpu_torch import native
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
    """ceil(log2(largest bucket)) + 1, rounded up to {8, 12, 16, 24, 32} as
    the JAX package rounds it."""
    counts = np.diff(np.asarray(bucket_starts))
    steps = int(np.ceil(np.log2(max(2, int(counts.max()) if len(counts) else 1)))) + 1
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
