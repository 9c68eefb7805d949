"""ReadStore: a flat store of 2-bit-encodable reads (the port's copy of
necat_tpu/io/readstore.py: subject volumes and the packed container
dump_packed / load_packed included).

Sequences are one concatenated uint8 code array (values 0..3) plus int64
offsets (the role of the reference's PackedDB, src/common/packed_db.{h,c});
pack_2bit gives the device store's 16-bases-per-word layout. FASTA/FASTQ
files are parsed by the native library (necat_tpu_torch/native.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from necat_tpu_torch import native
from necat_tpu_torch.io import seqio


@dataclasses.dataclass
class ReadStore:
    """Flat concatenated read set.

    Attributes:
      bases: uint8[total_bases], codes 0..3.
      offsets: int64[n_reads + 1], read i occupies bases[offsets[i]:offsets[i+1]].
      names: list of read names (may be empty strings for anonymous reads).
    """

    bases: np.ndarray
    offsets: np.ndarray
    names: List[str]

    @property
    def n_reads(self) -> int:
        return len(self.offsets) - 1

    @property
    def total_bases(self) -> int:
        return int(self.offsets[-1])

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int64)

    def __len__(self) -> int:
        return self.n_reads

    def get(self, i: int, rc: bool = False) -> np.ndarray:
        s = self.bases[self.offsets[i]:self.offsets[i + 1]]
        return seqio.revcomp(s) if rc else s

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(self.n_reads):
            yield self.get(i)

    @classmethod
    def from_seqs(cls, seqs: Sequence[np.ndarray], names: Sequence[str] | None = None) -> "ReadStore":
        lengths = np.array([len(s) for s in seqs], dtype=np.int64)
        offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        bases = np.concatenate([np.asarray(s, dtype=np.uint8) for s in seqs]) if seqs else np.zeros(0, np.uint8)
        if names is None:
            names = [str(i) for i in range(len(seqs))]
        return cls(bases=bases, offsets=offsets, names=list(names))

    @classmethod
    def concat(cls, stores: Sequence["ReadStore"]) -> "ReadStore":
        """Merge stores with one array concatenation per field."""
        stores = list(stores)
        if len(stores) == 1:
            return stores[0]
        if not stores:
            return cls(bases=np.zeros(0, np.uint8),
                       offsets=np.zeros(1, np.int64), names=[])
        bases = np.concatenate([s.bases for s in stores])
        sizes = np.concatenate([s.lengths for s in stores])
        offsets = np.zeros(len(sizes) + 1, np.int64)
        np.cumsum(sizes, out=offsets[1:])
        names = [n for s in stores for n in s.names]
        return cls(bases=bases, offsets=offsets, names=names)

    @classmethod
    def from_fasta(cls, path: str | os.PathLike, min_length: int = 0) -> "ReadStore":
        names, bases, offsets = native.read_seq_file(os.fspath(path))
        store = cls(bases=bases, offsets=offsets, names=names)
        if min_length > 0:
            keep = np.flatnonzero(store.lengths >= min_length)
            if len(keep) != store.n_reads:
                store = store.subset(keep)
        return store

    def to_fasta(self, path: str | os.PathLike) -> None:
        seqio.write_fasta(path, self.names, list(self))

    def slice(self, lo: int, hi: int) -> "ReadStore":
        """Reads lo..hi-1 as a store of their own (a subject volume or
        shard), its bases a view of this store's."""
        off = self.offsets
        return ReadStore(bases=self.bases[off[lo]:off[hi]], offsets=off[lo:hi + 1] - off[lo],
                         names=self.names[lo:hi])

    def subset(self, idx: np.ndarray) -> "ReadStore":
        """Gather a sub-store in one vectorised pass."""
        idx = np.asarray(idx, dtype=np.int64)
        lens = self.lengths[idx]
        offsets = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        total = int(offsets[-1])
        src = (np.repeat(self.offsets[idx], lens)
               + np.arange(total, dtype=np.int64)
               - np.repeat(offsets[:-1], lens))
        names = [self.names[int(i)] for i in idx]
        return ReadStore(bases=self.bases[src], offsets=offsets, names=names)

    def n50(self) -> Tuple[int, int]:
        """(N50 length, number of reads >= N50) (fsa_rd_tools n50,
        src/fsa/read_tools.cpp)."""
        ls = np.sort(self.lengths)[::-1]
        if len(ls) == 0:
            return 0, 0
        half = ls.sum() / 2
        c = np.cumsum(ls)
        i = int(np.searchsorted(c, half))
        return int(ls[i]), i + 1

    def longest_to_coverage(self, genome_size: int, coverage: float) -> np.ndarray:
        """Indices of the longest reads whose total is ~genome_size*coverage
        bases (fsa_rd_tools longest, src/fsa/read_tools.cpp:33)."""
        target = int(genome_size * coverage)
        order = np.argsort(self.lengths, kind="stable")[::-1]
        csum = np.cumsum(self.lengths[order])
        n_keep = int(np.searchsorted(csum, target)) + 1
        n_keep = min(n_keep, self.n_reads)
        return np.sort(order[:n_keep])

    def volumes(self, vol_size: int = 2_000_000_000) -> List[Tuple[int, int]]:
        """Split into shards of <= vol_size bases at read boundaries: a list
        of (read_start, read_end). A read longer than vol_size gets a volume
        of its own (oc2mkdb's volumes, src/makedb/main.c:8-46, kVolSize)."""
        out: List[Tuple[int, int]] = []
        start = 0
        acc = 0
        lens = self.lengths
        for i in range(self.n_reads):
            if acc + int(lens[i]) > vol_size and i > start:
                out.append((start, i))
                start = i
                acc = 0
            acc += int(lens[i])
        if start < self.n_reads:
            out.append((start, self.n_reads))
        return out

    def padded_batch(self, idx: np.ndarray, pad_to: int | None = None,
                     multiple: int = 128, rc: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Reads idx as a [B, L] uint8 array padded with 0, and their lengths."""
        idx = np.asarray(idx, dtype=np.int64)
        lens = self.lengths[idx]
        L = int(lens.max()) if pad_to is None else pad_to
        L = -(-L // multiple) * multiple
        out = np.zeros((len(idx), L), dtype=np.uint8)
        take = np.minimum(lens, L)
        total = int(take.sum())
        rows = np.repeat(np.arange(len(idx), dtype=np.int64), take)
        cols = (np.arange(total, dtype=np.int64)
                - np.repeat(np.cumsum(take) - take, take))
        if rc:
            src = np.repeat(self.offsets[idx] + lens - 1, take) - cols
            out[rows, cols] = 3 - self.bases[src]
        else:
            src = np.repeat(self.offsets[idx], take) + cols
            out[rows, cols] = self.bases[src]
        return out, lens.astype(np.int32)


_PAC_MAGIC = b"NTPC"     # the packed container of necat_tpu/io/readstore.py:205-259
_PAC_VERSION = 1


def dump_packed(store: ReadStore, path: str | os.PathLike) -> None:
    """Write the store as a 2-bit packed container (the pdb_dump role,
    src/common/packed_db.c:291-315), byte for byte the JAX package's format:
    magic, then version, n_reads and total_bases (u64), offsets[n + 1]
    (i64), the names' blob length (u64) and the utf-8 names joined by
    newlines, and the u32 words of pack_2bit."""
    with open(path, "wb") as f:
        f.write(_PAC_MAGIC)
        np.array([_PAC_VERSION, store.n_reads, store.total_bases], np.uint64).tofile(f)
        store.offsets.astype(np.int64).tofile(f)
        blob = "\n".join(store.names).encode()
        np.array([len(blob)], np.uint64).tofile(f)
        f.write(blob)
        pack_2bit(store.bases).tofile(f)


def load_packed(path: str | os.PathLike) -> ReadStore:
    """The store dump_packed wrote (the pdb_load role, packed_db.c:386);
    ValueError for another file or version."""
    with open(path, "rb") as f:
        if f.read(4) != _PAC_MAGIC:
            raise ValueError(f"{path}: not a packed read store")
        ver, n_reads, total = np.fromfile(f, np.uint64, 3)
        if ver != _PAC_VERSION:
            raise ValueError(f"{path}: unsupported version {ver}")
        offsets = np.fromfile(f, np.int64, int(n_reads) + 1)
        blob = f.read(int(np.fromfile(f, np.uint64, 1)[0])).decode()
        names = blob.split("\n") if blob else [""] * int(n_reads)
        words = np.fromfile(f, np.uint32, -(-int(total) // 16))
    return ReadStore(bases=unpack_2bit(words, int(total)), offsets=offsets, names=names)


def pack_2bit(bases: np.ndarray) -> np.ndarray:
    """Pack uint8 codes 0..3 into uint32 words, 16 bases per word, base 0 in the
    high bits (the _set_pac bit layout, src/common/ontcns_aux.h:118)."""
    n = len(bases)
    n_pad = -(-n // 16) * 16
    b = np.zeros(n_pad, dtype=np.uint32)
    b[:n] = bases
    b = b.reshape(-1, 16)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    return (b << shifts).sum(axis=1, dtype=np.uint32)


def unpack_2bit(words: np.ndarray, n: int) -> np.ndarray:
    """The first n bases of pack_2bit's words, uint8 codes 0..3."""
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    return ((words[:, None] >> shifts) & 3).reshape(-1)[:n].astype(np.uint8)
