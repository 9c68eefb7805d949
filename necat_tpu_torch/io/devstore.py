"""Device-resident 2-bit packed read store and the batch row gather.

Counterpart of necat_tpu/io/devstore.py: the packed words (16 bases per
32-bit word, base 0 in the high bits, readstore.pack_2bit) are uploaded once,
and padded [P, L] uint8 batches are gathered on the device from (start,
length, reverse-complement) row descriptors.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from necat_tpu_torch.io.readstore import ReadStore, pack_2bit
from necat_tpu_torch.utils import shapes
from necat_tpu_torch.utils.device import resolve_device


class DeviceReadStore:
    """words: device int32[NW] (the uint32 bit patterns); offsets: HOST
    int64[n_reads + 1], since row descriptors are built on the host
    (offsets[0] is 0 but in a slice); total_bases bounds the words."""

    def __init__(self, store: ReadStore, device):
        if not isinstance(store, ReadStore):
            raise TypeError(f"DeviceReadStore takes necat_tpu_torch's ReadStore, not "
                            f"{type(store).__module__}.{type(store).__name__}")
        if store.total_bases >= shapes.DEVICE_STORE_MAX_BASES:
            raise ValueError(f"DeviceReadStore requires < {shapes.DEVICE_STORE_MAX_BASES} "
                             "bases (shapes.DEVICE_STORE_MAX_BASES)")
        self.device = resolve_device(device)
        words = pack_2bit(store.bases).view(np.int32)
        self.words = torch.from_numpy(words.copy()).to(self.device)
        self.total_bases = store.total_bases
        self.offsets = store.offsets.astype(np.int64)

    def slice(self, lo: int, hi: int) -> "DeviceReadStore":
        """Reads lo..hi-1 as a store of their own that shares these words on
        the device: its offsets stay offsets into the words (offsets[0] is
        read lo's first base), so nothing is packed or uploaded again."""
        view = copy.copy(self)
        view.offsets = self.offsets[lo:hi + 1]
        return view

    def gather(self, gstart, glen, rc, L: int) -> torch.Tensor:
        """uint8[P, L]: row p = bases[gstart_p : gstart_p + glen_p],
        reverse-complemented where rc_p, zero-padded to L."""
        as_dev = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt,
                                               device=self.device)
        return gather_rows(self.words, self.total_bases,
                           as_dev(gstart, torch.int64), as_dev(glen, torch.int64),
                           as_dev(rc, torch.bool), L)

    def read_rows(self, ids, rc, L: int) -> torch.Tensor:
        """Whole reads `ids` (reverse-complemented where rc) padded to L."""
        ids = np.asarray(ids)
        gstart = self.offsets[ids]
        return self.gather(gstart, self.offsets[ids + 1] - gstart, rc, L)


def gather_rows(words, total_bases: int, gstart, glen, rc, L: int) -> torch.Tensor:
    """Unpack, slice and reverse-complement rows of the packed store.

    out[p, j] = base(gstart + j) for j < glen, or 3 - base(gstart + glen-1-j)
    where rc; 0 past glen. Positions at or past total_bases read as base 0,
    the zero padding of the packed buffer. Counterpart of
    necat_tpu/io/devstore.py:_gather_rows."""
    j = torch.arange(L, device=words.device)[None, :]
    glen = glen[:, None]
    pos = torch.where(rc[:, None], glen - 1 - j, j)
    g = gstart[:, None] + pos
    ok = (j < glen) & (pos < L)
    stored = ok & (g < total_bases)
    g = torch.where(stored, g, 0)
    base = (words[g >> 4] >> (30 - 2 * (g & 15))) & 3
    base = torch.where(stored, base, 0)
    base = torch.where(rc[:, None], 3 - base, base)
    return torch.where(ok, base, 0).to(torch.uint8)
