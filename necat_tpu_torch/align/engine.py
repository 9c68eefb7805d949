"""Chunked banded extension (counterpart of necat_tpu/align/engine.py).

Pairs are windowed on their subject, tiered by length and cut into chunks
that stay inside one caller group; each chunk's pair rows are gathered on the
device from the packed stores by one int32 descriptor array and extended.
The chunk's stats come back to the host once, on first use.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from necat_tpu_torch.align.banded import TAIL_MATCH, extend_batch
from necat_tpu_torch.io.devstore import gather_rows
from necat_tpu_torch.utils import logging as tlog, shapes
from necat_tpu_torch.utils.logging import count_lanes, sync_dispatch, timed

# descriptor columns (int32; DeviceReadStore guarantees offsets < 2^31)
DESC_COLS = ("qg", "qglen", "qrc", "tg", "tglen", "qlen", "tlen", "aq", "at")


def rescue_widths(band_width: int, scale: int, max_scale: int):
    """The long-indel rescue ladder's band widths: band_width * scale,
    doubling, up to max_scale and shapes.MAX_BAND (read at call time)."""
    while scale <= max_scale and band_width * scale <= shapes.MAX_BAND:
        yield band_width * scale
        scale *= 2


def count_live_cols(desc: np.ndarray, n_real: int) -> None:
    """Counter ext.live_Mcols of one planned chunk: the summed max(query,
    window) length of its real lanes (desc columns 5 and 4, the length its
    tier was chosen for), in millions. Host data, so no sync; nothing but a
    flag test while timing is off."""
    if tlog.TIMING_ON:
        live = desc[:n_real]
        tlog.count("ext.live_Mcols", int(np.maximum(live[:, 5], live[:, 4]).sum()) / 1e6)


def gather_extend(qdev, sdev, desc: torch.Tensor, W: int, L: int,
                  tail_match: int = TAIL_MATCH, insb_words: int = 1) -> dict:
    """Gather one chunk's pair rows from the packed stores and extend them.

    desc: int32[PB, >= 9] on the stores' device, DESC_COLS first. Returns
    extend_batch's fields plus the gathered query rows (qbatch)."""
    c = {k: desc[:, i] for i, k in enumerate(DESC_COLS)}
    qb = gather_rows(qdev.words, qdev.total_bases, c["qg"].long(),
                     c["qglen"].long(), c["qrc"].bool(), L)
    tb = gather_rows(sdev.words, sdev.total_bases, c["tg"].long(),
                     c["tglen"].long(), torch.zeros_like(c["qrc"], dtype=torch.bool), L)
    out = extend_batch(qb, c["qlen"], tb, c["tlen"], c["aq"], c["at"], W=W,
                       tail_match=tail_match, insb_words=insb_words)
    out["qbatch"] = qb
    return out


@dataclasses.dataclass
class ExtChunk:
    """One extended chunk: its device outputs and host metadata."""

    out: dict                 # device tensors (stats, cols, insb, lead, ...)
    sel: np.ndarray           # the caller's pair ids of the chunk's real lanes
    n_real: int
    L: int
    W: int
    ws: np.ndarray            # int64[n_real] window starts (absolute subject)
    group: int = 0
    aq: Optional[np.ndarray] = None     # int32[PB] host copies of the desc's aq
    at: Optional[np.ndarray] = None     # and at columns (at in window coordinates)
    live: Optional[np.ndarray] = None   # bool[PB] lane liveness (splice_rescue kills lanes)
    _stats: Optional[np.ndarray] = None

    def stats(self) -> np.ndarray:
        """Host stats [6, PB]: qoff, qend, toff, tend, n_cols, n_match
        (toff/tend in window coordinates). Syncs on the first call."""
        if self._stats is None:
            with timed("ext.stats_sync"):
                self._stats = self.out["stats"].cpu().numpy()
        return self._stats

    def release(self) -> None:
        """Drop the device outputs (the per-column buffers) once the stats
        are read."""
        self.out = {}


def collect_stats(chunks: List[ExtChunk], stats: dict, base_ci: int = 0) -> None:
    """Merge chunk stats into the flat per-pair arrays of `stats` (from
    new_stats; toff/tend made absolute); stats["lane"] maps a pair id to its
    (chunk index, lane)."""
    for ci, ch in enumerate(chunks, start=base_ci):
        st = ch.stats()
        r = slice(0, ch.n_real)
        idx = ch.sel
        stats["qoff"][idx] = st[0, r]
        stats["qend"][idx] = st[1, r]
        stats["toff"][idx] = st[2, r] + ch.ws
        stats["tend"][idx] = st[3, r] + ch.ws
        stats["n_cols"][idx] = st[4, r]
        stats["ident"][idx] = np.where(
            st[4, r] > 0, 100.0 * st[5, r] / np.maximum(st[4, r], 1), 0.0)
        for k, p in enumerate(idx):
            stats["lane"][int(p)] = (ci, k)


def new_stats(n_pairs: int) -> dict:
    out = {k: np.zeros(n_pairs, np.int64)
           for k in ("qoff", "qend", "toff", "tend", "n_cols")}
    out["ident"] = np.zeros(n_pairs, np.float64)
    out["lane"] = {}
    return out


class ExtendEngine:
    """Plans and runs extension chunks over a query and a subject
    DeviceReadStore on one device, or over lists of them, one (query,
    subject) pair of stores per device: a submitted pass then runs its
    chunks round-robin over the devices, whole chunks, where the JAX package
    splits each chunk's rows over its mesh (necat_tpu/parallel/mesh.py:105,
    align/engine.py:218). Lanes are independent, so the results are the
    same; each chunk's outputs stay on its device."""

    def __init__(self, qdev, sdev, pairs_per_chunk: int = 1024):
        self.qdevs = list(qdev) if isinstance(qdev, (list, tuple)) else [qdev]
        self.sdevs = list(sdev) if isinstance(sdev, (list, tuple)) else [sdev]
        if len(self.qdevs) != len(self.sdevs) or any(
                q.device != t.device for q, t in zip(self.qdevs, self.sdevs)):
            raise ValueError("ExtendEngine takes one query and one subject store per device")
        self.qdev = self.qdevs[0]      # every device's stores hold the same reads
        self.sdev = self.sdevs[0]
        self.cap = pairs_per_chunk
        self.device = self.qdev.device

    def plan(
        self,
        qids: np.ndarray,       # per-pair query read id (into qdev)
        qdir: np.ndarray,       # per-pair query strand
        qsize: np.ndarray,      # query lengths
        tg_base: np.ndarray,    # absolute base offset of each pair's subject
        tsize: np.ndarray,      # subject lengths
        aq: np.ndarray,         # anchor on the query (qdir-strand coords)
        at_abs: np.ndarray,     # anchor on the subject (absolute coords)
        W: int,
        groups: Optional[np.ndarray] = None,   # chunk-purity key per pair
        window_margin: int = 600,
        extra_cols: Optional[Dict[str, np.ndarray]] = None,
    ) -> List[dict]:
        """Window + tier + chunk the pair set. Returns per-chunk dicts: desc
        int32[PB, 9 + len(extra_cols)], take (indices into the pair arrays), ws
        (window starts), L (length tier), n_real, group, PB. Extra per-pair
        columns follow the 9 DESC_COLS in dict order; padding lanes hold -1
        there.

        Subject windows around the anchor are bounded by 1.3x the query side
        plus a margin (oc_aligner.c:127-131), so the padded target size
        follows the query length. Each chunk holds PB = max(8, next power of
        two >= its pairs) lanes, at most the tier's pairs_per_chunk (beyond
        the largest length tier: as many as EXTENSION_BYTES holds, at least
        one, and no padding to 8): on the card a chunk of any size costs no
        extra compile, so it is sized to its work."""
        qids = np.asarray(qids)
        if len(qids) == 0:
            return []
        left_need = (np.asarray(aq).astype(np.int64) * 13) // 10 + window_margin
        right_need = ((qsize - aq).astype(np.int64) * 13) // 10 + window_margin
        ws = np.maximum(at_abs - left_need, 0)
        we = np.minimum(at_abs + right_need, tsize.astype(np.int64))
        wlen = we - ws
        tier = np.array([shapes.length_tier(int(max(qsize[i], wlen[i])))
                         for i in range(len(qids))])
        gkey = np.zeros(len(qids), np.int64) if groups is None else np.asarray(groups)
        # within a group, largest tiers first; a chunk absorbs same-group
        # pairs of any lower tier
        order = np.lexsort((qsize, -tier, gkey))
        n_extra = len(extra_cols) if extra_cols else 0
        planned: List[dict] = []
        cs = 0
        while cs < len(order):
            i0 = order[cs]
            L = int(tier[i0])
            g = gkey[i0]
            per_chunk, min_lanes = min(shapes.pairs_per_chunk(L, W), self.cap), 8
            if L > shapes.LENGTH_TIERS[-1]:
                # contig-length pairs (the bridge's contig-to-contig
                # extension): 8 lanes of L * W dirs bytes would not fit
                # the card; lanes are independent, so results are unchanged
                fit = max(1, shapes.EXTENSION_BYTES // (L * W))
                per_chunk, min_lanes = 1 << (fit.bit_length() - 1), 1
            take = order[cs:cs + per_chunk]
            keep = gkey[take] == g
            if not keep.all():                  # cut at the group boundary
                take = take[:np.argmin(keep)]
            cs += len(take)
            n_real = len(take)
            PB = max(min_lanes, 1 << (n_real - 1).bit_length())
            with timed("ext.chunk_build"):
                desc = np.zeros((PB, len(DESC_COLS) + n_extra), np.int32)
                qi = qids[take]
                desc[:n_real, 0] = self.qdev.offsets[qi]
                desc[:n_real, 1] = self.qdev.offsets[qi + 1] - self.qdev.offsets[qi]
                desc[:n_real, 2] = qdir[take]
                desc[:n_real, 3] = tg_base[take] + ws[take]
                desc[:n_real, 4] = wlen[take]
                desc[:n_real, 5] = qsize[take]
                desc[:n_real, 6] = wlen[take]
                desc[:n_real, 7] = aq[take]
                desc[:n_real, 8] = at_abs[take] - ws[take]
                if extra_cols:
                    desc[:, len(DESC_COLS):] = -1
                    for ci, arr in enumerate(extra_cols.values()):
                        desc[:n_real, len(DESC_COLS) + ci] = np.asarray(arr)[take]
            planned.append(dict(desc=desc, take=take, ws=ws[take].copy(),
                                L=L, n_real=n_real, group=int(g), PB=PB))
        return planned

    def submit(self, sel, qids, qdir, qsize, tg_base, tsize, aq, at_abs, W: int,
               groups: Optional[np.ndarray] = None, window_margin: int = 600,
               insb_words: int = 1) -> List[ExtChunk]:
        """Plan the pairs (plan's arguments; sel = the caller's pair ids) and
        extend every chunk, chunk i on device i mod the devices. Kernel
        launches are asynchronous; a chunk's stats() is its sync point."""
        sel = np.asarray(sel)
        chunks: List[ExtChunk] = []
        for i, p in enumerate(self.plan(qids, qdir, qsize, tg_base, tsize, aq, at_abs, W,
                                        groups=groups, window_margin=window_margin)):
            qdev, sdev = self.qdevs[i % len(self.qdevs)], self.sdevs[i % len(self.qdevs)]
            with timed("ext.dispatch"):
                with timed("ext.desc_upload"):
                    desc = torch.from_numpy(p["desc"]).to(qdev.device)
                with timed("ext.enqueue"):
                    out = gather_extend(qdev, sdev, desc, W, p["L"], insb_words=insb_words)
                sync_dispatch("ext.device_exec", qdev.device)
            count_lanes(p["PB"], p["n_real"], p["L"])
            count_live_cols(p["desc"], p["n_real"])
            chunks.append(ExtChunk(out=out, sel=sel[p["take"]], n_real=p["n_real"],
                                   L=p["L"], W=W, ws=p["ws"], group=p["group"],
                                   aq=p["desc"][:, 7].copy(), at=p["desc"][:, 8].copy(),
                                   live=np.ones(p["PB"], bool)))
        return chunks


def splice_rescue(all_chunks: List[ExtChunk], rescue_chunks: List[ExtChunk],
                  stats: dict) -> int:
    """Keep each rescued pair's wider-band result where it aligned at least
    as many columns (the reference falls back to the small-band result
    otherwise, consensus_aux.c:203-213); kill the losing lane, point
    stats["lane"] at the winner and append rescue_chunks to all_chunks.
    Returns the number of pairs whose result was replaced."""
    improved = 0
    for ci, ch in enumerate(rescue_chunks, start=len(all_chunks)):
        st = ch.stats()
        r = slice(0, ch.n_real)
        idx = ch.sel
        better = st[4, r] >= stats["n_cols"][idx]
        for k, (p, b) in enumerate(zip(idx, better)):
            if b:
                oci, ok_ = stats["lane"][int(p)]
                all_chunks[oci].live[ok_] = False
                stats["lane"][int(p)] = (ci, k)
            else:
                ch.live[k] = False
        upd = idx[better]
        ur = np.flatnonzero(better)
        stats["qoff"][upd] = st[0, ur]
        stats["qend"][upd] = st[1, ur]
        stats["toff"][upd] = st[2, ur] + ch.ws[ur]
        stats["tend"][upd] = st[3, ur] + ch.ws[ur]
        stats["n_cols"][upd] = st[4, ur]
        stats["ident"][upd] = np.where(
            st[4, ur] > 0, 100.0 * st[5, ur] / np.maximum(st[4, ur], 1), 0.0)
        improved += int(better.sum())
    all_chunks.extend(rescue_chunks)
    return improved
