"""M4 overlap records (SoA), the inter-stage overlap format (the port's copy
of the part of necat_tpu/overlap/m4.py it uses).

Mirrors M4Record (src/common/m4_record.h:10-25): qid, sid, ident_perc, vscore,
qdir/qoff/qend/qsize, sdir/soff/send/ssize. Convention: subject dir is always
FWD (sdir=0); query coords are on the qdir strand. The text format is the
reference's whitespace format.
"""

from __future__ import annotations

import dataclasses
import gzip
import os

import numpy as np

_FIELDS = ("qid", "sid", "ident", "vscore", "qdir", "qoff", "qend", "qsize",
           "sdir", "soff", "send", "ssize")


@dataclasses.dataclass
class M4Records:
    qid: np.ndarray
    sid: np.ndarray
    ident: np.ndarray     # float32 percent
    vscore: np.ndarray    # int32 (chain score)
    qdir: np.ndarray      # int8
    qoff: np.ndarray
    qend: np.ndarray
    qsize: np.ndarray
    sdir: np.ndarray      # int8, always 0 in our outputs
    soff: np.ndarray
    send: np.ndarray
    ssize: np.ndarray

    def __len__(self) -> int:
        return len(self.qid)

    @classmethod
    def empty(cls) -> "M4Records":
        z = np.zeros(0, np.int32)
        return cls(z, z, np.zeros(0, np.float32), z, z.astype(np.int8), z, z, z,
                   z.astype(np.int8), z, z, z)

    @staticmethod
    def concat(parts) -> "M4Records":
        parts = [p for p in parts if len(p)]
        if not parts:
            return M4Records.empty()
        return M4Records(*[np.concatenate([getattr(p, f) for p in parts]) for f in _FIELDS])

    def take(self, idx) -> "M4Records":
        return M4Records(*[getattr(self, f)[idx] for f in _FIELDS])

    def swap_roles(self) -> "M4Records":
        """Duplicate-with-roles-swapped (trim pm4 fix_asm_m4_offsets,
        src/trim_bases/pm4_aux.c:117-139), keeping sdir FWD by mirroring
        coordinates when qdir is REV (like Candidates.swap_roles)."""
        rev = self.qdir == 1
        return M4Records(
            qid=self.sid.copy(), sid=self.qid.copy(),
            ident=self.ident.copy(), vscore=self.vscore.copy(),
            qdir=self.qdir.copy(),
            qoff=np.where(rev, self.ssize - self.send, self.soff).astype(np.int32),
            qend=np.where(rev, self.ssize - self.soff, self.send).astype(np.int32),
            qsize=self.ssize.copy(),
            sdir=np.zeros(len(self), np.int8),
            soff=np.where(rev, self.qsize - self.qend, self.qoff).astype(np.int32),
            send=np.where(rev, self.qsize - self.qoff, self.qend).astype(np.int32),
            ssize=self.qsize.copy(),
        )

    def fwd_query_range(self):
        """(qoff, qend) mirrored onto the forward query strand
        (is_qualified_m4, src/trim_bases/largest_cover_range.c:42-50)."""
        rev = self.qdir == 1
        qoff = np.where(rev, self.qsize - self.qend, self.qoff)
        qend = np.where(rev, self.qsize - self.qoff, self.qend)
        return qoff, qend

    def save(self, path: str | os.PathLike) -> None:
        """Write .m4 text (gzip if path ends with .gz)."""
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "wt") as f:
            for i in range(len(self)):
                f.write(f"{self.qid[i]}\t{self.sid[i]}\t{self.ident[i]:.2f}\t"
                        f"{self.vscore[i]}\t{self.qdir[i]}\t{self.qoff[i]}\t{self.qend[i]}\t"
                        f"{self.qsize[i]}\t{self.sdir[i]}\t{self.soff[i]}\t{self.send[i]}\t"
                        f"{self.ssize[i]}\n")

    @classmethod
    def load(cls, path: str | os.PathLike) -> "M4Records":
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            rows = [line.split() for line in f if line.strip()]
        if not rows:
            return cls.empty()
        arr = np.array(rows)
        return cls(
            qid=arr[:, 0].astype(np.int32), sid=arr[:, 1].astype(np.int32),
            ident=arr[:, 2].astype(np.float32), vscore=arr[:, 3].astype(np.float32).astype(np.int32),
            qdir=arr[:, 4].astype(np.int8), qoff=arr[:, 5].astype(np.int32),
            qend=arr[:, 6].astype(np.int32), qsize=arr[:, 7].astype(np.int32),
            sdir=arr[:, 8].astype(np.int8), soff=arr[:, 9].astype(np.int32),
            send=arr[:, 10].astype(np.int32), ssize=arr[:, 11].astype(np.int32),
        )
