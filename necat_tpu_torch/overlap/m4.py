"""M4 overlap records (SoA), the inter-stage overlap format (the port's copy
of necat_tpu/overlap/m4.py).

Mirrors M4Record (src/common/m4_record.h:10-25): qid, sid, ident_perc, vscore,
qdir/qoff/qend/qsize, sdir/soff/send/ssize. Convention: subject dir is always
FWD (sdir=0); query coords are on the qdir strand. The text formats are the
reference's: .m4 (ids), .m4a (read names), FALCON .ovl and minimap2 PAF.
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

    def save(self, path: str | os.PathLike, names=None) -> None:
        """Write by extension: .m4[.gz] (ids), .m4a[.gz] (read names,
        OverlapStore::ToM4aLine overlap_store.cpp:297-307 — needs `names`),
        .paf[.gz] (minimap2 PAF)."""
        base = str(path)[:-3] if str(path).endswith(".gz") else str(path)
        if base.endswith(".m4a"):
            return self.save_m4a(path, names)
        if base.endswith(".paf"):
            return self.save_paf(path, names)
        if base.endswith(".ovl"):
            return self.save_ovl(path)
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "wt") as f:
            for i in range(len(self)):
                f.write(f"{self.qid[i]}\t{self.sid[i]}\t{self.ident[i]:.2f}\t"
                        f"{self.vscore[i]}\t{self.qdir[i]}\t{self.qoff[i]}\t{self.qend[i]}\t"
                        f"{self.qsize[i]}\t{self.sdir[i]}\t{self.soff[i]}\t{self.send[i]}\t"
                        f"{self.ssize[i]}\n")

    def save_m4a(self, path: str | os.PathLike, names) -> None:
        """M4 with read names in the id columns (ToM4aLine)."""
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "wt") as f:
            for i in range(len(self)):
                f.write(f"{names[self.qid[i]]} {names[self.sid[i]]} "
                        f"{self.ident[i]:.2f} {self.vscore[i]} "
                        f"{self.qdir[i]} {self.qoff[i]} {self.qend[i]} {self.qsize[i]} "
                        f"{self.sdir[i]} {self.soff[i]} {self.send[i]} {self.ssize[i]}\n")

    @classmethod
    def load_m4a(cls, path: str | os.PathLike, name2id=None):
        """Load an m4a file (M4 with read NAMES in the id columns — the
        reference's bridge-stage interchange format, necat.pl:1293
        rawread2ctg.m4a.gz; OverlapStore::FromM4aLine overlap_store.cpp:95).

        With `name2id` (dict name -> integer id), returns M4Records in that id
        space. Without it, ids are assigned in first-seen order and the
        return is (M4Records, names list)."""
        opener = gzip.open if str(path).endswith(".gz") else open
        auto = name2id is None
        ids: dict = {} if auto else name2id
        names: list = []
        rows = []
        with opener(path, "rt") as f:
            for line in f:
                t = line.split()
                if len(t) < 12:
                    continue
                qn, sn = t[0], t[1]
                if auto:
                    for n in (qn, sn):
                        if n not in ids:
                            ids[n] = len(names)
                            names.append(n)
                rows.append((ids[qn], ids[sn], float(t[2]), int(float(t[3])),
                             int(t[4]), int(t[5]), int(t[6]), int(t[7]),
                             int(t[8]), int(t[9]), int(t[10]), int(t[11])))
        if rows:
            arr = np.array(rows, dtype=np.float64)
            m = cls(
                qid=arr[:, 0].astype(np.int32), sid=arr[:, 1].astype(np.int32),
                ident=arr[:, 2].astype(np.float32),
                vscore=arr[:, 3].astype(np.int32),
                qdir=arr[:, 4].astype(np.int8), qoff=arr[:, 5].astype(np.int32),
                qend=arr[:, 6].astype(np.int32), qsize=arr[:, 7].astype(np.int32),
                sdir=arr[:, 8].astype(np.int8), soff=arr[:, 9].astype(np.int32),
                send=arr[:, 10].astype(np.int32),
                ssize=arr[:, 11].astype(np.int32))
        else:
            m = cls.empty()
        return (m, names) if auto else m

    def save_ovl(self, path: str | os.PathLike) -> None:
        """Write FALCON OVL lines (inverse of load_ovl; OverlapStore::ToOvlLine
        role, src/fsa/overlap_store.cpp): aid bid score ident astrand astart
        aend alen bstrand bstart bend blen."""
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "wt") as f:
            for i in range(len(self)):
                f.write(f"{self.qid[i]} {self.sid[i]} {self.vscore[i]} "
                        f"{self.ident[i]:.2f} {self.qdir[i]} {self.qoff[i]} "
                        f"{self.qend[i]} {self.qsize[i]} {self.sdir[i]} "
                        f"{self.soff[i]} {self.send[i]} {self.ssize[i]}\n")

    def save_paf(self, path: str | os.PathLike, names=None) -> None:
        """minimap2 PAF (the interop format OverlapStore reads/writes,
        overlap_store.cpp FromPafLine): coordinates on the forward strand of
        the query, strand column +/-, matches approximated from identity."""
        opener = gzip.open if str(path).endswith(".gz") else open
        qoff_f, qend_f = self.fwd_query_range()
        with opener(path, "wt") as f:
            for i in range(len(self)):
                qn = names[self.qid[i]] if names is not None else str(self.qid[i])
                sn = names[self.sid[i]] if names is not None else str(self.sid[i])
                alen = int(max(qend_f[i] - qoff_f[i], self.send[i] - self.soff[i]))
                nmatch = int(alen * float(self.ident[i]) / 100.0)
                strand = "-" if (self.qdir[i] != self.sdir[i]) else "+"
                f.write(f"{qn}\t{self.qsize[i]}\t{qoff_f[i]}\t{qend_f[i]}\t{strand}\t"
                        f"{sn}\t{self.ssize[i]}\t{self.soff[i]}\t{self.send[i]}\t"
                        f"{nmatch}\t{alen}\t60\n")

    @classmethod
    def load_paf(cls, path: str | os.PathLike, name2id=None) -> "M4Records":
        """Load minimap2 PAF overlaps (OverlapStore FromPafLine parity,
        src/fsa/overlap_store.hpp:131-134). Query coords are converted to the
        qdir-strand convention; identity is nmatch/alen."""
        opener = gzip.open if str(path).endswith(".gz") else open
        rows = []
        with opener(path, "rt") as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                if len(t) < 12:
                    continue
                qn, qlen, qs, qe, strand, sn, slen, ss, se, nm, alen = (
                    t[0], int(t[1]), int(t[2]), int(t[3]), t[4], t[5],
                    int(t[6]), int(t[7]), int(t[8]), int(t[9]), int(t[10]))
                qid = name2id[qn] if name2id else int(qn)
                sid = name2id[sn] if name2id else int(sn)
                qdir = 1 if strand == "-" else 0
                if qdir == 1:
                    qs, qe = qlen - qe, qlen - qs
                ident = 100.0 * nm / max(alen, 1)
                rows.append((qid, sid, ident, nm, qdir, qs, qe, qlen,
                             0, ss, se, slen))
        if not rows:
            return cls.empty()
        arr = np.array(rows, dtype=np.float64)
        return cls(
            qid=arr[:, 0].astype(np.int32), sid=arr[:, 1].astype(np.int32),
            ident=arr[:, 2].astype(np.float32), vscore=arr[:, 3].astype(np.int32),
            qdir=arr[:, 4].astype(np.int8), qoff=arr[:, 5].astype(np.int32),
            qend=arr[:, 6].astype(np.int32), qsize=arr[:, 7].astype(np.int32),
            sdir=arr[:, 8].astype(np.int8), soff=arr[:, 9].astype(np.int32),
            send=arr[:, 10].astype(np.int32), ssize=arr[:, 11].astype(np.int32))

    @classmethod
    def load_ovl(cls, path: str | os.PathLike) -> "M4Records":
        """Load FALCON OVL overlaps (OverlapStore::FromOvlLine parity,
        src/fsa/overlap_store.cpp:126-155: aid bid score ident astrand astart
        aend alen bstrand bstart bend blen ...). Read-only, like the reference."""
        opener = gzip.open if str(path).endswith(".gz") else open
        rows = []
        with opener(path, "rt") as f:
            for line in f:
                t = line.split()
                if len(t) < 12:
                    continue
                rows.append((int(t[0]), int(t[1]), float(t[3]), int(t[2]),
                             int(t[4]), int(t[5]), int(t[6]), int(t[7]),
                             int(t[8]), int(t[9]), int(t[10]), int(t[11])))
        if not rows:
            return cls.empty()
        arr = np.array(rows, dtype=np.float64)
        m = cls(
            qid=arr[:, 0].astype(np.int32), sid=arr[:, 1].astype(np.int32),
            ident=arr[:, 2].astype(np.float32), vscore=arr[:, 3].astype(np.int32),
            qdir=arr[:, 4].astype(np.int8), qoff=arr[:, 5].astype(np.int32),
            qend=arr[:, 6].astype(np.int32), qsize=arr[:, 7].astype(np.int32),
            sdir=arr[:, 8].astype(np.int8), soff=arr[:, 9].astype(np.int32),
            send=arr[:, 10].astype(np.int32), ssize=arr[:, 11].astype(np.int32))
        # normalize to the sdir=0 convention (mirror both strands when b is rev)
        rev = m.sdir == 1
        if rev.any():
            qoff = np.where(rev, m.qsize - m.qend, m.qoff)
            qend = np.where(rev, m.qsize - m.qoff, m.qend)
            soff = np.where(rev, m.ssize - m.send, m.soff)
            send = np.where(rev, m.ssize - m.soff, m.send)
            m.qdir = np.where(rev, 1 - m.qdir, m.qdir).astype(np.int8)
            m.qoff, m.qend, m.soff, m.send = qoff, qend, soff, send
            m.sdir = np.zeros_like(m.sdir)
        return m

    @classmethod
    def load_any(cls, path: str | os.PathLike, name2id=None) -> "M4Records":
        """Extension-dispatching loader (OverlapStore::DetectFileType,
        src/fsa/overlap_store.cpp:35-56): .m4[.gz], .m4a[.gz], .paf[.gz],
        .ovl[.gz]. For .m4a without name2id, names are dropped (ids assigned
        first-seen; use load_m4a directly to keep them)."""
        p = str(path)
        base = p[:-3] if p.endswith(".gz") else p
        if base.endswith(".m4a"):
            r = cls.load_m4a(path, name2id)
            return r[0] if isinstance(r, tuple) else r
        if base.endswith(".paf"):
            return cls.load_paf(path, name2id)
        if base.endswith(".ovl"):
            return cls.load_ovl(path)
        return cls.load(path)

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
