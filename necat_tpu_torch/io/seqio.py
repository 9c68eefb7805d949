"""FASTA/FASTQ reading and writing (plain or gzip), NumPy-fast (the port's
copy of necat_tpu/io/seqio.py).

Replaces the reference's kseq-based ingest (reference: src/klib/kseq.h,
src/common/packed_db.c:228-253 pdb_add_one_seq). Bases are encoded A=0 C=1 G=2 T=3;
every other character (N, ambiguity codes) becomes 0, matching the reference's
2-bit packing where nst_nt4 code 4 truncates to 0 (src/common/nst_nt4_table.h,
src/common/ontcns_aux.h:118 _set_pac).
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np

# ASCII -> 2-bit encoding table. Non-ACGT maps to 0 (see module docstring).
ENCODE_TABLE = np.zeros(256, dtype=np.uint8)
for _c, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("a", 0), ("c", 1), ("g", 2), ("t", 3)):
    ENCODE_TABLE[ord(_c)] = _v

DECODE_TABLE = np.frombuffer(b"ACGT-", dtype=np.uint8)  # code 4 = gap


def encode_seq(s: bytes | str) -> np.ndarray:
    """Encode an ASCII sequence to uint8 codes 0..3."""
    if isinstance(s, str):
        s = s.encode()
    raw = np.frombuffer(s, dtype=np.uint8)
    return ENCODE_TABLE[raw]


def decode_seq(codes: np.ndarray) -> str:
    """Decode uint8 codes 0..4 back to an ACGT- string."""
    return DECODE_TABLE[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def _open_maybe_gz(path: str | os.PathLike, mode: str = "rb"):
    path = os.fspath(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _detect_format(first_byte: int) -> str:
    if first_byte == ord(">"):
        return "fasta"
    if first_byte == ord("@"):
        return "fastq"
    raise ValueError(f"unrecognized sequence file (first byte {first_byte!r})")


def iter_seqs(path: str | os.PathLike) -> Iterator[Tuple[str, bytes]]:
    """Yield (name, raw_sequence_bytes) from a FASTA/FASTQ file, plain or .gz."""
    with _open_maybe_gz(path) as f:
        data = f.read()
    if not data:
        return
    fmt = _detect_format(data[0])
    if fmt == "fasta":
        # Split on records; drop leading empty chunk.
        for rec in data.split(b"\n>"):
            rec = rec.lstrip(b">").strip()
            if not rec:
                continue
            nl = rec.find(b"\n")
            if nl < 0:
                continue
            hdr = rec[:nl].split()[0].decode() if rec[:nl].split() else ""
            seq = rec[nl + 1:].replace(b"\n", b"").replace(b"\r", b"")
            yield hdr, seq
    else:
        lines = data.split(b"\n")
        i = 0
        n = len(lines)
        while i + 1 < n:
            hdr_line = lines[i].strip()
            if not hdr_line:
                i += 1
                continue
            if not hdr_line.startswith(b"@"):
                raise ValueError(f"malformed FASTQ at line {i + 1}")
            name = hdr_line[1:].split()[0].decode() if hdr_line[1:].split() else ""
            seq = lines[i + 1].strip()
            # lines[i+2] = '+', lines[i+3] = qualities (ignored)
            yield name, bytes(seq)
            i += 4


def read_fasta(path: str | os.PathLike) -> Tuple[List[str], List[np.ndarray]]:
    """Read FASTA/FASTQ(.gz) into (names, list of uint8 code arrays)."""
    names: List[str] = []
    seqs: List[np.ndarray] = []
    for name, raw in iter_seqs(path):
        names.append(name)
        seqs.append(encode_seq(raw))
    return names, seqs


def write_fasta(
    path: str | os.PathLike,
    names: Sequence[str],
    seqs: Sequence[np.ndarray],
    width: int = 0,
) -> None:
    """Write encoded sequences as FASTA (gzip if path ends with .gz).

    ``width=0`` writes each sequence on a single line (matches the reference's
    outputs, e.g. reorder_cns_reads/main.c emission).
    """
    buf = io.BytesIO()
    for name, codes in zip(names, seqs):
        buf.write(b">")
        buf.write(str(name).encode())
        buf.write(b"\n")
        line = DECODE_TABLE[np.asarray(codes, dtype=np.uint8)].tobytes()
        if width and width > 0:
            for i in range(0, len(line), width):
                buf.write(line[i:i + width])
                buf.write(b"\n")
        else:
            buf.write(line)
            buf.write(b"\n")
    data = buf.getvalue()
    with _open_maybe_gz(path, "wb") as f:
        f.write(data)


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a 2-bit encoded sequence (3 - code reverses A<->T, C<->G)."""
    return (3 - codes[::-1]).astype(np.uint8)
