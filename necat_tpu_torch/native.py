"""The native host library: FASTA/FASTQ(.gz) parsing and the k-mer index's
radix sort, C++ loaded with ctypes (the port's copy of necat_tpu/native).

csrc/seqio_native.cpp and csrc/kmer_index_native.cpp are compiled with g++
at first use into build/libnecat_native.so at the repository root (a
library newer than both sources is reused), never beside the sources. A
failed build or load raises: there is no pure-Python fallback on the path.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import List, Tuple

import numpy as np

from necat_tpu_torch.utils.build import BUILD_DIR, CSRC

SOURCES = (CSRC / "seqio_native.cpp", CSRC / "kmer_index_native.cpp")
LIBRARY = BUILD_DIR / "libnecat_native.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_P = ctypes.POINTER


def build_library():
    """Compile the native sources unless a library newer than both exists."""
    newest = max(s.stat().st_mtime for s in SOURCES)
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= newest:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, *map(str, SOURCES), "-lz", "-lpthread", "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building {LIBRARY}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The native library, built on first call and loaded once per process."""
    lib = ctypes.CDLL(str(build_library()))
    lib.nt_parse_seq_file.restype = ctypes.c_int
    lib.nt_parse_seq_file.argtypes = [
        ctypes.c_char_p, _P(_P(ctypes.c_uint8)), _P(ctypes.c_int64),
        _P(_P(ctypes.c_int64)), _P(ctypes.c_int64), _P(ctypes.c_char_p),
        _P(ctypes.c_int64)]
    lib.nt_free.restype = None
    lib.nt_free.argtypes = [ctypes.c_void_p]
    lib.ntk_build_kmer_index.restype = ctypes.c_int
    lib.ntk_build_kmer_index.argtypes = [
        _P(ctypes.c_uint8), ctypes.c_int64, _P(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P(_P(ctypes.c_int32)),
        _P(_P(ctypes.c_int32)), _P(ctypes.c_int64), _P(_P(ctypes.c_int64))]
    lib.ntk_free.restype = None
    lib.ntk_free.argtypes = [ctypes.c_void_p]
    return lib


def read_seq_file(path) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Parse a FASTA/FASTQ(.gz) file: (names, bases u8, offsets i64)."""
    lib = load()
    bases_p = _P(ctypes.c_uint8)()
    total = ctypes.c_int64()
    offs_p = _P(ctypes.c_int64)()
    n_reads = ctypes.c_int64()
    names_p = ctypes.c_char_p()
    names_len = ctypes.c_int64()
    rc = lib.nt_parse_seq_file(os.fspath(path).encode(), ctypes.byref(bases_p),
                               ctypes.byref(total), ctypes.byref(offs_p),
                               ctypes.byref(n_reads), ctypes.byref(names_p),
                               ctypes.byref(names_len))
    if rc != 0:
        raise OSError(f"{path}: native parser failed ({rc})")
    try:
        n = int(n_reads.value)
        t = int(total.value)
        bases = np.ctypeslib.as_array(bases_p, shape=(max(t, 1),))[:t].copy()
        offsets = np.ctypeslib.as_array(offs_p, shape=(n + 1,)).copy()
        blob = ctypes.string_at(names_p, int(names_len.value)).decode()
        names = blob.split("\n") if blob else ([""] * n if n else [])
    finally:
        for ptr in (bases_p, offs_p, names_p):
            lib.nt_free(ctypes.cast(ptr, ctypes.c_void_p))
    return names, bases, offsets


def build_kmer_index(bases: np.ndarray, offsets: np.ndarray, k: int,
                     n_bucket_bits: int, n_threads: int = 0):
    """Sorted (hashes i32, positions i32, bucket_starts i64) of every k-mer
    that does not span a read boundary: a multithreaded LSD radix sort."""
    lib = load()
    bases = np.ascontiguousarray(bases, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    oh = _P(ctypes.c_int32)()
    op = _P(ctypes.c_int32)()
    n = ctypes.c_int64()
    bs = _P(ctypes.c_int64)()
    rc = lib.ntk_build_kmer_index(
        bases.ctypes.data_as(_P(ctypes.c_uint8)), len(bases),
        offsets.ctypes.data_as(_P(ctypes.c_int64)), len(offsets) - 1, k,
        n_bucket_bits, n_threads, ctypes.byref(oh), ctypes.byref(op),
        ctypes.byref(n), ctypes.byref(bs))
    if rc != 0:
        raise RuntimeError(f"native k-mer index build failed ({rc})")
    try:
        m = int(n.value)
        hashes = np.ctypeslib.as_array(oh, shape=(max(m, 1),))[:m].copy()
        positions = np.ctypeslib.as_array(op, shape=(max(m, 1),))[:m].copy()
        bucket_starts = np.ctypeslib.as_array(
            bs, shape=((1 << n_bucket_bits) + 1,)).copy()
    finally:
        for ptr in (oh, op, bs):
            lib.ntk_free(ctypes.cast(ptr, ctypes.c_void_p))
    return hashes, positions, bucket_starts
