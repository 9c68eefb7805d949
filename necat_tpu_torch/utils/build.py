"""Build and load the port's CUDA kernels.

The sources under ``necat_tpu_torch/csrc/`` are compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, at first
use, into ``build/`` at the repository root, and loaded with ``ctypes``. A
library newer than every source is reused. Nothing is built when a module is
imported: the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIBRARY = BUILD_DIR / "libnecat_kernels.so"
BUILD_LOG = BUILD_DIR / "libnecat_kernels.log"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # name: argtypes (pointers and the stream as c_void_p, sizes as c_int)
    "necat_diag_sub_matrix": [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P],
    "necat_banded_forward": [_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "necat_banded_backtrack": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "necat_banded_forward_adaptive": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _P],
    "necat_adaptive_backtrack": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_library() -> Path:
    """Compile csrc/*.cu into build/libnecat_kernels.so unless a library newer
    than every source exists. The compiler's output (register and shared
    memory use per kernel) is kept in build/libnecat_kernels.log."""
    sources = sorted(CSRC.glob("*.cu"))
    newest = max(s.stat().st_mtime for s in sources)
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= newest:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
