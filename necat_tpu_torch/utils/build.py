"""Build and load the port's CUDA kernels.

The sources under ``necat_tpu_torch/csrc/`` (the banded alignment kernels and
the tag scatter) are compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, at first
use, into ``build/`` at the repository root, and loaded with ``ctypes``. A
library newer than every source is reused. Nothing is built when a module is
imported: the CPU tests import every module on machines without ``nvcc``.

Every wrapper of a kernel in the library dispatches with ``on_cpu``, checks
its inputs with ``check`` and launches with ``launch``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import torch

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
    "necat_tag_scatter": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P,
                          _P, _I, _I, _I, _P],
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


def on_cpu(*tensors) -> bool:
    """True for CPU tensors (plain version), False for CUDA tensors (kernel);
    raises on mixed or other devices."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def check(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless `t` has this dtype and shape and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(fn: str, device, *args) -> None:
    """Launch the library's `fn` on `device`'s current stream; raise on a
    launch error."""
    lib = load_kernels()
    with torch.cuda.device(device):
        rc = getattr(lib, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}")
