#!/usr/bin/env python
"""Drive the PyTorch + CUDA port (necat_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run on error:
  1. probe   the toolchain and the card (name and power limit as nvidia-smi
             reports them);
  2. build   the CUDA kernels from necat_tpu_torch/csrc with nvcc (sm_90a);
  3. kernels K2, K1 and K3 against their plain PyTorch versions on the card,
             at a production chunk (W=128, L=8192, PB=pairs_per_chunk(8192)),
             exact equality, each kernel's time beside the plain version's;
  4. slice   find_all_candidates + correct_reads on "cuda" against the same
             on "cpu" (the plain versions) on a small read set: identical
             records;
  5. main    the bench read set (gen_benchmark_reads(200_000, 20, seed=7):
             339 reads, 4.02 Mb) through find_all_candidates -> swap_roles ->
             correct_reads with default options; every kernel must launch,
             and the corrected count and identity must stay within the
             margins of necat_tpu's own run of this set on the CPU.
It prints one JSON line of kernel results, the card line, and last a JSON
status line {"ok": true, "device": {...}}. Without CUDA it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# necat_tpu's own correct_reads on this read set, on the CPU (default
# options): the main path must correct >= 97 % as many reads, at an identity
# no more than 0.5 percentage points lower.
JAX_CPU_REFERENCE = {"corrected_reads": 339, "identity": 99.13}
KERNEL_SOURCE = "necat_tpu_torch/csrc/banded_kernels.cu"
REPLACES = {"diag_sub_matrix": "necat_tpu/align/pallas_banded.py:146",
            "banded_forward": "necat_tpu/align/pallas_banded.py:65",
            "banded_backtrack_cols": "necat_tpu/align/pallas_banded.py:325"}


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def probe() -> str:
    from necat_tpu_torch.utils.build import nvcc_path
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    info = {"python": sys.version.split()[0], "torch": torch.__version__,
            "torch_cuda": torch.version.cuda, "triton": triton_v,
            "nvcc": _run([nvcc_path(), "--version"]).splitlines()[-1],
            "device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count()}
    print("probe " + json.dumps(info), flush=True)
    return smi


def build() -> None:
    from necat_tpu_torch.utils import build as b
    t0 = time.perf_counter()
    b.load_kernels()
    ptxas = [ln.strip() for ln in b.BUILD_LOG.read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln] if b.BUILD_LOG.exists() else []
    print(f"build {time.perf_counter() - t0:.1f} s", *ptxas, sep="\n  ", flush=True)


def _time_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _flat(x) -> list:
    return [t for v in x for t in _flat(v)] if isinstance(x, (tuple, list)) else [x]


def _max_abs_err(x, y) -> float:
    xs, ys = _flat(x), _flat(y)
    if len(xs) != len(ys):
        raise AssertionError(f"{len(xs)} outputs against {len(ys)}")
    err = 0.0
    for u, v in zip(xs, ys):
        if u.shape != v.shape or u.dtype != v.dtype:
            raise AssertionError(f"{u.shape} {u.dtype} against {v.shape} {v.dtype}")
        err = max(err, float((u.long() - v.long()).abs().max()) if u.numel() else 0.0)
    return err


def check_kernels(dev, W: int = 128, L: int = 8192) -> dict:
    """Each kernel against its plain version at one production chunk."""
    from necat_tpu.io import simulate
    from necat_tpu.utils import shapes
    from necat_tpu_torch.align import banded_kernels as bk
    PB = shapes.pairs_per_chunk(L, W)
    rng = np.random.default_rng(2024)
    em = simulate.ErrorModel(sub=0.05, ins=0.05, dele=0.05)
    a = np.zeros((PB, L), np.uint8)
    b = np.zeros((PB, L), np.uint8)
    la = np.zeros(PB, np.int32)
    lb = np.zeros(PB, np.int32)
    for i in range(PB):
        t = rng.integers(0, 4, int(rng.integers(L // 4, L))).astype(np.uint8)
        q = simulate.mutate(t, em, rng)[:L]
        a[i, :len(q)], b[i, :len(t)] = q, t
        la[i], lb[i] = min(len(q), len(t) + W // 4), min(len(t), len(q) + W // 4)
    a, b, la, lb = (torch.from_numpy(x).to(dev) for x in (a, b, la, lb))
    steps = {
        "diag_sub_matrix": (lambda: bk.diag_sub_matrix(a, b, la, lb, W, L),
                            lambda: bk.diag_sub_matrix_ref(a, b, la, lb, W, L)),
    }
    enc = steps["diag_sub_matrix"][0]()
    steps["banded_forward"] = (lambda: bk.banded_forward(enc, la, lb, W),
                               lambda: bk.banded_forward_ref(enc, la, lb, W))
    dirs, _ = steps["banded_forward"][0]()
    steps["banded_backtrack_cols"] = (lambda: bk.banded_backtrack_cols(dirs, la, lb, W, 1),
                                      lambda: bk.banded_backtrack_cols_ref(dirs, la, lb, W, 1))
    results = {}
    for name, (kernel, plain) in steps.items():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        ms = _time_ms(kernel, 5)
        plain_ms = _time_ms(plain, 1)
        results[name] = dict(name=name, route="cuda", source=KERNEL_SOURCE,
                             replaces=REPLACES[name], max_abs_err=err, ms=ms,
                             plain_ms=plain_ms)
        print(f"kernel {name}: PB={PB} L={L} W={W} max_abs_err={err} "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
        if err != 0.0:
            raise AssertionError(f"{name}: kernel and plain version disagree ({err})")
    return results


def _same_records(ra, rb) -> None:
    if len(ra) != len(rb):
        raise AssertionError(f"record counts differ: {len(ra)} vs {len(rb)}")
    for x, y in zip(ra, rb):
        if ((x.tid, x.left, x.right, x.corrected) != (y.tid, y.left, y.right, y.corrected)
                or not np.array_equal(x.seq, y.seq)):
            raise AssertionError(f"records differ at template {x.tid}")


def check_slice(dev) -> None:
    """Small read set: the cuda path equals the cpu path (plain versions)."""
    from necat_tpu.consensus.options import CnsOptions
    from necat_tpu.io import simulate
    from necat_tpu.io.readstore import ReadStore
    from necat_tpu.overlap.options import MapOptions
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.overlap.candidates import Candidates
    from necat_tpu_torch.overlap.overlapper import find_all_candidates
    genome = simulate.random_genome(12000, seed=33)
    reads, *_ = simulate.simulate_reads(genome, coverage=6, mean_len=4000,
                                        min_len=3000, max_len=5500, seed=34)
    rs = ReadStore.from_seqs(reads)
    mo = MapOptions(kmer_size=13, max_hits=1 << 18, max_pairs=4096)
    co = CnsOptions(templates_per_batch=4, pairs_per_chunk=32)
    recs = {}
    for d in ("cpu", dev):
        t0 = time.perf_counter()
        c = find_all_candidates(rs, rs, mo, pairwise=True, device=d)
        recs[str(d)] = correct_reads(rs, Candidates.concat([c, c.swap_roles()]), co,
                                     device=d)
        print(f"slice on {d}: {len(recs[str(d)])} records, "
              f"{sum(r.corrected for r in recs[str(d)])} corrected, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    _same_records(recs["cpu"], recs[str(dev)])
    print("slice: cuda and cpu records identical", flush=True)


def accuracy_sample(recs, reads, genome, st, sd, ln, n_sample=24):
    """Mean identity to the true genome interval of the first n_sample
    corrected pieces of >= 2 kb (bench.py:accuracy_sample)."""
    from necat_tpu.io import simulate
    idents = []
    for r in recs:
        if not r.corrected or len(idents) >= n_sample:
            continue
        i = r.tid
        frac_l, frac_r = r.left / len(reads[i]), r.right / len(reads[i])
        s0, L0 = int(st[i]), int(ln[i])
        if sd[i] == 0:
            a, b = s0 + int(frac_l * L0), s0 + int(frac_r * L0)
        else:
            a, b = s0 + int((1 - frac_r) * L0), s0 + int((1 - frac_l) * L0)
        if b - a < 2000:
            continue
        seq = r.seq if sd[i] == 0 else (3 - r.seq[::-1]).astype(np.uint8)
        idents.append(simulate.identity_to_genome(seq, genome, a, 0, b - a))
    return round(float(np.mean(idents)), 2) if idents else None


def main_path(dev, kernels: dict) -> None:
    from necat_tpu.consensus.options import CnsOptions
    from necat_tpu.overlap.options import MapOptions
    from necat_tpu.utils.benchdata import gen_benchmark_reads
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.overlap.candidates import Candidates
    from necat_tpu_torch.overlap.overlapper import find_all_candidates
    genome, store, (st, sd, ln) = gen_benchmark_reads(genome_size=200_000,
                                                      coverage=20, seed=7)
    for k in bk.launches:
        bk.launches[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cands = find_all_candidates(store, store, MapOptions(), pairwise=True, device=dev)
    call = Candidates.concat([cands, cands.swap_roles()])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    recs = correct_reads(store, call, CnsOptions(), device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(bk.launches)
    for k, n in launches.items():
        kernels[k]["launches"] = n
    ncorr = len({r.tid for r in recs if r.corrected})
    reads = [store.get(i) for i in range(store.n_reads)]
    ident = accuracy_sample(recs, reads, genome, st, sd, ln)
    print("main " + json.dumps({
        "reads": store.n_reads, "bases": int(store.total_bases),
        "candidates": len(cands), "records": len(recs), "corrected_reads": ncorr,
        "identity_pct": ident, "candidates_s": round(t1 - t0, 3),
        "correct_s": round(t2 - t1, 3), "wall_s": round(t2 - t0, 3),
        "corrected_reads_per_s": round(ncorr / (t2 - t0), 3),
        "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
        "launches": launches}), flush=True)
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    for r in recs:
        if r.seq.dtype != np.uint8 or (len(r.seq) and r.seq.max() > 3):
            raise AssertionError(f"record of template {r.tid} holds non-base codes")
    ref = JAX_CPU_REFERENCE
    if ncorr < 0.97 * ref["corrected_reads"]:
        raise AssertionError(f"corrected {ncorr} < 97 % of {ref['corrected_reads']}")
    if ident is None or ident < ref["identity"] - 0.5:
        raise AssertionError(f"identity {ident} < {ref['identity']} - 0.5")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = probe()
    build()
    kernels = check_kernels(dev)
    check_slice(dev)
    main_path(dev, kernels)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
