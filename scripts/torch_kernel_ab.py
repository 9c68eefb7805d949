#!/usr/bin/env python
"""Same-call A/B of necat_tpu_torch's banded kernels on one NVIDIA GPU.

    python scripts/torch_kernel_ab.py [--old DIR] [--same TAG=DIR ...]
                                      [--widths 128 512 ...] [--reps 10]
                                      [--out FILE]

--old DIR holds another checkout's necat_tpu_torch/csrc whose K1 reads the
ENC buffer its K2 writes (necat_banded_forward(enc, la, lb, dirs, cost, PB,
MC, W, stream), as the first versions of K1 did). This checkout's K1 takes
the query and target rows, and so does each --same checkout (another
version of these entry points: the parent commit unpacked with `git
archive`, or a copy of this checkout with other tiling constants). Every
library is compiled with nvcc into build/ab/, all at once.

At each width: L = 8192, PB = pairs_per_chunk(8192, W), the pairs of
chip_smoke.check_kernels (seed 2024). Every library's outputs (K2's ENC, K1's
dirs and cost, K3's cols, insb and lead; K1a's dirs, offs, S_fin and cost,
K3a's cols, insb and lead at 1 and 3 insb words) must be identical to the
first library's (--old, else the first --same; an --old library is held to
K2, K1 and K3 only); then each library's kernels are timed with CUDA events,
`reps` launches each, in turns first, the others (this checkout last), the
others again, first: for example parent, new, new, parent. Prints one JSON
line per width (with each library's K1a/K1 and K3a/K3 time ratios) and, with
--out, writes them all to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from chip_smoke import kernel_pairs  # noqa: E402
from necat_tpu_torch.utils.build import SIGNATURES, NVCC_FLAGS, nvcc_path  # noqa: E402

OUT_DIR = os.path.join(REPO, "build", "ab")
# the old K1 read ENC: necat_banded_forward(enc, la, lb, dirs, cost, PB, MC, W, stream)
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIGNATURES = dict(SIGNATURES, necat_banded_forward=[_P, _P, _P, _P, _P, _I, _I, _I, _P])


def build_all(specs):
    """specs: name -> csrc dir. Compile all in parallel."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, csrc in specs.items():
        srcs = sorted(os.path.join(csrc, f) for f in os.listdir(csrc) if f.endswith(".cu"))
        out = os.path.join(OUT_DIR, f"{name}.so")
        procs[name] = (out, subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", out, *srcs],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"built {name}: " + " | ".join(regs), flush=True)
        lib = ctypes.CDLL(out)
        for fn, argtypes in (OLD_SIGNATURES if name == "old" else SIGNATURES).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs



def kernels(name, lib, a, b, la, lb, W):
    """Closures launching each kernel of library `name`; outputs allocated once."""
    PB, L = a.shape
    dev = a.device
    st = lambda: torch.cuda.current_stream(dev).cuda_stream
    enc = torch.empty((PB, L, W), dtype=torch.uint8, device=dev)
    dirs = torch.empty((PB, L, W), dtype=torch.uint8, device=dev)
    cost = torch.empty(PB, dtype=torch.int32, device=dev)
    cols = torch.empty((PB, L), dtype=torch.int32, device=dev)
    insb = torch.empty((1, PB, L), dtype=torch.int32, device=dev)
    lead = torch.empty(PB, dtype=torch.int32, device=dev)

    def check(rc, fn):
        if rc != 0:
            raise RuntimeError(f"{name} {fn}: CUDA error {rc}")

    def k2():
        check(lib.necat_diag_sub_matrix(a.data_ptr(), L, b.data_ptr(), L, la.data_ptr(),
                                        lb.data_ptr(), enc.data_ptr(), PB, L, W, st()), "K2")

    def k1():
        if name == "old":
            rc = lib.necat_banded_forward(enc.data_ptr(), la.data_ptr(), lb.data_ptr(),
                                          dirs.data_ptr(), cost.data_ptr(), PB, L, W, st())
        else:
            rc = lib.necat_banded_forward(a.data_ptr(), L, b.data_ptr(), L, la.data_ptr(),
                                          lb.data_ptr(), dirs.data_ptr(), cost.data_ptr(),
                                          PB, L, W, st())
        check(rc, "K1")

    def k3():
        check(lib.necat_banded_backtrack(dirs.data_ptr(), la.data_ptr(), lb.data_ptr(),
                                         cols.data_ptr(), insb.data_ptr(), lead.data_ptr(),
                                         PB, L, W, 1, st()), "K3")

    def k2k1():
        k2()
        k1()

    fns = {"K2": k2, "K1": k2k1 if name == "old" else k1, "K3": k3}
    outs = dict(enc=enc, dirs=dirs, cost=cost, cols=cols, insb=insb, lead=lead)
    if name == "old":
        fns["K1_alone"] = k1
        return fns, outs
    # the adaptive band: K1a, then K3a at 1 and 3 insb words on its dirs and offs
    adirs = torch.empty((PB, L, W), dtype=torch.uint8, device=dev)
    offs = torch.empty((PB, L + 1), dtype=torch.int32, device=dev)
    sfin = torch.empty((PB, W), dtype=torch.int32, device=dev)
    acost = torch.empty(PB, dtype=torch.int32, device=dev)
    outs.update(k1a_dirs=adirs, k1a_offs=offs, k1a_sfin=sfin, k1a_cost=acost)

    def k1a():
        check(lib.necat_banded_forward_adaptive(
            a.data_ptr(), L, b.data_ptr(), L, la.data_ptr(), lb.data_ptr(), adirs.data_ptr(),
            offs.data_ptr(), sfin.data_ptr(), acost.data_ptr(), PB, L, W, st()), "K1a")

    def k3a(words):
        acols = torch.empty((PB, L), dtype=torch.int32, device=dev)
        ainsb = torch.empty((words, PB, L), dtype=torch.int32, device=dev)
        alead = torch.empty(PB, dtype=torch.int32, device=dev)
        outs.update({f"k3a{words}_cols": acols, f"k3a{words}_insb": ainsb,
                     f"k3a{words}_lead": alead})

        def run():
            check(lib.necat_adaptive_backtrack(
                adirs.data_ptr(), offs.data_ptr(), a.data_ptr(), L, b.data_ptr(), L,
                la.data_ptr(), lb.data_ptr(), acols.data_ptr(), ainsb.data_ptr(),
                alead.data_ptr(), PB, L, W, words, st()), "K3a")
        return run

    fns.update(K1a=k1a, K3a_1=k3a(1), K3a_3=k3a(3))
    return fns, outs


def time_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="checkout whose K1 reads K2's ENC")
    ap.add_argument("--same", action="append", default=[],
                    help="TAG=DIR: a checkout with this checkout's entry points")
    ap.add_argument("--widths", type=int, nargs="+", default=[128, 512, 1024, 2048, 4096])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", help="write the rows to this JSON file too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    if not args.old and not args.same:
        ap.error("give --old or --same: the checkout to compare with")
    specs = {"old": args.old} if args.old else {}
    for tag_dir in args.same:
        tag, d = tag_dir.split("=", 1)
        specs[tag] = d
    specs["new"] = REPO
    libs = build_all({k: os.path.join(d, "necat_tpu_torch", "csrc") for k, d in specs.items()})
    first = next(iter(libs))
    rows = []
    for W in args.widths:
        a, b, la, lb = kernel_pairs(dev, W)
        sets = {name: kernels(name, lib, a, b, la, lb, W) for name, lib in libs.items()}
        for fns, _ in sets.values():              # one run each (K1a before K3a), then compare
            for k in ("K2", "K1", "K3", "K1a", "K3a_1", "K3a_3"):
                if k in fns:
                    fns[k]()
        torch.cuda.synchronize()
        ref = sets[first][1]
        for name, (_, outs) in sets.items():
            for what, x in outs.items():
                y = ref.get(what, x) if first == "old" else ref[what]
                if not torch.equal(x, y):
                    raise AssertionError(f"W={W}: {name}'s {what} differs from {first}'s")
        order = [first] + [n for n in sets if n != first] * 2 + [first]
        ms = {}
        for name in order:
            for k, fn in sets[name][0].items():
                ms.setdefault(f"{name}:{k}", []).append(time_ms(fn, args.reps))
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        ratios = {f"{name}:{x}/{y}": mean[f"{name}:{x}"] / mean[f"{name}:{y}"]
                  for name in sets for x, y in (("K1a", "K1"), ("K3a_1", "K3"))
                  if f"{name}:{x}" in mean}
        row = {"W": W, "PB": int(a.shape[0]), "L": 8192, "card": smi, "identical": True,
               "ms": {k: v for k, v in ms.items()}, "ratios": ratios}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del sets
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
