#!/usr/bin/env python
"""Same-call A/B of necat_tpu_torch's main path and correct stage on one
NVIDIA GPU: this checkout against another (--old, for example the parent
commit unpacked with `git archive`), each run in its own process, in turns
old, new, new, old.

    python scripts/torch_main_ab.py --old DIR [--out FILE]

One run (`--one DIR`) uses DIR's own package: the bench read set
(gen_benchmark_reads(200_000, 20, seed=7)) through find_all_candidates ->
swap_roles -> correct_reads on "cuda" with default options: a first pass
(builds, caches), a timed pass (wall with synchronisation, peak device
memory after reset_peak_memory_stats) and a pass under torch.profiler (device
time of every CUDA kernel, summed by name; the device busy share is their sum
over the profiled wall). Then the command line's `correct` (NUM_ITER=2, the
config template's options) on the same reads, with the per-iteration seconds
of its manifest. Prints one JSON line per run; with --out the A/B writes
them all to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("banded_forward_kernel", "banded_backtrack_kernel", "diag_sub_matrix_kernel")


def one(checkout: str) -> dict:
    sys.path.insert(0, checkout)
    import torch
    from necat_tpu_torch.consensus import options as cns
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.overlap import options as ovl
    from necat_tpu_torch.overlap.candidates import Candidates
    from necat_tpu_torch.overlap.overlapper import find_all_candidates
    from necat_tpu_torch.pipeline import cli, config
    from necat_tpu_torch.utils import benchdata
    assert os.path.dirname(cli.__file__) == os.path.join(checkout, "necat_tpu_torch", "pipeline")
    dev = torch.device("cuda", 0)
    _, store, _ = benchdata.gen_benchmark_reads(genome_size=200_000, coverage=20, seed=7)

    def run():
        c = find_all_candidates(store, store, ovl.MapOptions(), pairwise=True, device=dev)
        recs = correct_reads(store, Candidates.concat([c, c.swap_roles()]), cns.CnsOptions(),
                             device=dev)
        torch.cuda.synchronize()
        return recs

    t0 = time.perf_counter()
    run()
    first = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    recs = run()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_wall = time.perf_counter() - t0
    by_kernel, device_ms = {}, 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if ev.device_type.name != "CUDA" or not us:
            continue
        device_ms += us / 1e3
        for k in KERNELS:
            if k in ev.key:
                by_kernel[k] = by_kernel.get(k, 0.0) + us / 1e3
    work = os.path.join(checkout, "build", "main_ab")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    reads = os.path.join(work, "reads.fasta")
    store.to_fasta(reads)
    with open(os.path.join(work, "read_list.txt"), "w") as f:
        f.write(reads + "\n")
    cfg = os.path.join(work, "run.cfg")
    with open(cfg, "w") as f:
        f.write(config.CONFIG_TEMPLATE.replace("PROJECT=", f"PROJECT={work}/project")
                .replace("ONT_READ_LIST=", f"ONT_READ_LIST={work}/read_list.txt")
                .replace("GENOME_SIZE=", "GENOME_SIZE=200000")
                .replace("MIN_READ_LENGTH=3000", "MIN_READ_LENGTH=1000"))
    t0 = time.perf_counter()
    rc = cli.main(["correct", cfg, "--device", "cuda"])
    torch.cuda.synchronize()
    correct_wall = time.perf_counter() - t0
    with open(os.path.join(work, "project", "1-consensus", "correct.done.json")) as f:
        iters = json.load(f)["iterations"]
    return {"checkout": checkout, "corrected_reads": len({r.tid for r in recs if r.corrected}),
            "first_pass_s": first, "wall_s": wall, "peak_mem_gib": peak,
            "profiled_wall_s": prof_wall, "device_ms": device_ms,
            "device_busy_share": device_ms / 1e3 / prof_wall, "kernel_ms": by_kernel,
            "correct_rc": rc, "correct_wall_s": correct_wall,
            "correct_iterations": [{k: v for k, v in it.items() if k != "pairs_by_band"}
                                   for it in iters]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--old", help="checkout to compare this one with")
    group.add_argument("--one", help="run one checkout in this process")
    ap.add_argument("--out", help="write the rows to this JSON file too")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(os.path.abspath(args.one))), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rows = []
    old = os.path.abspath(args.old)
    for tag, checkout in (("old", old), ("new", REPO), ("new", REPO), ("old", old)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", checkout],
                              capture_output=True, text=True, cwd=checkout)
        if proc.returncode != 0:
            raise RuntimeError(f"{tag} run failed:\n{proc.stderr[-4000:]}")
        row = dict(json.loads(proc.stdout.strip().splitlines()[-1]), tag=tag, card=smi)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
