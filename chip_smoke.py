#!/usr/bin/env python
"""Drive the PyTorch + CUDA port (necat_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run on error:
  1. probe   the toolchain and the card (name and power limit as nvidia-smi
             reports them);
  2. build   the CUDA kernels (nvcc, sm_90a) and the native host library
             (g++) from necat_tpu_torch/csrc, both compilers started
             together;
  3. kernels K1 (from the query and target rows), K3 and the standalone K2
             against their plain PyTorch versions on the card, at a
             production chunk (W=128, L=8192, PB=pairs_per_chunk(8192)),
             exact equality, each kernel's time beside the plain version's
             and beside its bound (the least time the card could take:
             the bytes over 3.35 TB/s or the integer operations over
             16.7 Tops/s, whichever is larger, counted on this run's pairs);
  4. slice   find_all_candidates + correct_reads on "cuda" against the same
             on "cpu" (the plain versions) on a small read set: identical
             records;
  5. main    the bench read set (gen_benchmark_reads(200_000, 20, seed=7):
             339 reads, 4.02 Mb) through find_all_candidates -> swap_roles ->
             correct_reads with default options; K1 and K3 must launch and
             K2 must not (K1 computes ENC itself), and the corrected count
             and identity must stay within the margins of necat_tpu's own
             run of this set on the CPU;
  6. rungs   K1, K2 and K3 at every width the rescue ladder reaches from
             W0=128: 512, 1024, 2048 and 4096 (K1 runs a block per pair from
             512, K3 from 1024), L=8192, PB=pairs_per_chunk(8192, W), against their
             plain versions, exact equality, times beside the plain versions';
  7. rescue  planted insertions of 300, 600 and 1000 bp (the rungs 1024,
             2048 and 4096 each carry a pair): extend_candidates and
             correct_reads with rescue_long_indels on "cuda" against "cpu",
             identical M4 and records; K1 and K3 must launch at W=2048 and
             4096;
  8. correct `python -m necat_tpu_torch.pipeline.cli correct <cfg> --device
             cuda` (Project.run_correct; NUM_ITER=2, the config template's
             options: iteration 2 runs the rescue ladder) on the bench read
             set; cns_final must keep >= 97 % of main's corrected reads at an
             identity no more than 0.5 points below main's. Its per-iteration
             seconds and pairs by band come from the stage's manifest;
  9. polish  polish_contigs (band 256, max_delta 22: K3 with three insb
             words, the stream consensus and the host link-DP repair) on a
             20 kb draft missing 300 bases (tests/test_polish.py's collapsed
             repeat) on "cuda" against "cpu": identical polished contigs,
             and the hotspot repair must have returned an override;
 10. assemble `python -m necat_tpu_torch.pipeline.cli assemble <cfg> --device
             cuda` on phase 8's project and config (correct is skipped by its
             manifest; trim, assemble and polish run): K1 and K3 must launch
             at W=128 and 256 and K2 never, a contig must hold >= 50 % of the
             genome, and the polished contigs' identity to the true genome
             (10 kb pieces, each placed by an exact 21-mer) must be no lower
             than JAX_CPU_ASSEMBLY_REFERENCE's - 0.5 and fall below the
             draft's by no more than the reference's own polish loses + 0.5.
             Stage seconds come from the stages' manifests.
 11. bridge  (a) bridge_contigs of tests/test_bridge.py's two-contig case
             on "cuda" against "cpu": identical bridged contigs; (b) the
             bench genome cut into five contigs (gaps, an overlap, one
             reverse-complemented, ids shuffled) bridged with the bench
             set's raw reads on "cuda" (reads mapped at band 256 with its
             ladder 1024-4096, contigs to contigs): K1 and K3 must launch at
             256 and K2 never, and the contigs' count, total length and
             identity must stay within the margins of
             JAX_CPU_BRIDGE_REFERENCE;
 12. bridge-cli `python -m necat_tpu_torch.pipeline.cli bridge <cfg> --device
             cuda` on phase 8's project: correct, trim and assemble are
             skipped by their manifests, bridge passes the one contig
             through and polish runs again; the bridged and polished contigs
             must equal phase 10's;
 13. trim-accurate (a) trim_reads_accurate on 12 of phase 4's reads on "cuda"
             against "cpu": identical trimmed reads, ids and ranges; (b)
             `cli assemble` with TRIM_METHOD=accurate on phase 8's project
             (trim, assemble and polish run again): the trim stage's
             consensus must run K1 and K3 at 128, a contig must hold >= 50 %
             of the genome and the draft's identity must be no more than
             0.5 points below phase 10's.
 14. small-memory correct_reads of phase 5's reads and candidates with
             small_memory=True (each supergroup uploads only the reads it
             touches): records identical to phase 5's; correction seconds
             and peak device memory beside a run without the mode;
 15. volumes (a) candidates_by_volumes of phase 5's reads in 1.5 Mb volumes
             (three, one k-mer index each, timed) equal phase 5's untiled
             candidates field for field; (b) `cli assemble` with
             VOL_SIZE=1500000 and POLISH_CONTIGS=false in a fresh project
             from phase 8's reads and config writes phase 10's cns_final,
             trimReads and contigs (content); K1 and K3 must launch at 128
             and K2 never;
 16. stripes two processes of `cli assemble --device cuda` share the card,
             joined through a coordinator on 127.0.0.1 (gloo), in a fresh
             project: correct and polish striped, trim and assemble on
             process 0; cns_final and polished_contigs.fasta must equal
             phase 10's, and each process's manifest report must show pairs
             extended (K1 and K3 launched). A failed process fails the run.
 17. index  (a) the bench set's k-mer index built on the card
             (KmerIndex.build_on_device from main's packed store, torch.sort)
             equals the native host build array for array; the device
             build's seconds (synchronised) and peak beside the host build's
             (its upload included); (b) main's search through the gate (the
             device build) and with the host-built index give main's
             candidates field for field; (c) a volume of E. coli scale
             (ECOLI_VOLUME: reads of a random 4.6 Mb genome at 40x, 10 %
             substitutions, 184 Mb, below shapes.DEVICE_INDEX_MAX_BASES):
             the device build equals the native one array for array,
             seconds and peak of both;
 18. devices two shards on cuda:0, or one on each card where there are
             several: (a) main's inputs through find_all_candidates and
             correct_reads with the device list (buckets_per_supergroup
             pinned at the list's length) equal main's candidates field for
             field and a one-device run's records in order; (b)
             overlap_all_vs_all of phase 4's read set with the list equals
             its one-device M4 rows; (c) `cli correct --device <list>` in a
             fresh project from phase 8's config writes phase 8's cns_final
             (content); K1 and K3 must launch at 128 and K2 never.
 19. timing main's search and correction again with the host timing scopes
             on (necat_tpu_torch/utils/logging.py, NECAT_TPU_TIMING's
             report): records equal main's; prints the report, the
             synchronised wall, the top-level scopes' sum and share of it
             and the lane counters; then once more with
             NECAT_TPU_SYNC_DISPATCH=1 (each dispatch waits for the card
             in its *exec* scope): records equal again, the *exec* totals
             beside that wall. Every cand.*, ext.* and cns.* scope of the
             fused path must appear; K1 and K3 must launch at 128 and K2
             never.
 20. adaptive K1a and K3a (the adaptive band of NECAT_TPU_NO_PALLAS) against
             their plain versions at every width of KERNEL_WIDTHS (L=8192 at
             128, ADAPTIVE_L at the others; K3a also with 3 insb words at
             256), exact equality, times beside the bounds; then main's
             search and correction with NECAT_TPU_NO_PALLAS set: candidates
             equal main's, K1a and K3a must launch at 128 and no other
             kernel may, and the records are held to the JAX package's own
             default run of this set on the CPU (JAX_CPU_MAIN_REFERENCE,
             scripts/jax_main_reference.py). The "adaptive/static" line
             gives K1a/K1 and K3a/K3 (1 insb word) at W=128 on the same
             kernel_pairs chunk, from the rows of this phase and of phase 3.
 21. adaptive-pipeline with NECAT_TPU_NO_PALLAS set: (a) `cli assemble`
             and then `cli bridge` --device cuda in a fresh project from
             phase 8's config; (b) phase 11b's bridge_contigs on the card;
             (c) phase 7's planted insertions through extend_candidates and
             correct_reads(rescue_long_indels=True) on the card. Each stage
             file (cns_final, trimReads, contigs, polished_contigs after
             assemble, bridged_contigs, polished_contigs after bridge), (b)'s
             contigs and (c)'s M4 and records must equal the JAX package's
             own CPU run by sha256 (JAX_CPU_PIPELINE_REFERENCE,
             JAX_CPU_BRIDGE_DIGEST, JAX_CPU_LADDER_REFERENCE;
             scripts/jax_pipeline_reference.py,
             scripts/jax_bridge_reference.py), but for PIPELINE_TIES
             (template 199's name in cns_final and trimReads, a float32 tie
             of the reference: the rest of each file must equal the
             reference's and the record the documented one), and the contigs' count, N50
             and identity JAX_CPU_ASSEMBLY_REFERENCE's to its printed
             precision; K1a and K3a must launch at 128 and 256 (K3a also
             with 3 insb words) in (a) and (b) and at every rung 512-4096 in
             (c), and K1, K2 and K3 never. K1a and K3a may launch in phases
             20 and 21 only. The shape (PB, L, Lb) of every K1a and K3a call
             is recorded by path, and at each (W, insb words) the phase
             launched, K1a and K3a are held to their plain versions (exact
             equality, times, bounds) on the inputs of its longest call.
 22. legacy  the legacy two-program correction (CnsOptions(fused=False),
             NECAT_TPU_FUSED=0: host acceptance, tags.scatter_pass_cols,
             splice_rescue) against the fused flow, each timed beside a
             fused run of the same inputs: (a) main's inputs, records equal
             main's; (b) main's inputs with rescue_long_indels, records
             equal the fused run's, lanes spliced printed; (c) main's
             inputs with NECAT_TPU_NO_PALLAS, records equal phase 20's, with
             no tie allowance; (d) `cli correct` with NECAT_TPU_FUSED=0 in a
             fresh project from phase 8's config writes phase 8's cns_final
             (sha256 of the content). K1 and K3 must launch at 128 in (a),
             (b) and (d) and K1a and K3a not; in (c) K1a and K3a at 128 and
             no other kernel.
Phases 17-22 run before 16, which empties this process's
allocator for its two processes. Stage retries are off (NECAT_TPU_MAX_STAGE_ERROR=1),
so that none hides a failure. Phase 3 also runs W=256 (K3 with 1 insb word, as the bridge's mapping runs
it, and 3, as polish runs it) and W=64 (so that K2 is held at every width
of KERNEL_WIDTHS), and phase 6 K3 with 3 words at 1024. The launch counts are set to 0 before each path
(main, rescue, correct, polish, assemble, bridge, bridge-cli, trim-accurate,
small-memory, volumes, index, devices, timing, adaptive, adaptive-pipeline,
adaptive-bridge, adaptive-ladder, legacy, legacy-rescue, legacy-adaptive,
legacy-cli) and read after it; phase 16's launches run in other
processes, so they are read from the manifests. It prints one JSON line of kernel results, the card line,
and last a JSON status line {"ok": true, "device": {...}}. Without CUDA it
exits non-zero before printing any result. It imports nothing of necat_tpu.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import json
import os
import shutil
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
# The same run as scripts/jax_main_reference.py makes it (necat_tpu on the
# CPU, no monkeypatch, so its adaptive band; 339 reads at 99.13 % in
# accuracy_sample). Phase 20 runs the port's adaptive band on the card and
# must give these records: the corrected count, and records_digest (tid,
# left, right, corrected, seq) over every template but those of
# MAIN_TIE_FLIPS, exactly (so no identity sample is needed). There the
# reference's float32 tag sums tie a consensus call that the port's exact
# float64 sums do not (template 199, column 5240: A 3.1441555 against a gap
# of 3.14415574, the exact sum rounded once, 3.1441555 when accumulated in
# float32; ROADMAP queue 3), so its record must keep left and right and may
# differ from the reference's seq by one base in length.
MAIN_TIE_FLIPS = (199,)
JAX_CPU_MAIN_REFERENCE = {
    "corrected_reads": 339,
    "digest": "301b22a87005f83e98d372fcbf76cbc705d08088f2cc273b40edc848a6acd789",
    "digest_without_tie_flips":
        "372999c2bb3479406964c523b2469eb71d75b677f248c9dc1b1602ed50ea8c30",
    "tie_flips": {"199": [15, 16329, 16276]}}
KERNEL_SOURCE = "necat_tpu_torch/csrc/banded_kernels.cu"
# necat_tpu's `cli assemble` of the bench read set on the CPU with the config
# of phase 8 (the adaptive band; scripts/jax_pipeline_reference.py):
# identities as contig_identity measures them. Its polish LOWERS identity on
# this set (the hotspot repair; without it the port's polish keeps the
# draft's identity, scripts/torch_polish_diag.py), so phase 10 holds the
# port to this reference: polished identity no more than 0.5 points below
# its polished identity, and no more than 0.5 points more lost to polishing.
JAX_CPU_ASSEMBLY_REFERENCE = {"contigs": 1, "contig_n50": 199982,
                              "draft_identity": 99.953, "polished_identity": 99.862}
# necat_tpu's bridge_contigs of phase 11b's contigs and reads on the CPU
# (the adaptive band; scripts/jax_bridge_reference.py, 130 s wall): phase
# 11b must give as many contigs, a total within 0.5 % of this one, and an
# identity (contig_identity) no more than 0.5 points lower.
JAX_CPU_BRIDGE_REFERENCE = {"contigs": 1, "total": 198778, "identity": 99.758}
# necat_tpu's `cli assemble` and then `cli bridge` of the bench read set on
# the CPU with phase 8's config (its adaptive band; scripts/
# jax_pipeline_reference.py): fasta_digest of each stage file
# (pipeline_paths). Phase 21 runs the port's adaptive band on the card and
# must write these files (or differ only by PIPELINE_TIES, where the digest
# of the rest is given).
JAX_CPU_PIPELINE_REFERENCE = {"files": {
    "cns_final": {
        "sha256": "f58498f651db9d8a2059b1cb0e8702c2849815dbd3b6e7a6041d9d3d0a118c40",
        "records": 339,
        "sha256_without_ties":
            "fd0524befdce9207b208043f915afb4f6a77c5f122d448d1970c5618838376dc"},
    "trimReads": {
        "sha256": "dcd813816e08bbe23b9bf13e0c2d9ff44379687aa2dfb2398a30a4a2638a6b55",
        "records": 339,
        "sha256_without_ties":
            "2265dd84dc8d517a6a4541fb98d77f68db21d43a815c98605fdaadb314ca714f"},
    "contigs": {
        "sha256": "ef9694a1cbf026f8d0672a641f25e5584b2146137421b5b3e7acdd2937a3a166",
        "records": 1},
    "polished_assemble": {
        "sha256": "58e00d1d6363143f5245b2db88ac71560bc857988b483c22670c558349f9f625",
        "records": 1},
    "bridged_contigs": {
        "sha256": "ef9694a1cbf026f8d0672a641f25e5584b2146137421b5b3e7acdd2937a3a166",
        "records": 1},
    "polished_bridge": {
        "sha256": "58e00d1d6363143f5245b2db88ac71560bc857988b483c22670c558349f9f625",
        "records": 1}}}
# Phase 21's records that differ from the JAX package's CPU run by a float32
# tie of the reference (ROADMAP queue 3), by file: the port's record
# (fasta_record_digests: name, length, sha256[:16] of the sequence) and the
# reference's. cns_final: template 199's first iteration calls the gap at
# column 5240 on an exact sum that the reference's float32 sums tie with A
# (MAIN_TIE_FLIPS' tie, scripts/adaptive_tie_probe.py), so its second
# iteration's template is 16 334 bases, not 16 335, and its record's right
# end and original size in the name are one less; the sequence is the same.
# trim keeps the names (and the JAX package's trim of the port's cns_final
# writes the port's trimReads).
TIE_199 = {"199_15_16305_16334 16376 2f26377ff4d51343":
           "199_15_16306_16335 16376 2f26377ff4d51343"}
PIPELINE_TIES = {"cns_final": TIE_199, "trimReads": TIE_199}
# fasta_digest of necat_tpu's bridge_contigs of phase 11b's contigs and reads
# on the CPU (scripts/jax_bridge_reference.py): phase 21's bridged bench
# contigs must equal it.
JAX_CPU_BRIDGE_DIGEST = {
    "sha256": "ae7568a534fdcf056c892d4e385e6dd6fc6584d711a9c45d4081bf3464e97ab1",
    "records": 1}
# m4_digest of necat_tpu's extend_candidates and records_digest of its
# correct_reads(rescue_long_indels=True) of planted_pairs on the CPU
# (scripts/jax_pipeline_reference.py --ladder-only): phase 21's ladder.
JAX_CPU_LADDER_REFERENCE = {
    "m4": "7accc69555a75b55018709fee25efeab758dce9d0a7c872ac41ee621646a1e2c",
    "records": "74a99a13f3ecb670ce3564bdac0a004ec5dc3604f0e39cf81aa5abb20e436ae8"}
RUNGS = (512, 1024, 2048, 4096)      # the rescue ladder's widths from W0=128
POLISH_W = 256                       # PolishOptions.band_width
POLISH_WORDS = 3                     # K3's insb words at max_delta 22
WORDS3_RUNGS = (1024,)               # rungs where K3 is also held at POLISH_WORDS
WIDE = (2048, 4096)                  # rungs the rescue phase must launch K1 and K3 at
RESCUE_INSERTS = (0, 300, 0, 600, 1000, 0)
SLICE_MAP = dict(kmer_size=13, max_hits=1 << 18, max_pairs=4096)   # slice_store's MapOptions
# phase 11b: (start, end, reverse-complemented) of the bench genome's pieces
# that stand for contigs, and their order in the contig store
BRIDGE_PIECES = ((0, 45_000, False), (47_000, 90_000, False), (87_000, 130_000, True),
                 (131_500, 170_000, False), (173_000, 200_000, False))
BRIDGE_ORDER = (3, 0, 4, 2, 1)
WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
PHASE10 = os.path.join(WORK, "phase10")     # copies of phase 10's outputs
PHASE10_FILES = ("1-consensus/cns_final.fasta.gz", "trimReads.fasta.gz", "4-fsa/contigs.fasta",
                 "polished_contigs.fasta")
VOL_SIZE = 1_500_000                 # phase 15: three volumes of the 4.02 Mb bench set
# phase 17c: genome size, coverage, read lengths and substitution rate of the
# E. coli-scale volume (PERF.md's 4.6 Mb x40 stand-in, 184 Mb)
ECOLI_VOLUME = dict(genome_size=4_600_000, coverage=40, min_len=3000, max_len=20000,
                    sub=0.10, seed=7)
# K1a and K3a replace XLA scan code of the JAX package's adaptive band (no
# pallas_call): banded_forward, and banded_traceback + ops_to_cols
REPLACES = {"diag_sub_matrix": "necat_tpu/align/pallas_banded.py:146",
            "banded_forward": "necat_tpu/align/pallas_banded.py:65",
            "banded_backtrack_cols": "necat_tpu/align/pallas_banded.py:325",
            "banded_forward_adaptive": "necat_tpu/align/banded.py:48",
            "adaptive_backtrack_cols": "necat_tpu/align/banded.py:112+:181"}
ON_PATH = ("banded_forward", "banded_backtrack_cols")   # K2's work is inside K1
# the adaptive band's kernels (NECAT_TPU_NO_PALLAS), and the paths (phases
# 20, 21 and 22c) where they may launch
ADAPTIVE = ("banded_forward_adaptive", "adaptive_backtrack_cols")
ADAPTIVE_PATHS = ("adaptive", "adaptive-pipeline", "adaptive-bridge", "adaptive-ladder",
                  "legacy-adaptive")
# Phase 20 holds K1a and K3a against their plain versions at L=8192 at
# main's width (128) and at ADAPTIVE_L at the other widths: the plain
# versions launch a few torch ops per column or op (4-8 s a call at 8192).
ADAPTIVE_L = 2048
# phase 19: the timing scopes of main's path (the JAX package's names), and
# those of them that no other scope holds, which PERF.md sums against the wall
MAIN_SCOPES = ("cand.devstore_init", "cand.index_build", "cand.batch_total", "cand.read_rows",
               "cand.dispatch_total", "cand.limits", "cand.dispatch", "cand.stats_sync",
               "cand.topn", "ext.chunk_build", "ext.stats_sync", "ext.lanes",
               "ext.real_lanes", "ext.cell_Mlanes", "cns.devstore_init", "cns.bucket_setup",
               "cns.wave_build", "cns.extend_pairs_total", "cns.fused_dispatch",
               "cns.fused_desc_up", "cns.fused_call", "cns.accept", "cns.call_consensus",
               "cns.download", "cns.compact")
TOP_LEVEL_SCOPES = ("cand.devstore_init", "cand.index_build", "cand.batch_total", "cand.topn",
                    "cns.devstore_init", "cns.bucket_setup", "cns.wave_build",
                    "cns.extend_pairs_total", "cns.accept", "cns.call_consensus",
                    "cns.compact")
# H100 SXM peaks: HBM3 bytes/s (NVIDIA H100 datasheet) and INT32 operations/s
# (132 SMs x 64 INT32 lanes x 1.98 GHz, NVIDIA H100 white paper)
PEAK_BYTES_S = 3.35e12
PEAK_INT_OPS_S = 132 * 64 * 1.98e9
# Integer operations the function needs, the fewest it can be done in. An
# ENC byte (mismatch | qbase << 1) costs 9 operations per 4 bytes packed in a
# word: the per-byte "differs" test (xor, and, add, or, shift, and), the
# query base (and, shift) and the or. A K1 cell (a lane of a column at or
# below lb) adds the DP step: diag add, left add, min, the insertion chain's
# prefix-min step and the op select (5). K2 computes one ENC byte per output
# byte. K3's walk tests, per live column, the lanes from its slot down to the
# end of the insertion run there (k + 1 of them, k from its cols output):
# op bits and a compare each.
# A K1a cell (row coordinates, the op alone) needs the mismatch compare, the
# diag add, left add, min, the chain's prefix-min step, the op select and
# the compare of the next column's argmin (7). K3a's walk tests lanes as
# K3's does.
ENC_OPS = 9 / 4
OPS_PER_CELL = {"banded_forward": ENC_OPS + 5, "diag_sub_matrix": ENC_OPS,
                "banded_forward_adaptive": 7}
OPS_PER_WALK_LANE = 2
WALKS = ("banded_backtrack_cols", "adaptive_backtrack_cols")


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
    from necat_tpu_torch import native
    from necat_tpu_torch.utils import build as b
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:   # nvcc and g++ together
        for f in [pool.submit(b.load_kernels), pool.submit(native.load)]:
            f.result()
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
        # in slices of 2^26 elements: a path's dirs reach 4 GiB (PB 256 x
        # 65536 columns x W 256), eight times that as int64
        u, v = u.reshape(-1), v.reshape(-1)
        for i in range(0, u.numel(), 1 << 26):
            d = u[i:i + (1 << 26)].long() - v[i:i + (1 << 26)].long()
            err = max(err, float(d.abs().max()))
    return err


def _cuda_kernel(name: str, W: int) -> str:
    """The function in KERNEL_SOURCE that the wrapper launches at width W."""
    base = {"banded_backtrack_cols": "banded_backtrack",
            "adaptive_backtrack_cols": "adaptive_backtrack"}.get(name, name)
    return f"{base}_kernel<{W}>"


def bound(name: str, a, b, lb, W: int, cols=None, words: int = 1, la=None):
    """(bound_ms, bound_by) of one launch on these inputs: each input byte
    read once and each output byte written once over PEAK_BYTES_S, or the
    integer operations it needs over PEAK_INT_OPS_S, whichever takes longer.
    K3 reads only the live rows of dirs and writes cols and `words` insb
    words; its operations follow the walk, from its cols output. K1a writes
    offs, the last column and the cost besides dirs; K3a reads the live rows
    of dirs, offs up to lb and the la + lb bases the walk consumes."""
    PB, L = a.shape
    MC = b.shape[1]
    ncol = lb.clamp(min=0, max=MC)
    live = int(ncol.sum()) * W                            # cells of columns <= lb
    rows = a.numel() + b.numel() + 8 * PB
    walk_out = 4 * (1 + words) * PB * MC + 4 * PB
    if name == "adaptive_backtrack_cols":
        nbytes = (live + 8 * PB + 4 * int((ncol + 1).sum()) + int(la.clamp(min=0).sum())
                  + int(ncol.sum()) + walk_out)
    else:
        nbytes = {"diag_sub_matrix": rows + PB * MC * W,
                  "banded_forward": rows + PB * MC * W + 4 * PB,
                  "banded_forward_adaptive": rows + PB * MC * W + 4 * PB * (MC + 2 + W),
                  "banded_backtrack_cols": live + 8 * PB + walk_out}[name]
    if name in WALKS:
        in_walk = torch.arange(MC, device=cols.device)[None, :] < ncol[:, None]
        ops = int(((cols >> 5) + 1)[in_walk].sum()) * OPS_PER_WALK_LANE
    else:
        ops = (PB * MC * W if name == "diag_sub_matrix" else live) * OPS_PER_CELL[name]
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_INT_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_pairs(dev, W: int, L: int = 8192):
    """One production chunk of pairs at width W (seed 2024): PB =
    pairs_per_chunk(L, W) targets of L/4 .. L bases and 15 %-error copies as
    queries, lengths clamped to |la - lb| <= W/4. Returns a, b, la, lb on dev."""
    from necat_tpu_torch.io import simulate
    from necat_tpu_torch.utils import shapes
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
    return [torch.from_numpy(x).to(dev) for x in (a, b, la, lb)]


def check_kernels(dev, W: int = 128, L: int = 8192, k3_words=(1,)) -> dict:
    """Each kernel against its plain version at one production chunk, K3 at
    each insb word count in k3_words; results keyed (kernel, W, words), words
    None for K1 and K2."""
    from necat_tpu_torch.align import banded_kernels as bk
    a, b, la, lb = kernel_pairs(dev, W, L)
    PB = a.shape[0]
    steps = {
        ("banded_forward", None): (lambda: bk.banded_forward(a, b, la, lb, W),
                                   lambda: bk.banded_forward_ref(a, b, la, lb, W)),
        ("diag_sub_matrix", None): (lambda: bk.diag_sub_matrix(a, b, la, lb, W, L),
                                    lambda: bk.diag_sub_matrix_ref(a, b, la, lb, W, L)),
    }
    dirs, _ = steps[("banded_forward", None)][0]()
    for w in k3_words:
        steps[("banded_backtrack_cols", w)] = (
            lambda w=w: bk.banded_backtrack_cols(dirs, la, lb, W, w),
            lambda w=w: bk.banded_backtrack_cols_ref(dirs, la, lb, W, w))
    results = {}
    for (name, words), (kernel, plain) in steps.items():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        ms = _time_ms(kernel, 5)
        plain_ms = _time_ms(plain, 1)
        results[(name, W, words)] = _kernel_row(
            name, W, words, PB, L, err, ms, plain_ms,
            bound(name, a, b, lb, W, got[0] if words else None, words or 1))
    return results


def _kernel_row(name, W, words, PB, L, err, ms, plain_ms, bound_ms_by,
                inputs: str = "kernel_pairs") -> dict:
    """A kernel's row of the "kernels" line, printed; raises if the kernel and
    its plain version disagree. `inputs` names where the pairs came from:
    kernel_pairs, or the path whose launch they were."""
    bound_ms, bound_by = bound_ms_by
    print(f"kernel {name}: PB={PB} L={L} W={W}"
          + (f" words={words}" if words else "") + f" inputs={inputs} max_abs_err={err} "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}, {100 * bound_ms / ms:.1f} % of it)", flush=True)
    if err != 0.0:
        raise AssertionError(f"{name}: kernel and plain version disagree ({err})")
    return dict(name=name, W=W, **({"words": words} if words else {}), L=L, PB=PB,
                inputs=inputs, cuda_kernel=_cuda_kernel(name, W), route="cuda",
                source=KERNEL_SOURCE, replaces=REPLACES[name], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def _launches(bk) -> dict:
    """This path's launch counts: by (wrapper, W), and K3's by (W, words)."""
    return {"by_width": collections.Counter(bk.launches_by_width),
            "k3_by_words": collections.Counter(bk.k3_launches_by_words),
            "k3a_by_words": collections.Counter(bk.k3a_launches_by_words)}


def _same_records(ra, rb) -> None:
    if len(ra) != len(rb):
        raise AssertionError(f"record counts differ: {len(ra)} vs {len(rb)}")
    for x, y in zip(ra, rb):
        if ((x.tid, x.left, x.right, x.corrected) != (y.tid, y.left, y.right, y.corrected)
                or not np.array_equal(x.seq, y.seq)):
            raise AssertionError(f"records differ at template {x.tid}")


def record_differences(ra, rb, limit: int = 5) -> str:
    """The templates whose records differ between two runs, each with its
    first differing field: ra's value against rb's."""
    by = [collections.defaultdict(list), collections.defaultdict(list)]
    for d, recs in zip(by, (ra, rb)):
        for r in recs:
            d[r.tid].append(r)
    out = []
    for tid in sorted(set(by[0]) | set(by[1])):
        xs, ys = by[0].get(tid, []), by[1].get(tid, [])
        if len(xs) != len(ys):
            out.append(f"{tid}: {len(xs)} records against {len(ys)}")
            continue
        for x, y in zip(xs, ys):
            fields = [(f, getattr(x, f), getattr(y, f)) for f in ("left", "right", "corrected")]
            fields.append(("len(seq)", len(x.seq), len(y.seq)))
            n = min(len(x.seq), len(y.seq))
            at = np.flatnonzero(x.seq[:n] != y.seq[:n])
            fields.append(("seq at", int(at[0]) if len(at) else None, None))
            diff = next(((f, a, b) for f, a, b in fields if a != b), None)
            if diff:
                out.append(f"{tid}: {diff[0]} {diff[1]} against {diff[2]}")
                break
    return f"{len(out)} template(s) differ: " + "; ".join(out[:limit])


def slice_store():
    """The small read set of the slice and trim-accurate phases (19 reads of
    3-5.5 kb at 6x of a 12 kb genome, tests/torch_port_helpers.small_store)."""
    from necat_tpu_torch.io import simulate
    from necat_tpu_torch.io.readstore import ReadStore
    genome = simulate.random_genome(12000, seed=33)
    reads, *_ = simulate.simulate_reads(genome, coverage=6, mean_len=4000,
                                        min_len=3000, max_len=5500, seed=34)
    return ReadStore.from_seqs(reads)


def check_slice(dev) -> None:
    """Small read set: the cuda path equals the cpu path (plain versions)."""
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.consensus.options import CnsOptions
    from necat_tpu_torch.overlap.candidates import Candidates
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.overlap.overlapper import find_all_candidates
    rs = slice_store()
    mo = MapOptions(**SLICE_MAP)
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


def records_digest(recs, skip=()) -> str:
    """sha256 over (tid, left, right, corrected, seq) of each record, in tid
    order (stable), less the templates in `skip`: one digest of a
    correction's whole output."""
    import hashlib
    h = hashlib.sha256()
    for r in sorted(recs, key=lambda r: r.tid):
        if r.tid in skip:
            continue
        seq = np.ascontiguousarray(r.seq, dtype=np.uint8)
        h.update(np.array([r.tid, r.left, r.right, int(r.corrected), len(seq)],
                          np.int64).tobytes())
        h.update(seq.tobytes())
    return h.hexdigest()


def m4_digest(m4) -> str:
    """sha256 over every field of an M4 set (as int64, in field order): one
    digest of an extension's whole output."""
    import hashlib
    h = hashlib.sha256()
    for f in dataclasses.fields(m4):
        h.update(f.name.encode())
        h.update(np.ascontiguousarray(getattr(m4, f.name), np.int64).tobytes())
    return h.hexdigest()


def dump_records(recs, path: str) -> None:
    """Every record's tid, left, right, corrected and seq (concatenated, with
    offsets) in tid order, as one .npz: for comparing two runs' records."""
    recs = sorted(recs, key=lambda r: r.tid)
    seqs = [np.ascontiguousarray(r.seq, dtype=np.uint8) for r in recs]
    np.savez_compressed(path, fields=np.array([[r.tid, r.left, r.right, int(r.corrected)]
                                               for r in recs], np.int64).reshape(-1, 4),
                        offsets=np.cumsum([0] + [len(x) for x in seqs]),
                        seq=np.concatenate(seqs) if seqs else np.zeros(0, np.uint8))


def accuracy_sample(recs, lengths, genome, st, sd, ln, n_sample=24):
    """Mean identity to the true genome interval of the first n_sample
    corrected pieces of >= 2 kb (bench.py:accuracy_sample); a piece
    [left, right) of a read of lengths[tid] maps to the same fraction of the
    read's genome interval."""
    from necat_tpu_torch.io import simulate
    idents = []
    for r in recs:
        if not r.corrected or len(idents) >= n_sample:
            continue
        i = r.tid
        frac_l, frac_r = r.left / lengths[i], r.right / lengths[i]
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


def main_path(dev, launch_counts: dict):
    """Returns main's summary and (store, candidates, role-expanded
    candidates, records) for the phases that rerun its inputs."""
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.consensus.options import CnsOptions
    from necat_tpu_torch.overlap import overlapper
    from necat_tpu_torch.overlap.candidates import Candidates
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.overlap.overlapper import find_all_candidates
    from necat_tpu_torch.utils.benchdata import gen_benchmark_reads
    genome, store, (st, sd, ln) = gen_benchmark_reads(genome_size=200_000,
                                                      coverage=20, seed=7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bk.reset_launches()
    overlapper.index_build_s.clear()
    t0 = time.perf_counter()
    cands = find_all_candidates(store, store, MapOptions(), pairwise=True, device=dev)
    call = Candidates.concat([cands, cands.swap_roles()])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    recs = correct_reads(store, call, CnsOptions(), device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launch_counts["main"] = _launches(bk)
    launches = {name: sum(n for (k, _), n in launch_counts["main"]["by_width"].items()
                          if k == name)
                for name in REPLACES}
    ncorr = len({r.tid for r in recs if r.corrected})
    ident = accuracy_sample(recs, store.lengths, genome, st, sd, ln)
    print("main " + json.dumps({
        "reads": store.n_reads, "bases": int(store.total_bases),
        "candidates": len(cands), "records": len(recs), "corrected_reads": ncorr,
        "identity_pct": ident, "candidates_s": round(t1 - t0, 3),
        "index_build_s": round(sum(overlapper.index_build_s), 3),
        "correct_s": round(t2 - t1, 3), "wall_s": round(t2 - t0, 3),
        "corrected_reads_per_s": round(ncorr / (t2 - t0), 3),
        "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
        "launches": launches}), flush=True)
    if any(launches[k] == 0 for k in ON_PATH) or launches["diag_sub_matrix"]:
        raise AssertionError(f"main must launch K1 and K3 and not K2: {launches}")
    for r in recs:
        if r.seq.dtype != np.uint8 or (len(r.seq) and r.seq.max() > 3):
            raise AssertionError(f"record of template {r.tid} holds non-base codes")
    ref = JAX_CPU_REFERENCE
    if ncorr < 0.97 * ref["corrected_reads"]:
        raise AssertionError(f"corrected {ncorr} < 97 % of {ref['corrected_reads']}")
    if ident is None or ident < ref["identity"] - 0.5:
        raise AssertionError(f"identity {ident} < {ref['identity']} - 0.5")
    return {"corrected_reads": ncorr, "identity": ident}, (store, cands, call, recs)


def planted_pairs(seed: int = 11, tlen: int = 6000, inserts=RESCUE_INSERTS):
    """Template read 0 and query reads 1..k, query i a copy of the template at
    2 % error with a random insertion of inserts[i] bases in the middle, and
    the candidates (query i on the template, anchored 100 bases in) of
    tests/test_rescue.py:_pair_with_insert's shape. From band width 128 the
    ladder crosses 300 bases at W=512, 600 at 2048 and 1000 at 4096 (the
    plain versions on the CPU), so the rungs 1024, 2048 and 4096 each carry
    a pair. (Longer insertions are not crossed: the extension clamps
    |la - lb| to W/4, so crossing n inserted bases costs about 2n - W/4.)"""
    from necat_tpu_torch.io import simulate
    from necat_tpu_torch.io.readstore import ReadStore
    from necat_tpu_torch.overlap.candidates import Candidates
    rng = np.random.default_rng(seed)
    em = simulate.ErrorModel(sub=0.02, ins=0.02, dele=0.02)
    t = rng.integers(0, 4, tlen).astype(np.uint8)
    qry = []
    for n in inserts:
        ins = rng.integers(0, 4, n).astype(np.uint8)
        qry.append(np.concatenate([simulate.mutate(t[:tlen // 2], em, rng), ins,
                                   simulate.mutate(t[tlen // 2:], em, rng)]).astype(np.uint8))
    k = len(inserts)
    qsize = np.array([len(q) for q in qry], np.int32)
    cands = Candidates(qid=np.arange(1, k + 1, dtype=np.int32), sid=np.zeros(k, np.int32),
                       qdir=np.zeros(k, np.int8), score=np.full(k, 100, np.int32),
                       qbeg=np.full(k, 100, np.int32), qend=qsize - 100,
                       sbeg=np.full(k, 100, np.int32),
                       send=np.full(k, tlen - 100, np.int32), qsize=qsize,
                       ssize=np.full(k, tlen, np.int32))
    return ReadStore.from_seqs([t] + qry), cands


def check_rescue(dev, launch_counts: dict) -> None:
    """extend_candidates and correct_reads(rescue_long_indels=True) of the
    planted pairs on each device; identical results."""
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.consensus.options import CnsOptions
    from necat_tpu_torch.overlap.candidates import Candidates
    from necat_tpu_torch.overlap.overlapper import extend_candidates
    rs, cands = planted_pairs()
    res = {}
    for d in ("cpu", dev):
        bk.reset_launches()
        t0 = time.perf_counter()
        m4 = extend_candidates(cands, rs, rs, device=d)
        recs = correct_reads(rs, Candidates.concat([cands, cands.swap_roles()]),
                             CnsOptions(rescue_long_indels=True), device=d)
        if d != "cpu":
            torch.cuda.synchronize()
            launch_counts["rescue"] = _launches(bk)
        res[str(d)] = (m4, recs)
        spans = (m4.qend - m4.qoff).tolist()
        print(f"rescue on {d}: {time.perf_counter() - t0:.1f} s, M4 query spans "
              f"{spans} (inserts {list(RESCUE_INSERTS)}), {len(recs)} records, "
              f"{sum(r.corrected for r in recs)} corrected", flush=True)
    (m4_a, recs_a), (m4_b, recs_b) = res.values()
    for f in dataclasses.fields(m4_a):
        if not np.array_equal(getattr(m4_a, f.name), getattr(m4_b, f.name)):
            raise AssertionError(f"rescue: M4 field {f.name} differs between devices")
    _same_records(recs_a, recs_b)
    if len(m4_a) != len(RESCUE_INSERTS) or \
            ((m4_a.qend - m4_a.qoff) < m4_a.qsize - 400).any():
        raise AssertionError("rescue: a planted insertion was not crossed")
    counts = launch_counts["rescue"]["by_width"]
    print("rescue: devices identical; launches by width "
          + json.dumps({f"{k}@{w}": n for (k, w), n in sorted(counts.items())}), flush=True)
    missing = [(k, w) for k in ("banded_forward", "banded_backtrack_cols") for w in WIDE
               if not counts.get((k, w))]
    if missing:
        raise AssertionError(f"rescue: kernels never launched at {missing}")


def bench_project(work: str = WORK, template: str | None = None, fresh: bool = True):
    """A directory `work` (emptied first if `fresh`) holding the bench read
    set (reads.fasta, read_list.txt) and phase 8's config (from `template`,
    by default the port's config template) for the project work/project.
    Returns the config's path, the genome and the reads' truth (starts,
    strands, lengths)."""
    from necat_tpu_torch.pipeline import config as config_mod
    from necat_tpu_torch.utils.benchdata import gen_benchmark_reads
    genome, store, truth = gen_benchmark_reads(genome_size=200_000, coverage=20, seed=7)
    if fresh:
        shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work, exist_ok=True)
    reads = os.path.join(work, "reads.fasta")
    if not os.path.exists(reads):
        store.to_fasta(reads)
    with open(os.path.join(work, "read_list.txt"), "w") as f:
        f.write(reads + "\n")
    cfg_path = os.path.join(work, "run.cfg")
    with open(cfg_path, "w") as f:
        f.write(pipeline_config(template or config_mod.CONFIG_TEMPLATE,
                                os.path.join(work, "project"),
                                os.path.join(work, "read_list.txt")))
    return cfg_path, genome, truth


def check_correct(launch_counts: dict, main_res: dict):
    """The CLI's correct command (Project.run_correct) on the bench read set
    with the config template's options and NUM_ITER=2 (iteration 2 runs the
    rescue ladder), on "cuda". Returns the config's path and the genome."""
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.consensus.correct import CnsRecord
    from necat_tpu_torch.io.readstore import ReadStore
    from necat_tpu_torch.pipeline import cli
    cfg_path, genome, (st, sd, ln) = bench_project()
    bk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(["correct", cfg_path, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launch_counts["correct"] = _launches(bk)
    if rc != 0:
        raise AssertionError(f"correct: the command line exited {rc}")
    ran = {k for (k, _), n in launch_counts["correct"]["by_width"].items() if n}
    if ran != set(ON_PATH):
        raise AssertionError(f"correct: K1 and K3 must launch and K2 not: {ran}")
    cns_dir = os.path.join(WORK, "project", "1-consensus")
    final = ReadStore.from_fasta(os.path.join(cns_dir, "cns_final.fasta.gz"))
    with open(os.path.join(cns_dir, "correct.done.json")) as f:
        iters = json.load(f)["iterations"]
    recs = []
    for i in range(final.n_reads):
        tid, left, right, org = map(int, final.names[i].split("_"))
        recs.append(CnsRecord(tid=tid, left=left, right=right, org_size=org,
                              seq=final.get(i), corrected=True))
    lengths = {r.tid: r.org_size for r in recs}
    ncorr = len(lengths)
    ident = accuracy_sample(recs, lengths, genome, st, sd, ln)
    print("correct " + json.dumps({
        "iterations": iters, "wall_s": wall,
        "launches": {f"{k}@{w}": n for (k, w), n in
                     sorted(launch_counts["correct"]["by_width"].items())},
        "cns_final_reads": final.n_reads, "cns_final_bases": int(final.total_bases),
        "corrected_reads": ncorr, "identity_pct": ident,
        "main": main_res}), flush=True)
    if ncorr < 0.97 * main_res["corrected_reads"]:
        raise AssertionError(f"correct: {ncorr} reads < 97 % of main's "
                             f"{main_res['corrected_reads']}")
    if ident is None or ident < main_res["identity"] - 0.5:
        raise AssertionError(f"correct: identity {ident} < main's "
                             f"{main_res['identity']} - 0.5")
    return cfg_path, genome


def collapsed_repeat(seed: int = 21):
    """tests/test_polish.py's collapsed repeat: a 20 kb genome whose draft
    misses 300 bases at 9000; three reads at 3 % error per kind across the
    site and four elsewhere. Returns (truth, drop, draft, reads)."""
    from necat_tpu_torch.io import simulate
    rng = np.random.default_rng(seed)
    truth = simulate.random_genome(20000, seed=25)
    drop = 9000
    draft = np.concatenate([truth[:drop], truth[drop + 300:]])
    em = simulate.ErrorModel(0.03, 0.03, 0.03)
    reads = [simulate.mutate(truth[s:s + 8000], em, rng) for s in (5500, 6500, 7500)]
    reads += [simulate.mutate(truth[s:s + 6000], em, rng) for s in (0, 2000, 12000, 14000)]
    return truth, drop, draft, reads


def best_substring_ed(hay: np.ndarray, needle: np.ndarray) -> int:
    """The fewest edits turning needle into a substring of hay."""
    m = len(needle)
    ar = np.arange(m + 1, dtype=np.int32)
    prev = ar.copy()
    best = int(prev[m])
    for x in hay:
        base = np.minimum(prev[:-1] + (needle != x).astype(np.int32), prev[1:] + 1)
        prev = np.minimum.accumulate(np.concatenate(([np.int32(0)], base)) - ar) + ar
        best = min(best, int(prev[m]))
    return best


def check_polish(dev, launch_counts: dict) -> None:
    """polish_contigs of the collapsed repeat on "cpu" and on the card:
    identical polished contigs; the hotspot repair returned an override."""
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.consensus import correct
    from necat_tpu_torch.io.readstore import ReadStore
    from necat_tpu_torch.polish import polish
    truth, drop, draft, reads = collapsed_repeat()
    opts = polish.PolishOptions(segment_size=16384, min_ident=75.0, templates_per_batch=2)
    repair = correct._bucket_hot_overrides
    res = {}
    for d in ("cpu", dev):
        overrides = []
        correct._bucket_hot_overrides = lambda *a, **k: overrides.append(
            repair(*a, **k)) or overrides[-1]
        bk.reset_launches()
        correct.seconds_by_part.clear()
        t0 = time.perf_counter()
        try:
            pol = polish.polish_contigs(ReadStore.from_seqs([draft], ["ctg0"]),
                                        ReadStore.from_seqs(reads), device=d, opts=opts)
        finally:
            correct._bucket_hot_overrides = repair
        if d != "cpu":
            torch.cuda.synchronize()
            launch_counts["polish"] = _launches(bk)
        wall = time.perf_counter() - t0
        seq = pol.get(0)
        res[str(d)] = seq
        pattern = truth[drop - 50:drop + 350]          # the dropped chunk in context
        print(f"polish on {d}: {wall:.1f} s, parts "
              + json.dumps({k: round(v, 3) for k, v in correct.seconds_by_part.items()})
              + f", override positions {[sum(map(len, o.values())) for o in overrides]}, "
              f"repeat edits draft {best_substring_ed(draft[drop - 800:drop + 800], pattern)}"
              f" polished {best_substring_ed(seq[drop - 800:drop + 1200], pattern)}",
              flush=True)
        if not any(overrides):
            raise AssertionError(f"polish on {d}: the hotspot repair made no override")
    if not np.array_equal(res["cpu"], res[str(dev)]):
        raise AssertionError("polish: cuda and cpu polished contigs differ")
    print("polish: devices identical; launches "
          + json.dumps({f"{k}@{w}": n for (k, w), n in
                        sorted(launch_counts["polish"]["by_width"].items())})
          + ", K3 by (W, words) "
          + json.dumps({f"{w}x{n_w}": n for (w, n_w), n in
                        sorted(launch_counts["polish"]["k3_by_words"].items())}), flush=True)


def contig_identity(contigs, genome, piece: int = 10_000, k: int = 21):
    """Identity (percent) of contigs to the circular true genome: each contig
    is cut into `piece`-base pieces, each piece placed by the first of its
    k-mers (every 50 bases from its start) that occurs exactly once in the
    genome on either strand, and scored by simulate.banded_edit_distance
    against the genome window around that place. Returns (identity over the
    placed pieces, placed bases, all bases)."""
    from necat_tpu_torch.io import simulate
    g = genome.astype(np.uint8)
    pad = min(2 * piece, len(g))
    rc = (3 - g[::-1]).astype(np.uint8)
    cores = [np.concatenate([x, x[:k - 1]]).tobytes() for x in (g, rc)]
    exts = [np.concatenate([x[-pad:], x, x[:pad]]).tobytes() for x in (g, rc)]
    edits = placed = total = 0
    for c in range(contigs.n_reads):
        seq = contigs.get(c)
        for p0 in range(0, len(seq), piece):
            pc = seq[p0:p0 + piece]
            total += len(pc)
            for off in range(0, max(len(pc) - k, 0), 50):
                kmer = pc[off:off + k].tobytes()
                n_hits = [h.count(kmer) for h in cores]
                if sum(n_hits) == 1:
                    break
            else:
                continue
            s = n_hits.index(1)
            lo = cores[s].find(kmer) + pad - off
            ref = np.frombuffer(exts[s][lo - 100:lo + len(pc) + 100], np.uint8)
            edits += simulate.banded_edit_distance(pc, ref, band=300, b_prefix_free=True,
                                                   b_suffix_free=True)
            placed += len(pc)
    return (100.0 * (1 - edits / placed) if placed else None), placed, total


def bridge_bench_contigs(genome):
    """Phase 11b's contigs: the bench genome cut into BRIDGE_PIECES (gaps of
    2, 1.5 and 3 kb, and a 3 kb overlap between pieces 1 and 2, piece 2
    reverse-complemented), piece BRIDGE_ORDER[i] stored at id i. Returns
    (sequences, names)."""
    from necat_tpu_torch.io import seqio
    seqs = [seqio.revcomp(genome[s:e]) if rc else genome[s:e].copy()
            for s, e, rc in BRIDGE_PIECES]
    return [seqs[i] for i in BRIDGE_ORDER], [f"piece{i}" for i in BRIDGE_ORDER]


STAGE_DIRS = {"correct": "1-consensus", "trim": "2-trim_bases", "assemble": "4-fsa",
              "bridge": "6-bridge_contigs", "polish": "final-polish"}


def pipeline_config(template: str, prj: str, read_list: str) -> str:
    """Phase 8's config (the config template with the bench genome's size and
    MIN_READ_LENGTH=1000) for project `prj`: both packages' templates take
    the same replacements."""
    return template.replace("PROJECT=", f"PROJECT={prj}").replace(
        "ONT_READ_LIST=", f"ONT_READ_LIST={read_list}").replace(
        "GENOME_SIZE=", "GENOME_SIZE=200000").replace(
        # keep every read (a few simulated from 3 kb intervals come out
        # shorter), so that read ids stay the bench set's
        "MIN_READ_LENGTH=3000", "MIN_READ_LENGTH=1000")


def pipeline_paths(prj: str, polished_after_assemble: str) -> dict:
    """The stage files of `cli assemble` then `cli bridge` that phase 21
    holds to JAX_CPU_PIPELINE_REFERENCE, by key."""
    return {"cns_final": os.path.join(prj, "1-consensus", "cns_final.fasta.gz"),
            "trimReads": os.path.join(prj, "trimReads.fasta.gz"),
            "contigs": os.path.join(prj, "4-fsa", "contigs.fasta"),
            "polished_assemble": polished_after_assemble,
            "bridged_contigs": os.path.join(prj, "6-bridge_contigs", "bridged_contigs.fasta"),
            "polished_bridge": os.path.join(prj, "polished_contigs.fasta")}


def stage_seconds(prj: str) -> dict:
    """Each stage's wall_s from its manifest (polish: the last run's)."""
    out = {}
    for name, sub in STAGE_DIRS.items():
        path = os.path.join(prj, sub, f"{name}.done.json")
        if os.path.exists(path):
            with open(path) as f:
                out[name] = json.load(f)["wall_s"]
    return out


def run_pipeline(cli, cfg_path: str, prj: str, after_assemble: str,
                 device: str | None = None, cns_final: str | None = None) -> tuple:
    """`cli assemble` and then `cli bridge` of cfg_path's project prj, with
    either package's cli module (`device` adds --device). The bridge
    command's polish overwrites polished_contigs.fasta, so the assemble
    command's is copied to after_assemble first. cns_final, another run's
    file, stands in for the correct stage's output (correct does not run).
    A project whose bridge manifest and after_assemble exist is only read.
    Returns (pipeline_paths, each command's wall seconds, the stages'
    seconds from the manifests after each command)."""
    paths = pipeline_paths(prj, after_assemble)
    if cns_final:
        os.makedirs(os.path.dirname(paths["cns_final"]), exist_ok=True)
        if not os.path.exists(paths["cns_final"]):
            shutil.copy(cns_final, paths["cns_final"])
        cli.Project.run_correct = lambda self, *a, **k: paths["cns_final"]
    walls, stages = {}, {}
    if os.path.exists(after_assemble) and os.path.exists(
            os.path.join(prj, STAGE_DIRS["bridge"], "bridge.done.json")):
        return paths, walls, stages
    for cmd in ("assemble", "bridge"):
        t0 = time.perf_counter()
        rc = cli.main([cmd, cfg_path] + (["--device", device] if device else []))
        if rc != 0:
            raise AssertionError(f"cli {cmd} exited {rc}")
        walls[cmd] = time.perf_counter() - t0
        stages[cmd] = stage_seconds(prj)
        if cmd == "assemble":
            shutil.copy(os.path.join(prj, "polished_contigs.fasta"), after_assemble)
    return paths, walls, stages


def _stage_reports(prj: str, names=("correct", "trim", "assemble", "polish")) -> dict:
    """The manifests of these stages of a project (those that exist),
    without their fingerprints and parameters."""
    out = {}
    for name in names:
        path = os.path.join(prj, STAGE_DIRS[name], f"{name}.done.json")
        if os.path.exists(path):
            with open(path) as f:
                out[name] = {k: v for k, v in json.load(f).items()
                             if k not in ("input_fp", "params", "rc")}
    return out


def _run_assemble(launch_counts: dict, path: str, cfg_path: str, genome) -> dict:
    """`cli assemble <cfg_path> --device cuda` on phase 8's project, the
    launch counts set to 0 before it and read after it into
    launch_counts[path]; prints and returns the stage manifests (trim,
    assemble, polish), the contigs and their identity to the genome."""
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.io.readstore import ReadStore
    from necat_tpu_torch.pipeline import cli
    prj = os.path.join(WORK, "project")
    bk.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["assemble", cfg_path, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launch_counts[path] = _launches(bk)
    if rc != 0:
        raise AssertionError(f"{path}: the command line exited {rc}")
    stages = _stage_reports(prj, ("trim", "assemble", "polish"))
    draft = ReadStore.from_fasta(os.path.join(prj, "4-fsa", "contigs.fasta"))
    polished = ReadStore.from_fasta(os.path.join(prj, "polished_contigs.fasta"))
    t1 = time.perf_counter()
    ident = {name: contig_identity(st, genome)[0] for name, st in
             (("draft", draft), ("polished", polished))}
    counts = launch_counts[path]
    res = {"wall_s": wall, "stages": stages,
           "contigs": draft.n_reads, "contig_bases": int(draft.total_bases),
           "contig_n50": draft.n50()[0], "longest": int(draft.lengths.max(initial=0)),
           "polished_bases": int(polished.total_bases), "polished_n50": polished.n50()[0],
           "identity_pct": ident, "identity_s": time.perf_counter() - t1,
           "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
           "launches": {f"{k}@{w}": n for (k, w), n in sorted(counts["by_width"].items())},
           "k3_by_words": {f"{w}x{n_w}": n for (w, n_w), n in
                           sorted(counts["k3_by_words"].items())}}
    print(f"{path} " + json.dumps({**res, "jax_cpu_reference": JAX_CPU_ASSEMBLY_REFERENCE}),
          flush=True)
    if any(k == "diag_sub_matrix" for (k, _), n in counts["by_width"].items() if n):
        raise AssertionError(f"{path}: K2 launched: {dict(counts['by_width'])}")
    if draft.lengths.max(initial=0) < 0.5 * len(genome):
        raise AssertionError(f"{path}: no contig holds half of the genome")
    return res


def check_assemble(launch_counts: dict, cfg_path: str, genome) -> dict:
    """The CLI's assemble command on phase 8's project: correct is skipped
    by its manifest; trim, assemble and polish run on "cuda". Its files are
    kept in PHASE10 for phases 15 and 16 (phase 13 overwrites them)."""
    res = _run_assemble(launch_counts, "assemble", cfg_path, genome)
    os.makedirs(PHASE10, exist_ok=True)
    for f in PHASE10_FILES:
        shutil.copy(os.path.join(WORK, "project", f), PHASE10)
    counts = launch_counts["assemble"]
    missing = [(k, w) for k in ON_PATH for w in (128, POLISH_W)
               if not counts["by_width"].get((k, w))]
    if missing:
        raise AssertionError(f"assemble: K1 and K3 must launch at 128 and {POLISH_W}: "
                             f"{dict(counts['by_width'])}")
    d_id, p_id = res["identity_pct"]["draft"], res["identity_pct"]["polished"]
    ref = JAX_CPU_ASSEMBLY_REFERENCE
    ref_loss = max(ref["draft_identity"] - ref["polished_identity"], 0.0)
    if d_id is None or p_id is None or d_id - p_id > ref_loss + 0.5:
        raise AssertionError(f"assemble: polishing took identity from {d_id} to {p_id}, "
                             f"more than necat_tpu's loss {ref_loss:.3f} + 0.5")
    if p_id < ref["polished_identity"] - 0.5:
        raise AssertionError(f"assemble: polished identity {p_id} < necat_tpu's "
                             f"{ref['polished_identity']} - 0.5")
    return res


def gap_case():
    """tests/test_bridge.py:40's two-contig case: a 40 kb genome cut into
    contigs [0, 18000) and [20000, 40000), five reads at 1 % error per kind
    (three across the 2 kb gap) and one reverse-strand read across it.
    Returns (contig sequences, raw reads)."""
    from necat_tpu_torch.io import seqio, simulate
    G = simulate.random_genome(40000, seed=51)
    em = simulate.ErrorModel(sub=0.01, ins=0.01, dele=0.01)
    rng = np.random.default_rng(9)
    reads = [simulate.mutate(G[s:s + 12000], em, rng) for s in (13000, 14500, 15500)]
    reads += [simulate.mutate(G[s:s + 8000], em, rng) for s in (2000, 30000)]
    reads.append(seqio.revcomp(simulate.mutate(G[14000:25000], em, rng)))
    return [G[:18000].copy(), G[20000:40000].copy()], reads


def _by_width(counts) -> dict:
    return {f"{k}@{w}": n for (k, w), n in sorted(counts["by_width"].items())}


def check_bridge(dev, launch_counts: dict) -> None:
    """(a) bridge_contigs of gap_case on "cpu" and on the card: identical
    bridged contigs. (b) The bench genome's five pieces (bridge_bench_contigs)
    bridged with the bench set's 339 raw reads on the card, held to
    JAX_CPU_BRIDGE_REFERENCE."""
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.bridge import bridge
    from necat_tpu_torch.io.readstore import ReadStore
    from necat_tpu_torch.overlap import overlapper
    from necat_tpu_torch.utils.benchdata import gen_benchmark_reads
    contigs, reads = gap_case()
    res = {}
    for d in ("cpu", dev):
        t0 = time.perf_counter()
        out = bridge.bridge_contigs(ReadStore.from_seqs(contigs, ["c0", "c1"]),
                                    ReadStore.from_seqs(reads), device=d)
        res[str(d)] = out
        print(f"bridge gap case on {d}: {time.perf_counter() - t0:.1f} s, "
              f"{out.n_reads} contigs of {out.lengths.tolist()}", flush=True)
    a, b = res.values()
    if a.names != b.names or not (np.array_equal(a.offsets, b.offsets)
                                  and np.array_equal(a.bases, b.bases)):
        raise AssertionError("bridge: cuda and cpu bridged contigs differ")
    if a.n_reads != 1:
        raise AssertionError(f"bridge: the gap case gave {a.n_reads} contigs, not 1")

    genome, store, _ = gen_benchmark_reads(genome_size=200_000, coverage=20, seed=7)
    seqs, names = bridge_bench_contigs(genome)
    ctg = ReadStore.from_seqs(seqs, names)
    overlapper.pairs_by_band.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bk.reset_launches()
    t0 = time.perf_counter()
    out = bridge.bridge_contigs(ctg, store, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launch_counts["bridge"] = counts = _launches(bk)
    ident, placed, total = contig_identity(out, genome)
    ref = JAX_CPU_BRIDGE_REFERENCE
    print("bridge " + json.dumps({
        "wall_s": wall, "parts": dict(bridge.stats), "contigs_in": ctg.n_reads,
        "lengths_in": ctg.lengths.tolist(), "contigs_out": out.n_reads,
        "lengths_out": out.lengths.tolist(), "identity_pct": ident,
        "placed_bases": [placed, total],
        "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
        "launches": _by_width(counts),
        "pairs_by_band": dict(sorted(overlapper.pairs_by_band.items())),
        "jax_cpu_reference": ref}), flush=True)
    missing = [k for k in ON_PATH if not counts["by_width"].get((k, 256))]
    if missing or any(k == "diag_sub_matrix" for (k, _), n in counts["by_width"].items() if n):
        raise AssertionError(f"bridge: K1 and K3 must launch at 256 and K2 not: "
                             f"{_by_width(counts)}")
    if out.n_reads != ref["contigs"] or \
            abs(out.total_bases - ref["total"]) > 0.005 * ref["total"]:
        raise AssertionError(f"bridge: {out.n_reads} contigs of {out.total_bases} bases, "
                             f"necat_tpu {ref['contigs']} of {ref['total']}")
    if ident is None or ident < ref["identity"] - 0.5:
        raise AssertionError(f"bridge: identity {ident} < necat_tpu's {ref['identity']} - 0.5")


def check_bridge_cli(launch_counts: dict, cfg_path: str) -> None:
    """`cli bridge --device cuda` on phase 8's project: correct, trim and
    assemble are skipped by their manifests; bridge passes the one contig
    through and polish runs again on the bridged file, which must give
    phase 10's polished contigs."""
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.io.readstore import ReadStore
    from necat_tpu_torch.pipeline import cli
    prj = os.path.join(WORK, "project")
    polished = os.path.join(prj, "polished_contigs.fasta")
    assembled = ReadStore.from_fasta(polished)
    bk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(["bridge", cfg_path, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launch_counts["bridge-cli"] = counts = _launches(bk)
    if rc != 0:
        raise AssertionError(f"bridge-cli: the command line exited {rc}")
    stages = _stage_reports(prj, ("bridge", "polish"))
    print("bridge-cli " + json.dumps({"wall_s": wall, "stages": stages,
                                      "launches": _by_width(counts)}), flush=True)
    missing = [k for k in ON_PATH if not counts["by_width"].get((k, POLISH_W))]
    if missing or any(k == "diag_sub_matrix" for (k, _), n in counts["by_width"].items() if n):
        raise AssertionError(f"bridge-cli: K1 and K3 must launch at {POLISH_W} and K2 not: "
                             f"{_by_width(counts)}")
    draft = ReadStore.from_fasta(os.path.join(prj, "4-fsa", "contigs.fasta"))
    bridged = ReadStore.from_fasta(os.path.join(prj, "6-bridge_contigs",
                                                "bridged_contigs.fasta"))
    again = ReadStore.from_fasta(polished)
    for what, x, y in (("bridged", bridged, draft), ("polished", again, assembled)):
        if not (np.array_equal(x.offsets, y.offsets) and np.array_equal(x.bases, y.bases)):
            raise AssertionError(f"bridge-cli: the {what} contigs differ from assemble's")


def check_trim_accurate(dev, launch_counts: dict, cfg_path: str, genome,
                        fast: dict) -> None:
    """(a) trim_reads_accurate of the first 12 reads of check_slice's read
    set (their overlaps from the CPU; cuts of 70 %, since these are raw
    reads) on "cpu" and on the card: identical trimmed reads, kept ids and
    ranges. (b) `cli assemble`
    with TRIM_METHOD=accurate on phase 8's project: trim, assemble and
    polish run again on the card; the draft's identity is held to phase
    10's (fast trim)."""
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.overlap.overlapper import overlap_all_vs_all
    from necat_tpu_torch.trim import accurate
    rs = slice_store().subset(np.arange(12))
    m4 = overlap_all_vs_all(rs, MapOptions(**SLICE_MAP), device="cpu")
    res = {}
    for d in ("cpu", dev):
        t0 = time.perf_counter()
        res[str(d)] = accurate.trim_reads_accurate(
            rs, m4, accurate.TrimAccurateOptions(min_ident=70.0), {"error": 0.3}, device=d)
        print(f"trim-accurate on {d}: {time.perf_counter() - t0:.1f} s, "
              f"{res[str(d)][0].n_reads} of {rs.n_reads} reads kept", flush=True)
    (ta, ka, ra), (tb, kb, rb) = res.values()
    if not (ta.names == tb.names and np.array_equal(ta.offsets, tb.offsets)
            and np.array_equal(ta.bases, tb.bases) and np.array_equal(ka, kb)
            and np.array_equal(ra, rb)):
        raise AssertionError("trim-accurate: cuda and cpu trimmed reads differ")
    if ta.n_reads < rs.n_reads // 2:
        raise AssertionError(f"trim-accurate: {ta.n_reads} of {rs.n_reads} reads kept")

    acc_cfg = os.path.join(WORK, "run_accurate.cfg")
    with open(cfg_path) as src, open(acc_cfg, "w") as dst:
        dst.write(src.read() + "\nTRIM_METHOD=accurate\n")
    res = _run_assemble(launch_counts, "trim-accurate", acc_cfg, genome)
    trim = res["stages"]["trim"]
    by_width = launch_counts["trim-accurate"]["by_width"]
    if not trim.get("cns_s") or not trim["pairs_by_band"]["cns"].get("128") or \
            any(not by_width.get((k, 128)) for k in ON_PATH):
        raise AssertionError(f"trim-accurate: the trim stage's consensus must run K1 and "
                             f"K3 at 128: {trim}, {_by_width(launch_counts['trim-accurate'])}")
    d_id, fast_id = res["identity_pct"]["draft"], fast["identity_pct"]["draft"]
    if d_id is None or d_id < fast_id - 0.5:
        raise AssertionError(f"trim-accurate: draft identity {d_id} < the fast trim's "
                             f"{fast_id} - 0.5")


def _content(path: str) -> bytes:
    """A file's bytes, decompressed if it is gzipped."""
    import gzip
    with (gzip.open if path.endswith(".gz") else open)(path, "rb") as f:
        return f.read()


def fasta_digest(path: str, skip=()) -> dict:
    """sha256 over a FASTA file's decompressed content, less the records
    whose name is in `skip`, and the file's record count."""
    import hashlib
    data = _content(path)
    n = data.count(b">")
    if skip:
        data = b"".join(b">" + rec for rec in data.split(b">")[1:]
                        if rec.partition(b"\n")[0].decode() not in skip)
    return {"sha256": hashlib.sha256(data).hexdigest(), "records": n}


def fasta_record_digests(path: str) -> list:
    """One "name length sha256[:16]" string per record of a FASTA file, in file
    order (the sequence's lines joined): places a difference between two runs'
    files."""
    import hashlib
    out = []
    for rec in _content(path).split(b">")[1:]:
        head, _, body = rec.partition(b"\n")
        seq = body.replace(b"\n", b"")
        out.append(f"{head.decode()} {len(seq)} {hashlib.sha256(seq).hexdigest()[:16]}")
    return out


def _same_as_phase10(prj: str, files, what: str) -> None:
    for f in files:
        if _content(os.path.join(prj, f)) != _content(os.path.join(PHASE10,
                                                                   os.path.basename(f))):
            raise AssertionError(f"{what}: {f} differs from phase 10's")


def _project_config(cfg_path: str, name: str, extra: str) -> tuple:
    """Phase 8's config with a fresh project directory WORK/<name> and
    `extra` lines appended; returns (its path, the project's)."""
    prj = os.path.join(WORK, name)
    shutil.rmtree(prj, ignore_errors=True)
    with open(cfg_path) as f:
        text = f.read().replace(f"PROJECT={os.path.join(WORK, 'project')}", f"PROJECT={prj}")
    path = os.path.join(WORK, f"{name}.cfg")
    with open(path, "w") as f:
        f.write(text + "\n" + extra)
    return path, prj


def check_small_memory(dev, launch_counts: dict, main_inputs, smi: str) -> None:
    """correct_reads of main's read set and candidates with small_memory=True
    (each supergroup uploads its own store): records identical to main's.
    The mode's correction time and peak memory beside a run without it."""
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.consensus import correct as correct_mod
    from necat_tpu_torch.consensus.options import CnsOptions
    store, _, call, want = main_inputs
    res = {}
    for mode in (False, True):
        stores = []
        make = correct_mod.DeviceReadStore
        correct_mod.DeviceReadStore = lambda st, d: stores.append(st.total_bases) or make(st, d)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if mode:
                bk.reset_launches()
            t0 = time.perf_counter()
            recs = correct_mod.correct_reads(store, call, CnsOptions(small_memory=mode),
                                             device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            correct_mod.DeviceReadStore = make
        if mode:
            launch_counts["small-memory"] = _launches(bk)
        _same_records(want, recs)
        res["on" if mode else "off"] = {
            "correction_s": wall,
            "peak_mem_mib": torch.cuda.max_memory_allocated() / 2**20,
            "device_stores": len(stores), "store_bases": stores}
    counts = launch_counts["small-memory"]
    print("small-memory " + json.dumps({**res, "launches": _by_width(counts), "card": smi}),
          flush=True)
    if res["off"]["device_stores"] != 1 or res["on"]["device_stores"] < 2:
        raise AssertionError("small-memory: each supergroup must upload a store of its own")
    missing = [k for k in ON_PATH if not counts["by_width"].get((k, 128))]
    if missing or any(k == "diag_sub_matrix" for (k, _), n in counts["by_width"].items() if n):
        raise AssertionError(f"small-memory: K1 and K3 must launch at 128 and K2 not: "
                             f"{_by_width(counts)}")
    print("small-memory: records identical to main's", flush=True)


def check_volumes(dev, launch_counts: dict, main_inputs, cfg_path: str, smi: str) -> None:
    """(a) candidates_by_volumes of main's read set in VOL_SIZE-base volumes
    equal main's untiled candidates, field for field and in order. (b) `cli
    assemble` with VOL_SIZE and POLISH_CONTIGS=false in a fresh project from
    phase 8's reads and config writes phase 10's cns_final, trimmed reads and
    contigs. Launches are counted over (a) and (b)."""
    import dataclasses as dc
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.overlap import overlapper
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.pipeline import cli
    store, cands, _, _ = main_inputs
    vols = store.volumes(VOL_SIZE)
    bk.reset_launches()
    overlapper.index_build_s.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiled = overlapper.candidates_by_volumes(store, MapOptions(), VOL_SIZE, device=dev)
    torch.cuda.synchronize()
    cand_s = time.perf_counter() - t0
    index_s = list(overlapper.index_build_s)
    for f in dc.fields(cands):
        if not np.array_equal(getattr(cands, f.name), getattr(tiled, f.name)):
            raise AssertionError(f"volumes: candidate field {f.name} differs from main's")
    path, prj = _project_config(cfg_path, "project_vol",
                                f"VOL_SIZE={VOL_SIZE}\nPOLISH_CONTIGS=false\n")
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    rc = cli.main(["assemble", path, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launch_counts["volumes"] = counts = _launches(bk)
    if rc != 0:
        raise AssertionError(f"volumes: the command line exited {rc}")
    print("volumes " + json.dumps({
        "volumes": vols, "candidates": len(tiled), "candidates_s": cand_s,
        "index_build_s": index_s, "assemble_wall_s": wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "stages": _stage_reports(prj), "launches": _by_width(counts), "card": smi}),
        flush=True)
    if len(vols) < 3 or len(index_s) != len(vols):
        raise AssertionError(f"volumes: {len(vols)} volumes, {len(index_s)} index builds")
    missing = [k for k in ON_PATH if not counts["by_width"].get((k, 128))]
    if missing or any(k == "diag_sub_matrix" for (k, _), n in counts["by_width"].items() if n):
        raise AssertionError(f"volumes: K1 and K3 must launch at 128 and K2 not: "
                             f"{_by_width(counts)}")
    _same_as_phase10(prj, PHASE10_FILES[:3], "volumes")
    print("volumes: candidates equal main's; cns_final, trimmed reads and contigs equal "
          "phase 10's", flush=True)


def check_stripes(cfg_path: str, smi: str, timeout: int = 600) -> None:
    """Two processes of `cli assemble --device cuda` on the one card, joined
    through a coordinator on 127.0.0.1 (gloo), in a fresh project from phase
    8's reads and config: correct and polish striped, trim and assemble on
    process 0. cns_final and the polished contigs must equal phase 10's; the
    processes' pairs per band come from the manifests."""
    import socket
    path, prj = _project_config(cfg_path, "project_mp", "")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    # the two processes split the host's cores between their torch threads
    env = {**os.environ, "PYTHONPATH": root, "NECAT_TPU_COORDINATOR": f"127.0.0.1:{port}",
           "NECAT_TPU_NUM_PROCS": "2",
           "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 2) // 2))}
    logs = [os.path.join(WORK, f"stripes.process{p}.log") for p in range(2)]
    # this process's allocator still holds the blocks of the earlier phases
    # (~78 GiB): hand them back, or the two processes find the card full
    torch.cuda.empty_cache()
    reserved_gib = torch.cuda.memory_reserved() / 2**30
    t0 = time.perf_counter()
    procs = []
    for p in range(2):
        with open(logs[p], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "necat_tpu_torch.pipeline.cli", "assemble", path,
                 "--device", "cuda"], cwd=root, env={**env, "NECAT_TPU_PROC_ID": str(p)},
                stdout=log, stderr=subprocess.STDOUT))
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break                      # one failed: the other is stopped below
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"stripes: the processes ran past {timeout} s")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        for i, (p, log) in enumerate(zip(procs, logs)):
            with open(log) as f:
                print(f"stripes: process {i} exited {p.returncode}; log tail:\n"
                      + f.read()[-3000:], flush=True)
        raise AssertionError(f"stripes: exit codes {[p.returncode for p in procs]}")
    stages = _stage_reports(prj)
    by_proc = {
        "correct": [[it["pairs_by_band"] for it in r["iterations"]]
                    for r in stages["correct"]["by_process"]],
        "trim": stages["trim"]["pairs_by_band"],
        "polish": [r["pairs_by_band"] for r in stages["polish"]["by_process"]]}
    print("stripes " + json.dumps({"wall_s": wall, "parent_reserved_gib": reserved_gib,
                                   "stages": stages, "pairs_by_band": by_proc, "card": smi}),
          flush=True)
    if not all(its[0].get("128") for its in by_proc["correct"]) or \
            not by_proc["trim"]["overlap"].get("128") or not by_proc["polish"][0].get("256"):
        raise AssertionError(f"stripes: each process's correct, process 0's trim at 128 and "
                             f"polish at {POLISH_W} must extend pairs: {by_proc}")
    _same_as_phase10(prj, (PHASE10_FILES[0], PHASE10_FILES[3]), "stripes")
    print("stripes: cns_final and polished contigs equal phase 10's", flush=True)


def ecoli_volume(genome_size: int, coverage: int, min_len: int, max_len: int,
                 sub: float, seed: int):
    """Reads of a random genome at `coverage`: uniform lengths and starts,
    either strand, `sub` of the bases substituted (the k-mer index sees no
    indels); made with numpy from `seed`."""
    from necat_tpu_torch.io.readstore import ReadStore
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_size, dtype=np.uint8)
    reads, total = [], 0
    while total < coverage * genome_size:
        n = int(rng.integers(min_len, max_len + 1))
        s0 = int(rng.integers(0, genome_size - n))
        r = genome[s0:s0 + n].copy()
        if rng.random() < 0.5:
            r = (3 - r[::-1]).astype(np.uint8)
        hit = rng.random(n) < sub
        r[hit] = (r[hit] + rng.integers(1, 4, int(hit.sum()), dtype=np.uint8)) & 3
        reads.append(r)
        total += n
    return ReadStore.from_seqs(reads)


def _timed_build(dev, build):
    """(index, seconds to a synchronised end, peak device GiB) of build()."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = build()
    torch.cuda.synchronize()
    return index, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def _same_index(a, b, what: str) -> None:
    for f in ("sorted_hashes", "sorted_positions", "bucket_starts", "run_end"):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{what}: {f} of the device build differs from the host's")
    if a.n_search_steps != b.n_search_steps:
        raise AssertionError(f"{what}: n_search_steps {a.n_search_steps} != {b.n_search_steps}")


def check_index(dev, launch_counts: dict, main_inputs, smi: str) -> None:
    """(a) The bench set's index built on the card equals the host build;
    (b) main's search through the gate and with the host-built index give
    main's candidates; (c) the same build equality on an E. coli-scale
    volume. Seconds and peaks of both builds."""
    import dataclasses as dc
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.index.kmer_index import KmerIndex
    from necat_tpu_torch.io.devstore import DeviceReadStore
    from necat_tpu_torch.overlap import overlapper
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.utils import shapes
    store, cands, _, _ = main_inputs
    bk.reset_launches()
    res = {}
    vol = None
    for name in ("bench", "ecoli"):
        if name == "ecoli":
            t0 = time.perf_counter()
            vol = store = ecoli_volume(**ECOLI_VOLUME)
            res["ecoli_made_s"] = time.perf_counter() - t0
        if store.total_bases > shapes.DEVICE_INDEX_MAX_BASES:
            raise AssertionError(f"index: {store.total_bases} bases exceed the device gate")
        packed, up_s, _ = _timed_build(dev, lambda: DeviceReadStore(store, dev))
        on_card, dev_s, dev_peak = _timed_build(
            dev, lambda: KmerIndex.build_on_device(packed, device=dev))
        on_host, host_s, host_peak = _timed_build(
            dev, lambda: KmerIndex.build(store.bases, store.offsets, device=dev))
        _same_index(on_card, on_host, f"index ({name})")
        res[name] = {"reads": store.n_reads, "bases": int(store.total_bases),
                     "kmers": int(on_card.sorted_hashes.numel()),
                     "pack_upload_s": up_s, "device_build_s": dev_s,
                     "device_peak_gib": dev_peak, "host_build_upload_s": host_s,
                     "host_peak_gib": host_peak}
        if name == "bench":
            calls = []
            build = KmerIndex.__dict__["build_on_device"]
            KmerIndex.build_on_device = classmethod(
                lambda cls, *a, **kw: calls.append(1) or build.__func__(cls, *a, **kw))
            try:
                overlapper.index_build_s.clear()
                t0 = time.perf_counter()
                gated = overlapper.find_all_candidates(store, store, MapOptions(), True,
                                                       device=dev)
                res["bench"]["search_device_index_s"] = time.perf_counter() - t0
                res["bench"]["search_index_build_s"] = list(overlapper.index_build_s)
            finally:
                KmerIndex.build_on_device = build
            t0 = time.perf_counter()
            hosted = overlapper.find_all_candidates(store, store, MapOptions(), True,
                                                    device=dev, index=on_host)
            res["bench"]["search_host_index_s"] = time.perf_counter() - t0
            if calls != [1]:
                raise AssertionError(f"index: the search built on the card {len(calls)} times")
            for c, what in ((gated, "device-built"), (hosted, "host-built")):
                for f in dc.fields(cands):
                    if not np.array_equal(getattr(c, f.name), getattr(cands, f.name)):
                        raise AssertionError(f"index: {what} search's {f.name} differs "
                                             "from main's")
        del packed, on_card, on_host
    del vol
    launch_counts["index"] = _launches(bk)
    print("index " + json.dumps({**res, "card": smi}), flush=True)
    print("index: device builds equal the host builds (bench and E. coli scale); main's "
          "search gives main's candidates with either index", flush=True)


def check_devices(dev, launch_counts: dict, main_inputs, cfg_path: str, smi: str) -> None:
    """Two shards on the card (or one on each card): (a) main's candidates
    and records, (b) the slice set's overlaps, (c) `cli correct` with the
    list writes phase 8's cns_final."""
    import dataclasses as dc
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.consensus.options import CnsOptions
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.overlap.overlapper import find_all_candidates, overlap_all_vs_all
    from necat_tpu_torch.pipeline import cli
    n_cards = torch.cuda.device_count()
    devs = ([torch.device("cuda", i) for i in range(n_cards)] if n_cards > 1
            else [dev, dev])
    spec = ",".join(str(d) for d in devs)
    store, cands, call, want = main_inputs
    pinned = CnsOptions(buckets_per_supergroup=len(devs))
    secs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    # the one-device run first, in the same conditions, for the seconds
    timed("one_device_candidates_s",
          lambda: find_all_candidates(store, store, MapOptions(), True, device=dev))
    one = timed("one_device_correct_s", lambda: correct_reads(store, call, pinned, device=dev))
    slice_rs = slice_store()
    mo = MapOptions(**SLICE_MAP)
    m4_one = overlap_all_vs_all(slice_rs, mo, device=dev)
    bk.reset_launches()
    got = timed("candidates_s",
                lambda: find_all_candidates(store, store, MapOptions(), True, device=devs))
    recs = timed("correct_s", lambda: correct_reads(store, call, pinned, device=devs))
    m4 = overlap_all_vs_all(slice_rs, mo, device=devs)
    path, prj = _project_config(cfg_path, "project_dev", "")
    t3 = time.perf_counter()
    rc = cli.main(["correct", path, "--device", spec])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t3
    launch_counts["devices"] = counts = _launches(bk)
    with open(os.path.join(prj, "1-consensus", "correct.done.json")) as f:
        manifest = json.load(f)
    print("devices " + json.dumps({
        "devices": spec, "distinct_cards": len(set(devs)), **secs, "cli_correct_s": cli_s, "manifest_devices": manifest["devices"],
        "records_equal_main": [(r.tid, r.left, r.right) for r in recs]
        == [(r.tid, r.left, r.right) for r in want],
        "launches": _by_width(counts), "card": smi}), flush=True)
    for f in dc.fields(cands):
        if not np.array_equal(getattr(got, f.name), getattr(cands, f.name)):
            raise AssertionError(f"devices: candidate field {f.name} differs from main's")
    _same_records(one, recs)
    for f in dc.fields(m4):
        if not np.array_equal(getattr(m4, f.name), getattr(m4_one, f.name)):
            raise AssertionError(f"devices: M4 field {f.name} differs from one device's")
    if rc != 0:
        raise AssertionError(f"devices: the command line exited {rc}")
    missing = [k for k in ON_PATH if not counts["by_width"].get((k, 128))]
    if missing or any(k == "diag_sub_matrix" for (k, _), n in counts["by_width"].items() if n):
        raise AssertionError(f"devices: K1 and K3 must launch at 128 and K2 not: "
                             f"{_by_width(counts)}")
    _same_as_phase10(prj, PHASE10_FILES[:1], "devices")
    print(f"devices: {len(set(devs))} distinct card(s), {len(devs)} shards: candidates "
          "equal main's, records a one-device run's, M4 rows one device's, cns_final "
          "phase 8's", flush=True)


def check_timing(dev, launch_counts: dict, main_inputs, smi: str) -> None:
    """Main's search and correction with the timing scopes on, then on with
    NECAT_TPU_SYNC_DISPATCH: records equal main's both times; the report,
    the wall, the top-level scopes' share of it and the *exec* totals."""
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.consensus.options import CnsOptions
    from necat_tpu_torch.overlap.candidates import Candidates
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.overlap.overlapper import find_all_candidates
    from necat_tpu_torch.utils import logging as tlog
    store, cands, _, want = main_inputs
    res = {}
    tlog.TIMING_ON = True
    try:
        for mode in ("timed", "sync"):
            if mode == "sync":
                os.environ["NECAT_TPU_SYNC_DISPATCH"] = "1"
            torch.cuda.synchronize()
            tlog.reset_timers()
            bk.reset_launches()
            t0 = time.perf_counter()
            got = find_all_candidates(store, store, MapOptions(), pairwise=True, device=dev)
            recs = correct_reads(store, Candidates.concat([got, got.swap_roles()]),
                                 CnsOptions(), device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            report = tlog.timing_report(ndigits=None)
            launch_counts["timing" if mode == "timed" else "timing-sync"] = counts = _launches(bk)
            for f in dataclasses.fields(cands):
                if not np.array_equal(getattr(got, f.name), getattr(cands, f.name)):
                    raise AssertionError(f"timing ({mode}): candidate field {f.name} differs "
                                         "from main's")
            _same_records(want, recs)
            missing = [k for k in MAIN_SCOPES if k not in report]
            execs = {k: v for k, v in report.items() if "exec" in k}
            if mode == "sync" and ("cand.exec" not in execs or not any(
                    k.startswith("cns.fused_exec_L") for k in execs)):
                missing.append("cand.exec and cns.fused_exec_L*")
            if missing or (mode == "timed" and execs):
                raise AssertionError(f"timing ({mode}): scopes missing {missing}, "
                                     f"*exec* {sorted(execs)}")
            if (any(not counts["by_width"].get((k, 128)) for k in ON_PATH)
                    or any(n for (k, _), n in counts["by_width"].items()
                           if k == "diag_sub_matrix")):
                raise AssertionError(f"timing ({mode}): K1 and K3 must launch at 128 and K2 "
                                     f"not: {_by_width(counts)}")
            top = sum(report[k][0] for k in TOP_LEVEL_SCOPES)
            res[mode] = {"wall_s": wall, "top_level_s": top, "top_level_share": top / wall,
                         "lanes": {k: report[k][0] for k in
                                   ("ext.lanes", "ext.real_lanes", "ext.cell_Mlanes")},
                         "report": report}
            if mode == "sync":
                res[mode]["exec_s"] = sum(v[0] for v in execs.values())
                res[mode]["exec"] = execs
    finally:
        tlog.TIMING_ON = False
        os.environ.pop("NECAT_TPU_SYNC_DISPATCH", None)
        tlog.reset_timers()
    print("timing " + json.dumps({**res, "card": smi}), flush=True)
    print(f"timing: records equal main's with the scopes on and with the synchronised "
          f"dispatch; top-level scopes {res['timed']['top_level_share']:.1%} of "
          f"{res['timed']['wall_s']:.3f} s", flush=True)


def _timed_once(fn):
    """(fn's output, its milliseconds on the card by CUDA events), one call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare_adaptive(a, b, la, lb, W: int, k3_words=(1,), inputs: str = "kernel_pairs"
                     ) -> dict:
    """K1a and K3a (at each insb word count in k3_words) against their plain
    versions on these pairs: exact equality. The plain versions, one launch
    per torch op and column, run once each, timed. Rows keyed (kernel, W,
    words) for kernel_pairs, (kernel, W, words, inputs) for a path's launch."""
    from necat_tpu_torch.align import banded_kernels as bk
    PB, L = a.shape
    fwd = (lambda: bk.banded_forward_adaptive(a, b, la, lb, W),
           lambda: bk.banded_forward_adaptive_ref(a, b, la, lb, W))
    dirs, offs, _, _ = fwd[0]()
    steps = {("banded_forward_adaptive", None): fwd}
    for w in k3_words:
        steps[("adaptive_backtrack_cols", w)] = (
            lambda w=w: bk.adaptive_backtrack_cols(dirs, offs, a, b, la, lb, W, w),
            lambda w=w: bk.adaptive_backtrack_cols_ref(dirs, offs, a, b, la, lb, W, w))
    results = {}
    for (name, words), (kernel, plain) in steps.items():
        got = kernel()
        want, plain_ms = _timed_once(plain)
        err = _max_abs_err(got, want)
        ms = _time_ms(kernel, 5)
        key = (name, W, words) if inputs == "kernel_pairs" else (name, W, words, inputs)
        results[key] = {**_kernel_row(
            name, W, words, PB, L, err, ms, plain_ms,
            bound(name, a, b, lb, W, got[0] if words else None, words or 1, la), inputs),
            "Lb": b.shape[1]}
    return results


class AdaptiveShapes:
    """While entered, wraps banded_kernels' K1a and K3a wrappers (which still
    count their launches) to record the shape of each call on the card:
    `shapes` counts (kernel, W, words, PB, L, Lb), and `widest` keeps, per
    (W, words), K3a's inputs (a, b, la, lb) of the call with the longest
    rows (L, then Lb, then PB), so that the kernels can be held to their
    plain versions at the shapes a path gave them."""

    def __init__(self):
        self.shapes = collections.Counter()
        self.widest = {}

    def __enter__(self):
        from necat_tpu_torch.align import banded_kernels as bk
        self.bk = bk
        self.fwd, self.back = bk.banded_forward_adaptive, bk.adaptive_backtrack_cols

        def fwd(a, b, la, lb, W, max_cols=None):
            if a.is_cuda and a.shape[0]:
                self.shapes[("banded_forward_adaptive", W, None, *a.shape, b.shape[1])] += 1
            return self.fwd(a, b, la, lb, W, max_cols)

        def back(dirs, offs, a, b, la, lb, W, words=1):
            if a.is_cuda and a.shape[0]:
                self.shapes[("adaptive_backtrack_cols", W, words, *a.shape, b.shape[1])] += 1
                size = (a.shape[1], b.shape[1], a.shape[0])
                if size > self.widest.get((W, words), ((0,), None))[0]:
                    self.widest[(W, words)] = (size, [t.clone() for t in (a, b, la, lb)])
            return self.back(dirs, offs, a, b, la, lb, W, words)

        bk.banded_forward_adaptive, bk.adaptive_backtrack_cols = fwd, back
        return self

    def __exit__(self, *exc):
        self.bk.banded_forward_adaptive, self.bk.adaptive_backtrack_cols = self.fwd, self.back

    def lines(self) -> dict:
        """"K1a|K3a W=.. [words=..] PB=.. L=.. Lb=..": calls."""
        return {f"{'K1a' if name == ADAPTIVE[0] else 'K3a'} W={W}"
                + (f" words={words}" if words else "") + f" PB={PB} L={L} Lb={Lb}": n
                for (name, W, words, PB, L, Lb), n in sorted(
                    self.shapes.items(), key=lambda kv: str(kv[0]))}


def check_adaptive(dev, launch_counts: dict, main_inputs, smi: str,
                   dump: str | None = None) -> dict:
    """K1a and K3a against their plain versions at every width of
    KERNEL_WIDTHS; then main's search and correction again with
    NECAT_TPU_NO_PALLAS (the adaptive band): records held to the JAX
    package's default CPU run of the same inputs (JAX_CPU_MAIN_REFERENCE),
    K1a and K3a launched and K1, K2 and K3 not. Returns the kernel rows and
    the records."""
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.consensus.options import CnsOptions
    from necat_tpu_torch.overlap.candidates import Candidates
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.overlap.overlapper import find_all_candidates
    t_phase = time.perf_counter()
    kernels = {}
    for W in bk.KERNEL_WIDTHS:
        kernels.update(compare_adaptive(
            *kernel_pairs(dev, W, L=8192 if W == 128 else ADAPTIVE_L), W,
            k3_words=(1, POLISH_WORDS) if W == POLISH_W else (1,)))
    checks_s = time.perf_counter() - t_phase
    store, main_cands, _, _ = main_inputs
    os.environ["NECAT_TPU_NO_PALLAS"] = "1"
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bk.reset_launches()
        t0 = time.perf_counter()
        cands = find_all_candidates(store, store, MapOptions(), pairwise=True, device=dev)
        call = Candidates.concat([cands, cands.swap_roles()])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        recs = correct_reads(store, call, CnsOptions(), device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launch_counts["adaptive"] = counts = _launches(bk)
    finally:
        os.environ.pop("NECAT_TPU_NO_PALLAS", None)
    ncorr = len({r.tid for r in recs if r.corrected})
    digest = records_digest(recs)
    if dump:
        dump_records(recs, dump)
    print("adaptive " + json.dumps({
        "candidates": len(cands), "records": len(recs), "corrected_reads": ncorr,
        "digest": digest, "candidates_s": t1 - t0,
        "correct_s": t2 - t1, "wall_s": t2 - t0, "corrected_reads_per_s": ncorr / (t2 - t0),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": _by_width(counts), "kernel_checks_s": checks_s,
        "phase_s": time.perf_counter() - t_phase, "card": smi}), flush=True)
    for f in dataclasses.fields(main_cands):
        if not np.array_equal(getattr(cands, f.name), getattr(main_cands, f.name)):
            raise AssertionError(f"adaptive: candidate field {f.name} differs from main's")
    ran = {k for (k, _), n in counts["by_width"].items() if n}
    if ran != set(ADAPTIVE) or not all(counts["by_width"].get((k, 128)) for k in ADAPTIVE):
        raise AssertionError(f"adaptive: K1a and K3a must launch at 128 and no other kernel: "
                             f"{_by_width(counts)}")
    ref = JAX_CPU_MAIN_REFERENCE
    rest = records_digest(recs, skip=MAIN_TIE_FLIPS)
    flips = {str(r.tid): [r.left, r.right, len(r.seq)] for r in recs
             if r.tid in MAIN_TIE_FLIPS}
    print("adaptive reference " + json.dumps({
        "digest_equal": digest == ref["digest"],
        "digest_without_tie_flips": rest, "tie_flips": flips}), flush=True)
    if (ncorr, rest) != (ref["corrected_reads"], ref["digest_without_tie_flips"]):
        raise AssertionError(f"adaptive: {ncorr} reads, digest without the tie flips {rest}; "
                             f"the JAX package's CPU run: {ref}")
    for tid, (left, right, n) in ref["tie_flips"].items():
        got = flips.get(tid)
        if got is None or got[:2] != [left, right] or abs(got[2] - n) > 1:
            raise AssertionError(f"adaptive: template {tid}: {got}; the JAX package's "
                                 f"record: {[left, right, n]}")
    print(f"adaptive: K1a and K3a equal their plain versions at {bk.KERNEL_WIDTHS}; main's "
          f"records equal the JAX package's default CPU run but for the float32 tie of "
          f"template(s) {MAIN_TIE_FLIPS} (digest {digest[:16]})", flush=True)
    return kernels, recs


def adaptive_ratios(kernels: dict, W: int = 128) -> dict:
    """K1a/K1 and K3a/K3 (1 insb word) at width W from the kernel rows, all
    timed on the same kernel_pairs chunk (L=8192); printed on one line."""
    pairs = {"K1a/K1": ("banded_forward_adaptive", "banded_forward", None),
             "K3a/K3": ("adaptive_backtrack_cols", "banded_backtrack_cols", 1)}
    out = {}
    for what, (adaptive, static, words) in pairs.items():
        ka, ks = kernels[(adaptive, W, words)], kernels[(static, W, words)]
        if (ka["L"], ka["PB"]) != (ks["L"], ks["PB"]):
            raise AssertionError(f"{what}: rows of different chunks")
        out[what] = ka["ms"] / ks["ms"]
        out[what.split("/")[0] + "_ms"], out[what.split("/")[1] + "_ms"] = ka["ms"], ks["ms"]
    print(f"adaptive/static W={W} " + json.dumps(out), flush=True)
    return out


def _tie_verdict(key: str, path: str, got: dict, want: dict) -> str:
    """"equal" where a file's digest is the reference's; "equal but the
    ties" where it differs only in PIPELINE_TIES[key]'s records, each as
    documented (the rest's digest is the reference's sha256_without_ties);
    else "differs"."""
    if got == {k: want.get(k) for k in ("sha256", "records")}:
        return "equal"
    ties = PIPELINE_TIES.get(key, {})
    names = {t.split()[0] for t in ties}
    if ties and got["records"] == want["records"] and \
            set(ties) <= set(fasta_record_digests(path)) and \
            fasta_digest(path, skip=names)["sha256"] == want["sha256_without_ties"]:
        return "equal but the ties"
    return "differs"


def check_adaptive_pipeline(dev, launch_counts: dict, cfg_path: str, genome, smi: str) -> dict:
    """With NECAT_TPU_NO_PALLAS set: (a) `cli assemble` and then `cli bridge`
    --device cuda in a fresh project from phase 8's config (correct, trim,
    assemble, polish; bridge, polish again); (b) phase 11b's bridge_contigs
    of the five bench contigs on the card; (c) phase 7's planted insertions
    through extend_candidates and correct_reads(rescue_long_indels=True) on
    the card. Every stage file, (b)'s contigs written as FASTA, and (c)'s M4
    and records must equal the JAX package's own CPU run
    (JAX_CPU_PIPELINE_REFERENCE, JAX_CPU_BRIDGE_DIGEST,
    JAX_CPU_LADDER_REFERENCE) by their digests, but for the records of
    PIPELINE_TIES: cns_final's template 199, a float32 tie of the reference,
    whose name trim keeps. There the rest of the file must equal the
    reference and the record be the documented one. (The JAX package's trim
    run on the port's cns_final writes the port's trimReads exactly:
    scripts/jax_pipeline_reference.py --cns-final.) K1a and K3a must launch at
    128 and 256 (K3a also with POLISH_WORDS insb words) in (a) and (b), and
    at every rung of RUNGS in (c), where alone the adaptive band leaves pairs
    hanging (in (a) and (b) none reaches the ladder, as in the reference);
    K1, K2 and K3 never. The shape (PB, L, Lb) of every K1a and K3a call is
    recorded by path (AdaptiveShapes), and at each (W, insb words) that the
    phase launched, K1a and K3a are held to their plain versions on the
    inputs of its call with the longest rows. Returns those kernel rows."""
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.bridge import bridge
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.consensus.options import CnsOptions
    from necat_tpu_torch.io.readstore import ReadStore
    from necat_tpu_torch.overlap.candidates import Candidates
    from necat_tpu_torch.overlap.overlapper import extend_candidates
    from necat_tpu_torch.pipeline import cli
    from necat_tpu_torch.utils.benchdata import gen_benchmark_reads
    t_phase = time.perf_counter()
    path, prj = _project_config(cfg_path, "project_adaptive", "")
    after_assemble = os.path.join(WORK, "adaptive_polished_assemble.fasta")
    bench_fasta = os.path.join(WORK, "adaptive_bridged_bench.fasta")
    _, store, _ = gen_benchmark_reads(genome_size=200_000, coverage=20, seed=7)
    contigs = ReadStore.from_seqs(*bridge_bench_contigs(genome))
    planted, pcands = planted_pairs()
    walls, shapes = {}, {}

    def timed(what, fn):
        bk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with AdaptiveShapes() as shapes[what]:
            out = fn()
        torch.cuda.synchronize()
        walls[what] = time.perf_counter() - t0
        launch_counts[f"adaptive-{what}"] = _launches(bk)
        return out

    if os.path.exists(after_assemble):
        os.remove(after_assemble)
    os.environ["NECAT_TPU_NO_PALLAS"] = "1"
    try:
        paths, _, stages = timed("pipeline", lambda: run_pipeline(
            cli, path, prj, after_assemble, device="cuda"))
        out = timed("bridge", lambda: bridge.bridge_contigs(contigs, store, device=dev))
        m4, recs = timed("ladder", lambda: (
            extend_candidates(pcands, planted, planted, device=dev),
            correct_reads(planted, Candidates.concat([pcands, pcands.swap_roles()]),
                          CnsOptions(rescue_long_indels=True), device=dev)))
    finally:
        os.environ.pop("NECAT_TPU_NO_PALLAS", None)
    out.to_fasta(bench_fasta)
    paths = {**paths, "bench_bridged": bench_fasta}
    want = {**JAX_CPU_PIPELINE_REFERENCE["files"], "bench_bridged": JAX_CPU_BRIDGE_DIGEST}
    got = {k: fasta_digest(p) for k, p in paths.items()}
    verdict = {k: _tie_verdict(k, p, got[k], want.get(k, {})) for k, p in paths.items()}
    ladder = {"m4": m4_digest(m4), "records": records_digest(recs)}
    for k, v in ladder.items():
        verdict[f"ladder_{k}"] = "equal" if v == JAX_CPU_LADDER_REFERENCE[k] else "differs"
    with open(os.path.join(WORK, "adaptive_record_digests.json"), "w") as f:
        json.dump({k: fasta_record_digests(p) for k, p in paths.items()}, f, indent=0)
    draft = ReadStore.from_fasta(paths["contigs"])
    polished = ReadStore.from_fasta(paths["polished_assemble"])
    ident = {k: contig_identity(st, genome)[0] for k, st in (("draft", draft),
                                                              ("polished", polished))}
    counts = {k: launch_counts[f"adaptive-{k}"] for k in ("pipeline", "bridge", "ladder")}
    res = {"walls_s": walls, "stages_s": stages, "verdict": verdict,
           "digests": {**{k: v["sha256"][:16] for k, v in got.items()},
                       **{f"ladder_{k}": v[:16] for k, v in ladder.items()}},
           "records": {k: v["records"] for k, v in got.items()},
           "contigs": draft.n_reads, "contig_n50": draft.n50()[0],
           "draft_identity": ident["draft"], "polished_identity": ident["polished"],
           "launches": {k: _by_width(c) for k, c in counts.items()},
           "k3a_by_words": {k: {f"{w}x{n_w}": n for (w, n_w), n in
                                sorted(c["k3a_by_words"].items())} for k, c in counts.items()},
           "shapes": {k: v.lines() for k, v in shapes.items()},
           "phase_s": time.perf_counter() - t_phase,
           "jax_cpu_reference": JAX_CPU_ASSEMBLY_REFERENCE, "card": smi}
    print("adaptive-pipeline " + json.dumps(res), flush=True)
    stages_w = counts["pipeline"]["by_width"] + counts["bridge"]["by_width"]
    ladder_w = counts["ladder"]["by_width"]
    static = {(k, w): n for c in counts.values() for (k, w), n in c["by_width"].items()
              if k not in ADAPTIVE and n}
    missing = [(k, w) for k in ADAPTIVE for w in (128, POLISH_W) if not stages_w.get((k, w))]
    missing += [(k, w) for k in ADAPTIVE for w in RUNGS if not ladder_w.get((k, w))]
    if static or missing or not counts["pipeline"]["k3a_by_words"].get((POLISH_W,
                                                                        POLISH_WORDS)):
        raise AssertionError(
            f"adaptive-pipeline: K1a and K3a must launch at 128 and {POLISH_W} (K3a also "
            f"with {POLISH_WORDS} words) on the stages and at {RUNGS} on the ladder, "
            f"K1/K2/K3 never; missing {missing}, static {static}")
    differ = [k for k, v in verdict.items() if not v.startswith("equal")]
    if differ:
        raise AssertionError(f"adaptive-pipeline: {differ} differ from the JAX package's "
                             f"CPU run (record digests in {WORK}/adaptive_record_digests.json)")
    ref = JAX_CPU_ASSEMBLY_REFERENCE
    if (draft.n_reads, draft.n50()[0], round(ident["draft"], 3),
            round(ident["polished"], 3)) != (ref["contigs"], ref["contig_n50"],
                                             ref["draft_identity"], ref["polished_identity"]):
        raise AssertionError(f"adaptive-pipeline: contigs {res} differ from {ref}")
    print(f"adaptive-pipeline: every file equals the JAX package's CPU run "
          f"({json.dumps(verdict)})", flush=True)
    # K1a and K3a against their plain versions on the longest call of each
    # (W, words) of the three paths
    widest = {}
    for what, rec in shapes.items():
        for key, (size, inputs) in rec.widest.items():
            if size > widest.get(key, ((0,),))[0]:
                widest[key] = (size, inputs, f"adaptive-{what}")
    t0 = time.perf_counter()
    kernels = {}
    for (W, words), (_, inputs, what) in sorted(widest.items()):
        kernels.update(compare_adaptive(*inputs, W, (words,), what))
    print(f"adaptive-pipeline: K1a and K3a equal their plain versions on the longest "
          f"call of each of {sorted(widest)} (W, insb words) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return kernels


def check_legacy(dev, launch_counts: dict, main_inputs, adaptive_recs, cfg_path: str,
                 smi: str) -> dict:
    """The legacy two-program correction on the card against the fused
    flow, each case timed beside a fused run of the same inputs: (a) main's
    inputs, (b) with rescue_long_indels, (c) with NECAT_TPU_NO_PALLAS (its
    records against phase 20's `adaptive_recs`), (d) `cli correct` with
    NECAT_TPU_FUSED=0 in a fresh project from phase 8's config against
    phase 8's cns_final. Records and files must be equal, with no tie
    allowance. Returns the printed summary."""
    from necat_tpu_torch.align import banded_kernels as bk
    from necat_tpu_torch.consensus import correct as correct_mod
    from necat_tpu_torch.consensus.options import CnsOptions
    from necat_tpu_torch.pipeline import cli
    t_phase = time.perf_counter()
    store, _, call, main_recs = main_inputs
    res, recs = {}, {}
    spliced = []
    splice = correct_mod.splice_rescue

    def run(what, opts, env=()):
        """correct_reads of main's inputs with opts (and env set), timed,
        its peak and, for a legacy run, its launches under `what`."""
        os.environ.update(env)
        correct_mod.splice_rescue = lambda *a: spliced.append(splice(*a)) or spliced[-1]
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            bk.reset_launches()
            t0 = time.perf_counter()
            recs[what] = correct_mod.correct_reads(store, call, opts, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            correct_mod.splice_rescue = splice
            for k in env:
                os.environ.pop(k, None)
        if what.startswith("legacy"):
            launch_counts[what] = _launches(bk)
        ncorr = len({r.tid for r in recs[what] if r.corrected})
        res[what] = {"correct_s": wall, "corrected_reads": ncorr,
                     "corrected_reads_per_s": ncorr / wall,
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}

    no_pallas = {"NECAT_TPU_NO_PALLAS": "1"}
    for what, opts, env in (("fused", CnsOptions(), {}),
                            ("legacy", CnsOptions(fused=False), {}),
                            ("fused-rescue", CnsOptions(rescue_long_indels=True), {}),
                            ("legacy-rescue", CnsOptions(rescue_long_indels=True, fused=False),
                             {}),
                            ("fused-adaptive", CnsOptions(), no_pallas),
                            ("legacy-adaptive", CnsOptions(fused=False), no_pallas)):
        run(what, opts, env)
    res["legacy-rescue"]["lanes_spliced"] = sum(spliced)
    # (d) the command line in a fresh project, the mode from the environment
    path, prj = _project_config(cfg_path, "project_legacy", "")
    os.environ["NECAT_TPU_FUSED"] = "0"
    try:
        bk.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli.main(["correct", path, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("NECAT_TPU_FUSED", None)
    launch_counts["legacy-cli"] = _launches(bk)
    manifests = {}
    for key, p in (("fused", os.path.join(WORK, "project")), ("legacy", prj)):
        with open(os.path.join(p, "1-consensus", "correct.done.json")) as f:
            manifests[key] = [{k: it[k] for k in ("candidates_s", "correct_s",
                                                  "pairs_by_band")}
                              for it in json.load(f)["iterations"]]
    final = os.path.join(prj, PHASE10_FILES[0])
    digests = {"legacy": fasta_digest(final) if rc == 0 else None,
               "phase 8": fasta_digest(os.path.join(PHASE10,
                                                    os.path.basename(PHASE10_FILES[0])))}
    res["legacy-cli"] = {"wall_s": wall, "peak_mem_gib": torch.cuda.max_memory_allocated()
                         / 2**30, "iterations": manifests, "cns_final": digests}
    legacy_paths = ("legacy", "legacy-rescue", "legacy-adaptive", "legacy-cli")
    summary = {**res, "launches": {k: _by_width(launch_counts[k]) for k in legacy_paths},
               "phase_s": time.perf_counter() - t_phase, "card": smi}
    print("legacy " + json.dumps(summary), flush=True)
    for a, b, what in (("legacy", "fused", "(a) against the fused rerun"),
                       ("fused", None, "(a) fused rerun against main"),
                       ("legacy-rescue", "fused-rescue", "(b)"),
                       ("legacy-adaptive", None, "(c) against phase 20"),
                       ("fused-adaptive", None, "(c) fused rerun against phase 20")):
        want = recs[b] if b else (adaptive_recs if "adaptive" in a else main_recs)
        try:
            _same_records(recs[a], want)
        except AssertionError:
            raise AssertionError(f"legacy {what}: {record_differences(recs[a], want)}"
                                 ) from None
    if rc != 0:
        raise AssertionError(f"legacy (d): the command line exited {rc}")
    if digests["legacy"] != digests["phase 8"]:
        raise AssertionError(f"legacy (d): cns_final {digests['legacy']} differs from "
                             f"phase 8's {digests['phase 8']}")
    for what in legacy_paths:
        ran = {k for (k, _), n in launch_counts[what]["by_width"].items() if n}
        want = set(ADAPTIVE if what == "legacy-adaptive" else ON_PATH)
        if ran != want or not all(launch_counts[what]["by_width"].get((k, 128)) for k in want):
            raise AssertionError(f"legacy: {what} must launch {sorted(want)} at 128 and no "
                                 f"other kernel: {_by_width(launch_counts[what])}")
    print(f"legacy: records equal the fused flow's in (a)-(c) (main's, the rescue run's, "
          f"phase 20's), cns_final phase 8's; {sum(spliced)} lanes spliced", flush=True)
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "necat_tpu_torch")):
        print("chip_smoke: necat_tpu_torch/ is not beside this script; run it from a "
              "checkout of the repository; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    os.environ["NECAT_TPU_MAX_STAGE_ERROR"] = "1"     # no stage retry may hide a failure
    t0 = time.perf_counter()
    smi = probe()
    build()
    kernels = check_kernels(dev)
    kernels.update(check_kernels(dev, W=POLISH_W, k3_words=(1, POLISH_WORDS)))
    kernels.update(check_kernels(dev, W=64))
    check_slice(dev)
    launch_counts = {}
    main_res, main_inputs = main_path(dev, launch_counts)
    for W in RUNGS:
        kernels.update(check_kernels(
            dev, W=W, k3_words=(1, POLISH_WORDS) if W in WORDS3_RUNGS else (1,)))
    check_rescue(dev, launch_counts)
    cfg_path, genome = check_correct(launch_counts, main_res)
    check_polish(dev, launch_counts)
    fast = check_assemble(launch_counts, cfg_path, genome)
    check_bridge(dev, launch_counts)
    check_bridge_cli(launch_counts, cfg_path)
    check_trim_accurate(dev, launch_counts, cfg_path, genome, fast)
    check_small_memory(dev, launch_counts, main_inputs, smi)
    check_volumes(dev, launch_counts, main_inputs, cfg_path, smi)
    check_index(dev, launch_counts, main_inputs, smi)
    check_devices(dev, launch_counts, main_inputs, cfg_path, smi)
    check_timing(dev, launch_counts, main_inputs, smi)
    rows, adaptive_recs = check_adaptive(dev, launch_counts, main_inputs, smi)
    kernels.update(rows)
    adaptive_ratios(kernels)
    kernels.update(check_adaptive_pipeline(dev, launch_counts, cfg_path, genome, smi))
    check_legacy(dev, launch_counts, main_inputs, adaptive_recs, cfg_path, smi)
    check_stripes(cfg_path, smi)
    elsewhere = {path: _by_width(c) for path, c in launch_counts.items()
                 if path not in ADAPTIVE_PATHS
                 and any(n for (k, _), n in c["by_width"].items() if k in ADAPTIVE)}
    if elsewhere:
        raise AssertionError(f"K1a/K3a launched outside phases 20, 21 and 22c: {elsewhere}")
    for key, entry in kernels.items():
        name, W, words = key[:3]
        words_key = {"banded_backtrack_cols": "k3_by_words",
                     "adaptive_backtrack_cols": "k3a_by_words"}.get(name)
        by_path = {path: (c[words_key].get((W, words), 0) if words_key
                          else c["by_width"].get((name, W), 0))
                   for path, c in launch_counts.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_main"] = by_path["main"]
        entry["launches_by_path"] = by_path
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
