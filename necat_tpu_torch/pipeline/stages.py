"""Pipeline stages with resume (counterpart of necat_tpu/pipeline/stages.py:
correct, trim, assemble, bridge and polish, on the devices each process is
given: one, or a list that the entry points share their work over).

Each stage writes its outputs and a `<name>.done.json` manifest (input
fingerprints and the parameters it ran with); a stage runs again only when
an input or a parameter changed or an output is missing, the reference's
skip rule (Plgd/Project.pm:131-177). Directories follow necat.pl's project
layout (1-consensus, ...).
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from necat_tpu_torch.assembly.contigs import AssembleOptions, assemble
from necat_tpu_torch.assembly.overlap_filter import FilterOptions
from necat_tpu_torch.bridge import bridge as bridge_mod
from necat_tpu_torch.bridge.bridge import BridgeOptions, bridge_contigs
from necat_tpu_torch.consensus import correct as correct_mod
from necat_tpu_torch.consensus import fused
from necat_tpu_torch.consensus.correct import correct_reads
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap import overlapper
from necat_tpu_torch.overlap.candidates import Candidates
from necat_tpu_torch.overlap.options import MapOptions
from necat_tpu_torch.overlap.overlapper import (candidates_by_volumes, find_all_candidates,
                                               overlap_all_vs_all)
from necat_tpu_torch.parallel import launcher
from necat_tpu_torch.pipeline.config import Config
from necat_tpu_torch.polish.polish import polish_contigs
from necat_tpu_torch.trim.accurate import trim_reads_accurate
from necat_tpu_torch.trim.lcr import TrimOptions, trim_reads
from necat_tpu_torch.utils import shapes
from necat_tpu_torch.utils.device import resolve_devices
from necat_tpu_torch.utils.logging import logger


def _fingerprint(paths: List[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        st = os.stat(p)
        h.update(f"{p}:{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()[:16]


def _stage(workdir: str, name: str, ifiles: List[str], ofiles: List[str],
           params: dict, fn: Callable[[], Optional[dict]],
           coordinator_only: bool = False, device=None) -> bool:
    """Run fn unless its outputs are up to date; True if it ran. The manifest
    is written only after fn returns, with the fields of the dict fn returns
    (if any) added, and the devices the stage ran on (`device`, if given).

    In a multi-process run (parallel/launcher.py) a coordinator_only stage
    runs fn on process 0 while the others wait; a striped stage runs fn in
    every process (fn picks its stripe), and the manifest adds each
    process's dict under "by_process". Both end at a barrier, so that the
    next stage reads the outputs in any process; only process 0 writes the
    manifest. A failing fn runs again, up to NECAT_TPU_MAX_STAGE_ERROR
    attempts in all (default 3; Plgd/Project.pm:222-244), after the
    device's cached blocks are released. NECAT_TPU_PROFILE=<dir> records
    each stage with torch.profiler into <dir>/<stage>/process<id>.json, a
    Chrome trace (the TIMING_START/END role, ontcns_aux.h:107-116)."""
    pid, nproc = launcher.init_multihost()
    os.makedirs(workdir, exist_ok=True)
    done_path = os.path.join(workdir, f"{name}.done.json")
    fp = _fingerprint(ifiles)
    pjson = json.dumps(params, sort_keys=True, default=str)
    if os.path.exists(done_path) and all(os.path.exists(o) for o in ofiles):
        try:
            with open(done_path) as f:
                d = json.load(f)
        except (OSError, ValueError):
            d = {}
        if d.get("input_fp") == fp and d.get("params") == pjson and d.get("rc") == 0:
            logger.info("stage %s: up to date, skipping", name)
            return False
    logger.info("stage %s: running", name)
    t0 = time.time()
    report = {}
    if not coordinator_only or launcher.is_coordinator():
        report = _run_with_retries(name, fn, pid) or {}
    striped = nproc > 1 and not coordinator_only
    if striped:
        with open(os.path.join(workdir, f"{name}.process{pid}.json"), "w") as f:
            json.dump(report, f)
    launcher.barrier(f"stage:{name}")
    if launcher.is_coordinator():
        if striped:
            by_process = []
            for p in range(nproc):
                part = os.path.join(workdir, f"{name}.process{p}.json")
                with open(part) as f:
                    by_process.append(json.load(f))
                os.remove(part)
            report = {**report, "by_process": by_process}
        if device is not None:
            report = {"devices": [str(d) for d in resolve_devices(device)], **report}
        with open(done_path, "w") as f:
            json.dump({"input_fp": fp, "params": pjson, "rc": 0,
                       "wall_s": round(time.time() - t0, 1), **report}, f)
    launcher.barrier(f"stage:{name}:done")
    logger.info("stage %s: done in %.1fs", name, time.time() - t0)
    return True


def _run_with_retries(name: str, fn: Callable[[], Optional[dict]], pid: int):
    """fn(), with _stage's retries and profiler; returns what fn returns."""
    max_err = int(os.environ.get("NECAT_TPU_MAX_STAGE_ERROR", "3"))
    prof_dir = os.environ.get("NECAT_TPU_PROFILE")
    attempts = 0
    while True:
        try:
            if not prof_dir:
                return fn()
            with torch.profiler.profile(
                    activities=torch.profiler.supported_activities()) as prof:
                report = fn()
            os.makedirs(os.path.join(prof_dir, name), exist_ok=True)
            prof.export_chrome_trace(os.path.join(prof_dir, name, f"process{pid}.json"))
            return report
        except Exception:
            attempts += 1
            if attempts >= max_err:
                logger.error("stage %s: failed %d times, giving up", name, attempts)
                raise
            logger.warning("stage %s: attempt %d failed, retrying", name, attempts,
                           exc_info=True)
            # the role of the JAX package's release_device_caches: the retry
            # starts on a device without the failed attempt's cached blocks
            torch.cuda.empty_cache()


def _read_input_list(cfg: Config) -> List[str]:
    with open(cfg.read_list) as f:
        return [line.strip() for line in f if line.strip()]


def load_raw_reads(cfg: Config, keep_coverage: float = 0.0) -> ReadStore:
    """The input read set. With keep_coverage > 0 and a genome size, only the
    longest reads up to keep_coverage x genome size are kept, selected in two
    passes (lengths first, then each file's kept reads) so that memory holds
    the kept set and one input file."""
    paths = _read_input_list(cfg)
    if keep_coverage <= 0 or cfg.genome_size <= 0:
        return ReadStore.concat(
            [ReadStore.from_fasta(p, min_length=cfg.min_read_length) for p in paths])
    lens_per_file = [ReadStore.from_fasta(p, min_length=cfg.min_read_length).lengths
                     for p in paths]
    all_lens = np.concatenate(lens_per_file)
    target = int(cfg.genome_size * keep_coverage)
    order = np.argsort(all_lens, kind="stable")[::-1]
    csum = np.cumsum(all_lens[order])
    n_keep = min(int(np.searchsorted(csum, target)) + 1, len(all_lens))
    keep = np.sort(order[:n_keep])
    parts = []
    base = 0
    for p, fl in zip(paths, lens_per_file):
        sel = keep[(keep >= base) & (keep < base + len(fl))] - base
        st = ReadStore.from_fasta(p, min_length=cfg.min_read_length)
        parts.append(st.subset(sel) if len(sel) != st.n_reads else st)
        base += len(fl)
    return ReadStore.concat(parts)


def _check_supported(store: ReadStore, stage: str) -> None:
    """Trim, assemble, bridge and polish extend on a device store of the
    whole read set (extend_candidates), which holds fewer than
    shapes.DEVICE_STORE_MAX_BASES bases; the JAX package's device store
    raises there too (necat_tpu/io/devstore.py:60). Refuse such read sets
    before any work. The correct stage runs them (volumes and SMALL_MEMORY)."""
    if store.total_bases >= shapes.DEVICE_STORE_MAX_BASES:
        raise NotImplementedError(
            f"necat_tpu_torch {stage}: {store.total_bases} bases >= "
            f"{shapes.DEVICE_STORE_MAX_BASES} (shapes.DEVICE_STORE_MAX_BASES): the "
            "extension's device store cannot hold them, in necat_tpu either")


@dataclasses.dataclass
class Project:
    cfg: Config
    root: str

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)

    def path(self, *parts) -> str:
        return os.path.join(self.root, *parts)

    def _opt_params(self, *keys: str) -> dict:
        """The config option strings a stage consumes, for its manifest:
        editing one (say FSA_OL_FILTER_OPTIONS) reruns the stage, as the
        reference reruns a job whose script text changed (Plgd/Project.pm:
        131-177)."""
        return {k: self.cfg.get(k, "") for k in keys}

    def _vol_size(self, store: ReadStore) -> int:
        """Subject-volume size of the all-vs-all stages: VOL_SIZE, else 2 GB
        volumes for a read set at or past shapes.DEVICE_STORE_MAX_BASES
        (oc2mkdb, makedb/main.c:8); 0 for no tiling."""
        vol = int(float(self.cfg.get("VOL_SIZE", "0") or 0))
        if vol <= 0 and store.total_bases >= shapes.DEVICE_STORE_MAX_BASES:
            vol = 2_000_000_000
        return vol

    def run_correct(self, *, device="cuda") -> str:
        """necat.pl correct (runConsensus) on `device`; returns the path of
        1-consensus/cns_final.fasta.gz.

        NUM_ITER iterations: the first maps with the sensitive options and
        corrects with -r 0, the later ones map fast and correct with -r 1
        (the long-indel rescue ladder); every iteration but the last keeps
        reads whole (-f 1). The last keeps corrected pieces only, then the
        longest of them up to CNS_OUTPUT_COVERAGE.

        The candidates come from subject volumes (candidates_by_volumes)
        under VOL_SIZE or past shapes.DEVICE_STORE_MAX_BASES. In a
        multi-process run each process corrects its stripe of the templates
        (launcher.host_stripe) and writes it to it<i>.part<pid>.fasta.gz;
        after a barrier every process reads the parts back in (tid, left)
        order, so the result is the one-process run's.

        The manifest 1-consensus/correct.done.json records, per iteration,
        the seconds of the candidate search (and of its index builds, one
        per volume) and of the correction (both return host arrays, so
        their device work is inside the span) and the pairs dispatched at
        each band width."""
        cfg = self.cfg
        wd = self.path("1-consensus")
        out = os.path.join(wd, "cns_final.fasta.gz")
        ifiles = _read_input_list(cfg)

        def fn():
            pid, nproc = launcher.init_multihost()
            cur = load_raw_reads(cfg, keep_coverage=cfg.prep_output_coverage)
            iterations = []
            for it in range(cfg.num_iter):
                logger.info("correction iteration %d/%d: %d reads",
                            it + 1, cfg.num_iter, cur.n_reads)
                kind, rescue = ("SENSITIVE", "0") if it == 0 else ("FAST", "1")
                mopts = MapOptions.from_string(cfg.get(f"OVLP_{kind}_OPTIONS", ""))
                copts = CnsOptions.from_string(
                    cfg.get(f"CNS_{kind}_OPTIONS", "") + " -r " + rescue)
                copts = dataclasses.replace(
                    copts, full_consensus=(it + 1 != cfg.num_iter),
                    small_memory=cfg.get("SMALL_MEMORY", "0").strip() in ("1", "true"))
                fused.pairs_by_band.clear()
                overlapper.index_build_s.clear()
                vol_size = self._vol_size(cur)
                t0 = time.perf_counter()
                if vol_size > 0:
                    cands = candidates_by_volumes(cur, mopts, vol_size, device=device)
                else:
                    cands = find_all_candidates(cur, cur, mopts, pairwise=True,
                                                device=device)
                t1 = time.perf_counter()
                stripe = launcher.host_stripe(cur.n_reads, pid, nproc) if nproc > 1 else None
                recs = correct_reads(cur, Candidates.concat([cands, cands.swap_roles()]),
                                     copts, device=device, template_ids=stripe)
                t2 = time.perf_counter()
                iterations.append({"candidates_s": t1 - t0,
                                   "index_build_s": list(overlapper.index_build_s),
                                   "correct_s": t2 - t1,
                                   "pairs_by_band": {str(w): n for w, n in
                                                     sorted(fused.pairs_by_band.items())}})
                logger.info("correction iteration %d: candidates %.3f s, correction "
                            "%.3f s, pairs by band %s", it + 1, t1 - t0, t2 - t1,
                            iterations[-1]["pairs_by_band"])
                recs.sort(key=lambda r: (r.tid, r.left))
                if it + 1 == cfg.num_iter:
                    # the final extraction reads corrected pieces only
                    # (runCnsExtract, necat.pl:397-416)
                    recs = [r for r in recs if r.corrected]
                cur = ReadStore.from_seqs(
                    [r.seq for r in recs],
                    [f"{r.tid}_{r.left}_{r.right}_{r.org_size}" for r in recs])
                if nproc > 1:
                    # the stripes meet through files (the reference's per-node
                    # cns parts merged by oc2ReorderCnsReads)
                    cur.to_fasta(os.path.join(wd, f"it{it}.part{pid}.fasta.gz"))
                    launcher.barrier(f"correct:it{it}")
                    merged = ReadStore.concat(
                        [ReadStore.from_fasta(os.path.join(wd, f"it{it}.part{p}.fasta.gz"))
                         for p in range(nproc)])
                    key = [tuple(map(int, n.split("_")[:2])) for n in merged.names]
                    cur = merged.subset(np.array(sorted(range(merged.n_reads),
                                                        key=key.__getitem__), np.int64))
            if cfg.genome_size > 0:
                cur = cur.subset(cur.longest_to_coverage(cfg.genome_size,
                                                         cfg.cns_output_coverage))
            if launcher.is_coordinator():
                cur.to_fasta(out)
            logger.info("cns_final: %d reads, %d bases, N50 %d",
                        cur.n_reads, cur.total_bases, cur.n50()[0])
            return {"iterations": iterations}

        params = {"num_iter": cfg.num_iter, "cov": cfg.prep_output_coverage,
                  "cns_cov": cfg.cns_output_coverage,
                  "min_read_length": cfg.min_read_length,
                  **self._opt_params("OVLP_SENSITIVE_OPTIONS", "CNS_SENSITIVE_OPTIONS",
                                     "OVLP_FAST_OPTIONS", "CNS_FAST_OPTIONS",
                                     "SMALL_MEMORY")}
        _stage(wd, "correct", ifiles, [out], params, fn, device=device)
        return out

    def _overlaps(self, reads: ReadStore, key: str, stage: str, device):
        """All-vs-all overlaps of reads with the option string cfg[key] over
        the assembly overlapper's defaults (-n 100, two chains per pair), in
        subject volumes under VOL_SIZE."""
        _check_supported(reads, stage)
        mopts = MapOptions.from_string(self.cfg.get(key, ""),
                                       MapOptions(ncan=100, n_chains_per_pair=2))
        return overlap_all_vs_all(reads, mopts, device=device,
                                  vol_size=self._vol_size(reads))

    def run_trim(self, *, device="cuda") -> str:
        """Trim stage (runTrimBases*): all-vs-all overlaps of the corrected
        reads on `device`, then by TRIM_METHOD either each read clipped to its
        largest cover range on the host (fast) or re-corrected over it on
        `device` (accurate, accurate0: trim/accurate.py). Returns the path of
        trimReads.fasta.gz; the manifest records the seconds of the overlaps
        and of the trim (trim_s for fast, cns_s for the accurate
        re-consensus), and the pairs extended at each band width by the
        overlaps and by the re-consensus. Process 0 runs it alone."""
        method = self.cfg.get("TRIM_METHOD", "fast").strip() or "fast"
        cns = self.run_correct(device=device)
        wd = self.path("2-trim_bases")
        out = self.path("trimReads.fasta.gz")

        def fn():
            reads = ReadStore.from_fasta(cns)
            overlapper.pairs_by_band.clear()
            fused.pairs_by_band.clear()
            t0 = time.perf_counter()
            m4 = self._overlaps(reads, "TRIM_OVLP_OPTIONS", "run_trim", device)
            t1 = time.perf_counter()
            if method in ("accurate", "accurate0"):
                # TRIM_METHOD selection (necat.pl:1196-1210): the accurate
                # variants re-consensus each read over its cover range
                trimmed, _, _ = trim_reads_accurate(reads, m4, device=device)
                part = "cns_s"
            else:
                trimmed, _, _ = trim_reads(reads, m4, TrimOptions())
                part = "trim_s"
            t2 = time.perf_counter()
            trimmed.to_fasta(out)
            logger.info("trimmed (%s): %d/%d reads kept", method, trimmed.n_reads,
                        reads.n_reads)
            return {"overlap_s": t1 - t0, part: t2 - t1, "pairs_by_band": {
                name: {str(w): n for w, n in sorted(c.items())}
                for name, c in (("overlap", overlapper.pairs_by_band),
                                ("cns", fused.pairs_by_band))}}

        _stage(wd, "trim", [cns], [out],
               {"method": method, **self._opt_params("TRIM_OVLP_OPTIONS")}, fn,
               coordinator_only=True, device=device)
        return out

    def run_assemble(self, *, device="cuda") -> str:
        """Assembly (runAlignReads + runAssemble): all-vs-all overlaps of the
        trimmed reads on `device` (4-fsa/pm.m4.gz), then the overlap filter,
        string graph, path graph and contigs on the host (4-fsa/contigs.fasta,
        bubbles.fasta, contig_tiles, bubble_tiles, readinfos.json/.txt).
        Returns the contigs' path. Process 0 runs it alone."""
        trimmed_path = self.run_trim(device=device)
        wd = self.path("4-fsa")
        out = os.path.join(wd, "contigs.fasta")

        def fn():
            trimmed = ReadStore.from_fasta(trimmed_path)
            t0 = time.perf_counter()
            m4 = self._overlaps(trimmed, "ASM_OVLP_OPTIONS", "run_assemble", device)
            t1 = time.perf_counter()
            m4.save(os.path.join(wd, "pm.m4.gz"))
            # FSA_* option strings go verbatim to the fsa layer, as necat.pl
            # passes them to its binaries (necat.pl:1228-1245)
            aopts = AssembleOptions.from_string(self.cfg.get("FSA_ASSEMBLE_OPTIONS", ""))
            res = assemble(trimmed, m4,
                           FilterOptions.from_string(self.cfg.get("FSA_OL_FILTER_OPTIONS", "")),
                           min_contig_length=aopts.min_contig_length,
                           max_spur_length=aopts.max_spur_length,
                           select_branch=aopts.select_branch)
            t2 = time.perf_counter()
            res.contigs.to_fasta(out)
            res.bubbles.to_fasta(os.path.join(wd, "bubbles.fasta"))
            with open(os.path.join(wd, "contig_tiles"), "w") as f:
                for ci, tiles in enumerate(res.tiles):
                    for t in tiles:
                        f.write(f"ctg{ci}\t{t.read}\t{t.orient}\t{t.ctg_start}\t{t.ctg_end}\n")
            with open(os.path.join(wd, "bubble_tiles"), "w") as f:
                for bi, tiles in enumerate(res.bubble_tiles):
                    for t in tiles:
                        f.write(f"{res.bubbles.names[bi]}\t{t.read}\t{t.orient}\t"
                                f"{t.ctg_start}\t{t.ctg_end}\n")
            # ol_filter's readinfos (overlap_filter.hpp:162-167): per-read mean
            # identity and coverage range, and the bridge stage's auto params
            with open(os.path.join(wd, "readinfos.json"), "w") as f:
                json.dump({"min_identity": res.min_identity,
                           "max_overhang": res.max_overhang}, f)
            if res.read_ident is not None:
                with open(os.path.join(wd, "readinfos.txt"), "w") as f:
                    for r in range(len(res.read_ident)):
                        if np.isnan(res.read_ident[r]):
                            continue
                        cmin, cmax = (res.read_cov[r] if res.read_cov is not None
                                      else (0, 0))
                        f.write(f"{r}\t{res.read_ident[r]:.2f}\t{cmin}\t{cmax}\n")
            n50, _ = res.contigs.n50()
            logger.info("contigs: %d, total %d, N50 %d", res.contigs.n_reads,
                        res.contigs.total_bases, n50)
            return {"overlap_s": t1 - t0, "assemble_s": t2 - t1}

        _stage(wd, "assemble", [trimmed_path], [out],
               self._opt_params("ASM_OVLP_OPTIONS", "FSA_OL_FILTER_OPTIONS",
                                "FSA_ASSEMBLE_OPTIONS"), fn, coordinator_only=True,
               device=device)
        return out

    def run_polish(self, ctg_path: str, tag: str, *, device="cuda") -> str:
        """Polish the contigs at ctg_path with the raw reads on `device`
        (runPolishContigs); returns polished_contigs.fasta for tag "final",
        else <tag>_polished.fasta. In a multi-process run each process
        polishes its stripe of the contigs into <tag>-polish/part<pid>.fasta.gz
        and process 0 merges the parts in contig order. The manifest records
        the seconds of each part (correct_mod.seconds_by_part: map, waves,
        consensus, overrides, compact) and the pairs extended at each band
        width."""
        wd = self.path(f"{tag}-polish")
        out = self.path("polished_contigs.fasta" if tag == "final"
                        else f"{tag}_polished.fasta")

        def fn():
            pid, nproc = launcher.init_multihost()
            contigs = ReadStore.from_fasta(ctg_path)
            reads = load_raw_reads(self.cfg)
            _check_supported(reads, "run_polish")
            correct_mod.seconds_by_part.clear()
            fused.pairs_by_band.clear()
            if nproc > 1:
                part = polish_contigs(
                    contigs.subset(launcher.host_stripe(contigs.n_reads, pid, nproc)),
                    reads, device=device)
                part.to_fasta(os.path.join(wd, f"part{pid}.fasta.gz"))
            else:
                pol = polish_contigs(contigs, reads, device=device)
            report = {"seconds_by_part": dict(correct_mod.seconds_by_part),
                      "pairs_by_band": {str(w): n for w, n in
                                        sorted(fused.pairs_by_band.items())}}
            if nproc > 1:
                launcher.barrier("polish:parts")
                if not launcher.is_coordinator():
                    return report
                by_name = {}
                for p in range(nproc):
                    st = ReadStore.from_fasta(os.path.join(wd, f"part{p}.fasta.gz"))
                    by_name.update((st.names[i], st.get(i)) for i in range(st.n_reads))
                names = [f"{n}_polished" for n in contigs.names]
                pol = ReadStore.from_seqs([by_name[n] for n in names], names)
            pol.to_fasta(out)
            logger.info("polished: %d contigs, total %d, N50 %d", pol.n_reads,
                        pol.total_bases, pol.n50()[0])
            return report

        _stage(wd, "polish", [ctg_path], [out],
               self._opt_params("POLISH_OVLP_OPTIONS", "POLISH_CNS_OPTIONS"), fn,
               device=device)
        return out

    def run_bridge(self, *, device="cuda") -> str:
        """Bridge stage (runAlignContigs + runBridgeContigs): the raw reads
        (all of them) mapped to 4-fsa/contigs.fasta, and the contigs to each
        other, on `device`; contigs joined on the host. Returns the path of
        6-bridge_contigs/bridged_contigs.fasta. The manifest records the
        seconds of the parts (map_s, c2c_s, graph_s, junction_s), the
        contig graph's directed edges before and after the support cut
        (links, links_kept), the contig counts in and out and the pairs
        extended at each band width (mapping and contig-to-contig). Process 0
        runs it alone."""
        ctg_path = self.run_assemble(device=device)
        wd = self.path("6-bridge_contigs")
        out = os.path.join(wd, "bridged_contigs.fasta")

        def fn():
            contigs = ReadStore.from_fasta(ctg_path)
            reads = load_raw_reads(self.cfg)
            _check_supported(reads, "run_bridge")
            bopts = BridgeOptions.from_string(self.cfg.get("FSA_CTG_BRIDGE_OPTIONS", ""))
            readinfos = None
            ri_path = self.path("4-fsa", "readinfos.json")
            if os.path.exists(ri_path):
                try:
                    with open(ri_path) as f:
                        readinfos = json.load(f)
                except (OSError, ValueError):
                    pass
            overlapper.pairs_by_band.clear()
            bridged = bridge_contigs(contigs, reads, opts=bopts, readinfos=readinfos,
                                     device=device)
            bridged.to_fasta(out)
            logger.info("bridged: %d contigs in, %d out, N50 %d", contigs.n_reads,
                        bridged.n_reads, bridged.n50()[0])
            return {**{k: bridge_mod.stats[k] for k in ("map_s", "c2c_s", "graph_s", "junction_s",
                                                        "c2c_pairs", "links", "links_kept")},
                    "contigs_in": contigs.n_reads, "contigs_out": bridged.n_reads,
                    "pairs_by_band": {str(w): n for w, n in
                                      sorted(overlapper.pairs_by_band.items())}}

        _stage(wd, "bridge", [ctg_path], [out],
               self._opt_params("FSA_CTG_BRIDGE_OPTIONS"), fn, coordinator_only=True,
               device=device)
        return out

    def cleanup(self) -> None:
        """CLEANUP=1: delete the intermediate files after a successful run
        (the overlaps, the processes' parts; the reference's mfiles
        deletion, Plgd/Project.pm:168-170). Stage outputs and manifests
        stay, so resume still works. Process 0 removes them."""
        if not launcher.is_coordinator():
            return
        for pat in ("1-consensus/it*.part*.fasta.gz", "4-fsa/pm.m4.gz",
                    "*-polish/part*.fasta.gz"):
            for p in glob.glob(self.path(pat)):
                os.remove(p)
                logger.info("cleanup: removed %s", p)
