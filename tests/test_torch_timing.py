"""The port's host timing scopes (necat_tpu_torch/utils/logging.py) against
the JAX package's (necat_tpu/utils/logging.py): the same scope names and
calls on the same main path (find_all_candidates -> swap_roles ->
correct_reads, the JAX package on its static band), besides the port's own
names (logging.PORT_ONLY), counted where the work happens; outputs that
timing and the kept spans do not change, no increment lost to the candidate
search's host threads, and the report and its dump to stderr."""

import collections
import dataclasses
import os
import pathlib
import subprocess
import sys
import threading
import types

import numpy as np
import pytest

from necat_tpu.consensus import correct as jcorrect
from necat_tpu.overlap import overlapper as joverlapper
from necat_tpu.overlap.candidates import Candidates as JaxCandidates
from necat_tpu.utils import logging as jlogging
from necat_tpu_torch.align.engine import ExtendEngine
from necat_tpu_torch.consensus import correct as tcorrect, fused as tfused
from necat_tpu_torch.consensus.correct import correct_reads
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.overlap.candidates import Candidates
from necat_tpu_torch.overlap.overlapper import find_all_candidates
from necat_tpu_torch.utils import logging as tlogging
from torch_port_helpers import SMALL_MAP_OPTIONS, _force_static_band, as_jax, small_store

REPO = pathlib.Path(__file__).resolve().parents[1]
CNS = CnsOptions(templates_per_batch=4, pairs_per_chunk=32)
LANES = ("ext.lanes", "ext.real_lanes", "ext.cell_Mlanes")
# scopes timed once per shard by the candidate search's per-device threads
PER_SHARD = ("cand.limits", "cand.dispatch", "cand.exec", "cand.stats_sync")
# the port-only names (logging.PORT_ONLY) of the fused main path
FUSED_PORT_ONLY = {"cns.tag_scatter", "cns.scatter_sync", "cns.scatter_kernel_chunks",
                   "cns.padded_batch", "cns.compact_packed", "cns.emit_records",
                   "ext.live_Mcols", "cns.download_MB"}


def _jax_main(jrs):
    jlogging._TIMERS.clear()        # its lane counters count with timing off too
    jlogging._COUNTS.clear()
    c = joverlapper.find_all_candidates(jrs, jrs, as_jax(SMALL_MAP_OPTIONS), pairwise=True)
    jcorrect.correct_reads(jrs, JaxCandidates.concat([c, c.swap_roles()]), as_jax(CNS))
    return jlogging.timing_report()


def _port_main(rs, device="cpu"):
    tlogging.reset_timers()
    c = find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise=True, device=device)
    recs = correct_reads(rs, Candidates.concat([c, c.swap_roles()]), CNS, device=device)
    return c, recs, tlogging.timing_report()


def _watch(mp, seen: dict) -> None:
    """Record, for the run under way, the scatter_chunk calls of the fused
    path, the chunks ExtendEngine.plan makes (with the query lengths it was
    given), the buckets each supergroup compacts and the bytes of their
    downloaded consensus."""
    def scatter_chunk(*a, _fn=tfused.scatter_chunk, **kw):
        seen["scatter_chunk"] += 1
        return _fn(*a, **kw)

    def plan(self, qids, qdir, qsize, *a, _fn=ExtendEngine.plan, **kw):
        chunks = _fn(self, qids, qdir, qsize, *a, **kw)
        seen["plans"].append((np.asarray(qsize), chunks))
        return chunks

    def compact(store, buckets, *a, _fn=tcorrect._compact_supergroup, **kw):
        seen["buckets"] += len(buckets)
        seen["download_B"] += sum(x.nbytes for b in buckets for x in b.stream)
        return _fn(store, buckets, *a, **kw)

    mp.setattr(tfused, "scatter_chunk", scatter_chunk)
    mp.setattr(ExtendEngine, "plan", plan)
    mp.setattr(tcorrect, "_compact_supergroup", compact)


@pytest.fixture(scope="module")
def main_runs(tmp_path_factory):
    """Reports (and the port's outputs) of the main path on small_store with
    timing off, on, and on with NECAT_TPU_SYNC_DISPATCH, in both packages
    (the JAX package with timing on only), and in the port with the spans
    kept too ("trace"; its spans under "spans"); under "seen", what _watch
    recorded in each of the port's runs."""
    jrs, rs = small_store()
    out = {"port": {}, "jax": {}, "seen": {}}
    with pytest.MonkeyPatch.context() as mp:
        static = _force_static_band(mp, pallas_enc=False)
        next(static)
        for mode in ("off", "on", "sync", "trace"):
            if mode == "on":
                mp.setattr(tlogging, "TIMING_ON", True)
                mp.setattr(jlogging, "TIMING_ON", True)
            elif mode == "sync":
                mp.setenv("NECAT_TPU_SYNC_DISPATCH", "1")
            elif mode == "trace":
                mp.delenv("NECAT_TPU_SYNC_DISPATCH")
                mp.setattr(tlogging, "TRACE_PATH",
                           str(tmp_path_factory.mktemp("trace") / "spans.json"))
            if mode in ("on", "sync"):
                out["jax"][mode] = _jax_main(jrs)
            seen = out["seen"][mode] = {"scatter_chunk": 0, "plans": [], "buckets": 0,
                                        "download_B": 0}
            with pytest.MonkeyPatch.context() as watch:
                _watch(watch, seen)
                out["port"][mode] = _port_main(rs)
        out["spans"] = tlogging.spans()
        next(static, None)
    tlogging.reset_timers()
    yield out


@pytest.mark.parametrize("mode", ["on", "sync"])
def test_scope_names_and_calls_match_jax(main_runs, mode):
    """The port times the JAX package's scopes, less the listed names it has
    no code for, as many times each, and counts the same lanes; besides
    them it records its own names of this path, and nothing else."""
    jax_rep, port_rep = main_runs["jax"][mode], main_runs["port"][mode][2]
    want = set(jax_rep) - set(tlogging.NO_COUNTERPART)
    assert FUSED_PORT_ONLY <= set(tlogging.PORT_ONLY)
    assert set(port_rep) == want | FUSED_PORT_ONLY
    assert {"cand.index_build", "cand.batch_total", "cand.dispatch", "cand.topn",
            "ext.chunk_build", "ext.stats_sync", "cns.fused_call", "cns.call_consensus",
            "cns.compact", *LANES} <= want
    execs = {k for k in want if "exec" in k}
    assert bool(execs) == (mode == "sync")
    if mode == "sync":
        assert "cand.exec" in execs and any(k.startswith("cns.fused_exec_L") for k in execs)
    for k in want:
        assert port_rep[k][1] == jax_rep[k][1], k
    for k in LANES:
        assert port_rep[k] == jax_rep[k], k


def test_no_counterpart_names_are_jax_scopes():
    """Every name the port lists as having no counterpart is a scope of the
    JAX package, and the port's code uses none of them."""
    jax_src = "".join(p.read_text() for p in (REPO / "necat_tpu").rglob("*.py"))
    port_src = "".join(p.read_text() for p in (REPO / "necat_tpu_torch").rglob("*.py")
                       if p.name != "logging.py")
    assert len(set(tlogging.NO_COUNTERPART)) == len(tlogging.NO_COUNTERPART)
    for name in tlogging.NO_COUNTERPART:
        assert f'timed("{name}")' in jax_src, name
        assert f'"{name}"' not in port_src, name


def test_port_only_names_are_not_jax_scopes():
    """No name the port lists as its own is a name of the JAX package, and
    the port's code records each of them."""
    jax_src = "".join(p.read_text() for p in (REPO / "necat_tpu").rglob("*.py"))
    port_src = "".join(p.read_text() for p in (REPO / "necat_tpu_torch").rglob("*.py")
                       if p.name != "logging.py")
    assert len(set(tlogging.PORT_ONLY)) == len(tlogging.PORT_ONLY)
    assert not set(tlogging.PORT_ONLY) & set(tlogging.NO_COUNTERPART)
    for name in tlogging.PORT_ONLY:
        assert f'"{name}"' not in jax_src, name
        assert f'"{name}"' in port_src, name


@pytest.mark.parametrize("mode", ["on", "sync", "trace"])
def test_scatter_syncs_eight_per_chunk(main_runs, mode):
    """cns.tag_scatter times each scatter_chunk call of the fused path, and
    cns.scatter_sync each of its eight listings (four a pass). This holds the
    CPU path, the plain version; on the card the kernel lists nothing, and
    tests/test_torch_tag_scatter_kernel.py holds its counter there. Here
    cns.scatter_kernel_chunks reads 0."""
    rep, n = main_runs["port"][mode][2], main_runs["seen"][mode]["scatter_chunk"]
    assert n > 0
    assert rep["cns.tag_scatter"][1] == n
    assert rep["cns.scatter_sync"][1] == 8 * n
    assert rep["cns.scatter_kernel_chunks"] == (0, 0)


@pytest.mark.parametrize("mode", ["on", "sync", "trace"])
def test_compaction_parts_per_bucket(main_runs, mode):
    """cns.compact, its two parts and cns.emit_records are timed once per
    bucket; the parts take no longer than their parent."""
    rep, n = main_runs["port"][mode][2], main_runs["seen"][mode]["buckets"]
    assert n > 0
    for k in ("cns.compact", "cns.padded_batch", "cns.compact_packed", "cns.emit_records"):
        assert rep[k][1] == n, k
    assert rep["cns.padded_batch"][0] + rep["cns.compact_packed"][0] <= \
        rep["cns.compact"][0] + 0.011


@pytest.mark.parametrize("mode", ["on", "sync", "trace"])
def test_download_megabytes_per_bucket(main_runs, mode):
    """cns.download_MB, a port-only counter reported with 0 calls, is the MB
    of every bucket's downloaded consensus (stream, cum_t, cov8)."""
    rep, seen = main_runs["port"][mode][2], main_runs["seen"][mode]
    assert "cns.download_MB" in tlogging.PORT_ONLY
    assert seen["download_B"] > 0
    assert rep["cns.download_MB"] == (pytest.approx(round(seen["download_B"] / 1e6, 2),
                                                    abs=0.011), 0)
    assert rep["cns.download_MB"][0] > 0


@pytest.mark.parametrize("mode", ["on", "sync", "trace"])
def test_live_cols_from_the_plan(main_runs, mode):
    """ext.live_Mcols is the summed max(query length, window length) of the
    real lanes of every planned chunk, in millions, and no more than
    ext.cell_Mlanes, the summed lanes x tier."""
    rep, plans = main_runs["port"][mode][2], main_runs["seen"][mode]["plans"]
    live = cells = 0
    for qsize, chunks in plans:
        for p in chunks:
            live += int(np.maximum(qsize[p["take"]], p["desc"][:p["n_real"], 6]).sum())
            cells += p["PB"] * p["L"]
    assert live > 0
    assert rep["ext.live_Mcols"] == (pytest.approx(round(live / 1e6, 2), abs=0.011), 0)
    assert rep["ext.cell_Mlanes"][0] == pytest.approx(round(cells / 1e6, 2), abs=0.011)
    assert rep["ext.live_Mcols"][0] <= rep["ext.cell_Mlanes"][0]


def test_main_path_spans_nest(main_runs):
    """With the spans kept, every scope call of the run is a span; ids are
    unique, a parent is a span of the same thread that holds its child in
    time; the scatter's syncs sit in cns.tag_scatter, the scatter in
    cns.fused_call, compaction's parts in cns.compact and the emission
    outside it."""
    spans, rep = main_runs["spans"], main_runs["port"]["trace"][2]
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans) > 0
    assert dict(collections.Counter(s.name for s in spans)) == \
        {k: c for k, (_, c) in rep.items() if c}
    parent_of = {}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent:
            p = by_id[s.parent]
            assert p.thread == s.thread
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        parent_of.setdefault(s.name, set()).add(by_id[s.parent].name if s.parent else None)
    assert parent_of["cns.scatter_sync"] == {"cns.tag_scatter"}
    assert parent_of["cns.tag_scatter"] == {"cns.fused_call"}
    assert parent_of["cns.padded_batch"] == parent_of["cns.compact_packed"] == {"cns.compact"}
    assert "cns.compact" not in parent_of["cns.emit_records"]


def test_outputs_unchanged_by_timing(main_runs):
    """Candidates and records are the same with timing off, on, on with
    the synchronised dispatch and on with the spans kept; with timing off
    nothing is recorded."""
    runs = main_runs["port"]
    c0, r0, rep0 = runs["off"]
    assert rep0 == {}
    assert sum(r.corrected for r in r0) >= 10
    for mode in ("on", "sync", "trace"):
        c, r, _ = runs[mode]
        for f in dataclasses.fields(Candidates):
            np.testing.assert_array_equal(getattr(c, f.name), getattr(c0, f.name))
        assert [(x.tid, x.left, x.right, x.corrected) for x in r] == \
            [(x.tid, x.left, x.right, x.corrected) for x in r0]
        for x, y in zip(r, r0):
            np.testing.assert_array_equal(x.seq, y.seq)


@pytest.mark.parametrize("devices", [["cpu", "cpu"], ["cpu:0", "cpu:1"]])
def test_shard_threads_lose_no_increment(monkeypatch, devices):
    """Two shards: the per-shard scopes count twice the one-device calls,
    the others as many; with two distinct devices each shard runs in a host
    thread of its own (parallel/mesh.device_threads)."""
    _, rs = small_store()
    monkeypatch.setattr(tlogging, "TIMING_ON", True)
    monkeypatch.setenv("NECAT_TPU_SYNC_DISPATCH", "1")
    reports, cands = [], []
    for dev in ("cpu", devices):
        tlogging.reset_timers()
        cands.append(find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise=True,
                                         device=dev))
        reports.append(tlogging.timing_report())
    tlogging.reset_timers()
    one, two = reports
    assert set(one) == set(two) and set(PER_SHARD) <= set(one)
    for k, (_, calls) in one.items():
        assert two[k][1] == calls * (2 if k in PER_SHARD else 1), k
    for f in dataclasses.fields(Candidates):
        np.testing.assert_array_equal(getattr(cands[1], f.name), getattr(cands[0], f.name))


def test_timed_under_contended_threads(monkeypatch):
    """More threads than cores, a short switch interval, every thread timing
    the same new scope at each step (a scope's first call runs the counter's
    __missing__, a window between its read and its write): every scope call
    and lane count of every thread is kept."""
    monkeypatch.setattr(tlogging, "TIMING_ON", True)
    tlogging.reset_timers()
    n_threads, n_calls = 4 * (os.cpu_count() or 1) + 4, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(n_calls):
                with tlogging.timed(f"t.{i}"):
                    pass
                tlogging.count_lanes(8, 3, 4096)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    rep = tlogging.timing_report()
    tlogging.reset_timers()
    n = n_threads * n_calls
    assert all(rep[f"t.{i}"][1] == n_threads for i in range(n_calls))
    assert rep["ext.lanes"] == (8 * n, 0) and rep["ext.real_lanes"] == (3 * n, 0)
    assert rep["ext.cell_Mlanes"][0] == pytest.approx(round(8 * 4096 * n / 1e6, 2))


def test_timing_report_order_and_reset(monkeypatch):
    """{name: (seconds to 0.01, calls)}, the most expensive first; a scope
    that raises is still counted; reset_timers clears scopes and counters."""
    monkeypatch.setattr(tlogging, "TIMING_ON", True)
    tlogging.reset_timers()
    clock = iter([0.0, 0.25, 1.0, 4.004, 10.0, 10.5])
    monkeypatch.setattr(tlogging, "_time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    with tlogging.timed("a"):
        pass
    with tlogging.timed("b"):
        pass
    with pytest.raises(KeyError), tlogging.timed("a"):
        raise KeyError
    tlogging.count_lanes(16, 9, 8192)
    rep = tlogging.timing_report()
    assert list(rep) == ["ext.lanes", "ext.real_lanes", "b", "a", "ext.cell_Mlanes"]
    assert rep["b"] == (3.0, 1) and rep["a"] == (0.75, 2)
    assert rep["ext.cell_Mlanes"] == (0.13, 0)
    tlogging.reset_timers()
    assert tlogging.timing_report() == {}
    monkeypatch.setattr(tlogging, "TIMING_ON", False)
    with tlogging.timed("a"):
        pass
    tlogging.count_lanes(16, 9, 8192)
    assert tlogging.timing_report() == {}


def test_dump_goes_to_stderr_only(tmp_path):
    """With NECAT_TPU_TIMING=1 the report is written at exit to stderr, in
    the JAX package's line format; stdout's last line stays the caller's."""
    code = ("from necat_tpu_torch.utils.logging import count_lanes, timed\n"
            "with timed('cand.topn'):\n    pass\n"
            "count_lanes(8, 5, 1024)\n"
            "print('{\"ok\": true}')\n")
    env = {**os.environ, "NECAT_TPU_TIMING": "1", "PYTHONPATH": str(REPO)}
    env.pop("NECAT_TPU_SYNC_DISPATCH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == '{"ok": true}\n'
    lines = [ln for ln in proc.stderr.splitlines() if ln.startswith("[timing] ")]
    assert lines[0] == "[timing] ext.lanes: 8s over 0 calls"
    assert "[timing] ext.real_lanes: 5s over 0 calls" in lines
    assert any(ln.startswith("[timing] cand.topn: ") and ln.endswith("s over 1 calls")
               for ln in lines)
    assert len(lines) == 4
