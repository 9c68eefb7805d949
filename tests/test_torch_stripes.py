"""Multi-process runs: the port's launcher (torch.distributed, gloo) against
tests/test_launcher.py's checks, correct_reads over template stripes against
the JAX package's and against the whole run, and a real two-process `cli
correct`."""

import dataclasses
import gzip
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from necat_tpu.consensus.correct import correct_reads as j_correct_reads
from necat_tpu.overlap.candidates import Candidates as JaxCandidates
from necat_tpu_torch.consensus.correct import correct_reads
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.overlap.candidates import Candidates
from necat_tpu_torch.overlap.overlapper import find_all_candidates
from necat_tpu_torch.parallel import launcher
from necat_tpu_torch.pipeline import cli
from torch_port_helpers import (SMALL_MAP_OPTIONS, as_jax, indel_store,  # noqa: F401
                                jax_static_band, small_store)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = CnsOptions(templates_per_batch=4, pairs_per_chunk=32)


def test_host_stripe_partitions_evenly():
    n_items = 101
    parts = [launcher.host_stripe(n_items, p, 4) for p in range(4)]
    np.testing.assert_array_equal(np.sort(np.concatenate(parts)), np.arange(n_items))
    sizes = [len(p) for p in parts]
    assert max(sizes) - min(sizes) <= 1                            # even split
    np.testing.assert_array_equal(parts[1], np.arange(1, n_items, 4))    # strided
    np.testing.assert_array_equal(launcher.host_stripe(7), np.arange(7))   # one process


@pytest.mark.parametrize("env", [{}, {"NECAT_TPU_NUM_PROCS": "2"},
                                 {"NECAT_TPU_COORDINATOR": "127.0.0.1:1",
                                  "NECAT_TPU_NUM_PROCS": "1"}])
def test_init_multihost_single_process(monkeypatch, env):
    """No coordinator, or a group of one, is a single process: (0, 1), the
    coordinator, a barrier that returns at once."""
    for k in ("NECAT_TPU_COORDINATOR", "NECAT_TPU_NUM_PROCS", "NECAT_TPU_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert launcher.init_multihost() == (0, 1)
    assert launcher.init_multihost() == (0, 1)                     # idempotent
    assert launcher.is_coordinator()
    launcher.barrier("noop")


@pytest.fixture(scope="module")
def stripe_inputs():
    """small_store(G=8000) (13 reads) with the port's candidates, both roles,
    and the same arrays as the JAX package's Candidates."""
    jrs, rs = small_store(G=8000)
    c = find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise=True, device="cpu")
    call = Candidates.concat([c, c.swap_roles()])
    jcall = JaxCandidates(**{f.name: getattr(call, f.name).copy()
                             for f in dataclasses.fields(Candidates)})
    return jrs, rs, jcall, call


def assert_same_records(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.tid, x.left, x.right, x.corrected) == (y.tid, y.left, y.right, y.corrected)
        np.testing.assert_array_equal(x.seq, y.seq)


def test_stripe_matches_jax(jax_static_band, stripe_inputs):
    """One stripe (process 1 of 3): the JAX package's records, templates and
    passthrough both limited to the stripe."""
    jrs, rs, jcall, call = stripe_inputs
    stripe = launcher.host_stripe(rs.n_reads, 1, 3)
    got = correct_reads(rs, call, OPTS, device="cpu", template_ids=stripe)
    assert got and {r.tid for r in got} <= set(stripe.tolist())
    assert any(r.corrected for r in got)
    assert_same_records(got, j_correct_reads(jrs, jcall, as_jax(OPTS), template_ids=stripe))


def test_stripe_union_matches_full(stripe_inputs):
    """tests/test_launcher.py:43's check: three stripes are disjoint, and
    together give the whole run's records, template by template."""
    _, rs, _, call = stripe_inputs

    def by_tid(recs):
        out = {}
        for r in recs:
            out.setdefault(r.tid, []).append(r)
        return out
    full = by_tid(correct_reads(rs, call, OPTS, device="cpu"))
    merged = {}
    for p in range(3):
        part = by_tid(correct_reads(rs, call, OPTS, device="cpu",
                                    template_ids=launcher.host_stripe(rs.n_reads, p, 3)))
        assert not set(part) & set(merged)
        merged.update(part)
    assert set(merged) == set(full)
    for tid, recs in full.items():
        assert_same_records(recs, merged[tid])


def _write_config(tmp_path, name):
    """indel_store(4000)'s reads (10 reads, 27 kb) and a config with
    NUM_ITER=1 (no ladder: the processes cannot share a test's patches)."""
    reads = tmp_path / "reads.fasta"
    if not reads.exists():
        indel_store(4000, 33, 34)[1].to_fasta(reads)
        (tmp_path / "read_list.txt").write_text(f"{reads}\n")
    cfg = tmp_path / f"{name}.cfg"
    cfg.write_text(
        f"PROJECT={tmp_path / name}\nONT_READ_LIST={tmp_path / 'read_list.txt'}\n"
        "GENOME_SIZE=4000\nMIN_READ_LENGTH=1000\nPREP_OUTPUT_COVERAGE=40\n"
        "CNS_OUTPUT_COVERAGE=4\nNUM_ITER=1\nOVLP_SENSITIVE_OPTIONS=-k 13\n")
    return cfg


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_correct_matches_one_process(tmp_path):
    """Two processes of `cli correct --device cpu` joined through gloo (each
    its stripe, the parts exchanged through files) write the one-process
    run's cns_final; the manifest holds both processes' reports."""
    assert cli.main(["correct", str(_write_config(tmp_path, "one")), "--device", "cpu"]) == 0
    cfg = _write_config(tmp_path, "two")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "NECAT_TPU_COORDINATOR": f"127.0.0.1:{_free_port()}", "NECAT_TPU_NUM_PROCS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "necat_tpu_torch.pipeline.cli", "correct", str(cfg),
         "--device", "cpu"], env={**env, "NECAT_TPU_PROC_ID": str(p)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for p in range(2)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]   # a hang fails the test
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    cns = "1-consensus/cns_final.fasta.gz"
    with gzip.open(tmp_path / "one" / cns) as a, gzip.open(tmp_path / "two" / cns) as b:
        one = a.read()
        assert one.count(b">") >= 3 and one == b.read()
    parts = sorted(f.name for f in (tmp_path / "two" / "1-consensus").glob("it0.part*"))
    assert parts == ["it0.part0.fasta.gz", "it0.part1.fasta.gz"]
    done = json.loads((tmp_path / "two" / "1-consensus" / "correct.done.json").read_text())
    assert [len(p["iterations"]) for p in done["by_process"]] == [1, 1]
    assert all(p["iterations"][0]["pairs_by_band"]["128"] for p in done["by_process"])
