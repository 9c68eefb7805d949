"""The correct stage at scale settings (SMALL_MEMORY, VOL_SIZE) against the
JAX package's Project.run_correct, and the stage runner's retries and
profiler."""

import gzip
import json
import os

import pytest
import torch

from necat_tpu.pipeline import config as jax_config
from necat_tpu.pipeline.stages import Project as JaxProject
from necat_tpu_torch.pipeline import cli, stages
from necat_tpu_torch.pipeline import config as config_mod
from necat_tpu_torch.pipeline.stages import Project
from torch_port_helpers import indel_store, jax_static_band  # noqa: F401


def _write_config(tmp_path, name, extra=""):
    """indel_store(4000)'s reads (10 reads, 27 kb) and a config with
    NUM_ITER=1 (test_torch_stages.py's pattern, one iteration)."""
    reads = tmp_path / "reads.fasta"
    if not reads.exists():
        indel_store(4000, 33, 34)[1].to_fasta(reads)
        (tmp_path / "read_list.txt").write_text(f"{reads}\n")
    cfg = tmp_path / f"{name}.cfg"
    cfg.write_text(
        f"PROJECT={tmp_path / name}\nONT_READ_LIST={tmp_path / 'read_list.txt'}\n"
        "GENOME_SIZE=4000\nMIN_READ_LENGTH=1000\nPREP_OUTPUT_COVERAGE=40\n"
        "CNS_OUTPUT_COVERAGE=4\nNUM_ITER=1\nOVLP_SENSITIVE_OPTIONS=-k 13\n" + extra)
    return cfg


def test_cli_correct_small_memory_and_volumes_match_jax(jax_static_band, tmp_path):
    """`cli correct` with SMALL_MEMORY=1, and with VOL_SIZE=10000 (four
    subject volumes, one index build each), writes the cns_final of the JAX
    package's run_correct with both settings."""
    cfg = jax_config.load_config(_write_config(
        tmp_path, "jax", "SMALL_MEMORY=1\nVOL_SIZE=10000\n"))
    with gzip.open(JaxProject(cfg, cfg.project).run_correct()) as f:
        want = f.read()
    assert want.count(b">") >= 3
    for name, extra in (("small", "SMALL_MEMORY=1\n"), ("vol", "VOL_SIZE=10000\n")):
        assert cli.main(["correct", str(_write_config(tmp_path, name, extra)),
                         "--device", "cpu"]) == 0
        with gzip.open(tmp_path / name / "1-consensus" / "cns_final.fasta.gz") as f:
            assert f.read() == want, name
    done = json.loads((tmp_path / "vol" / "1-consensus" / "correct.done.json").read_text())
    assert len(done["iterations"][0]["index_build_s"]) == 4


def test_stage_retries_then_gives_up(tmp_path, monkeypatch):
    """A stage that fails once runs again and writes its manifest; one that
    keeps failing raises after NECAT_TPU_MAX_STAGE_ERROR attempts."""
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("first attempt fails")
        return {"attempts": len(calls)}
    assert stages._stage(str(tmp_path / "a"), "flaky", [], [], {}, flaky)
    assert json.loads((tmp_path / "a" / "flaky.done.json").read_text())["attempts"] == 2

    def broken():
        calls.append(1)
        raise RuntimeError("always fails")
    monkeypatch.setenv("NECAT_TPU_MAX_STAGE_ERROR", "2")
    calls.clear()
    with pytest.raises(RuntimeError, match="always fails"):
        stages._stage(str(tmp_path / "b"), "broken", [], [], {}, broken)
    assert len(calls) == 2 and not (tmp_path / "b" / "broken.done.json").exists()


def test_profile_writes_a_trace_per_stage(tmp_path, monkeypatch):
    """NECAT_TPU_PROFILE=<dir>: each stage that runs leaves a Chrome trace
    <dir>/<stage>/process0.json; a stage skipped by its manifest leaves none."""
    monkeypatch.setenv("NECAT_TPU_PROFILE", str(tmp_path / "prof"))
    for name in ("one", "two"):
        stages._stage(str(tmp_path / "w"), name, [], [], {},
                      lambda: {"sum": float(torch.arange(10.0).sum())})
    assert not stages._stage(str(tmp_path / "w"), "one", [], [], {}, lambda: None)
    assert sorted(os.listdir(tmp_path / "prof")) == ["one", "two"]
    for name in ("one", "two"):
        assert os.listdir(tmp_path / "prof" / name) == ["process0.json"]
        with open(tmp_path / "prof" / name / "process0.json") as f:
            assert json.load(f)["traceEvents"]


def test_cleanup_removes_parts_and_overlaps(tmp_path):
    """CLEANUP=1 removes the processes' part files and the overlap file and
    keeps the stage outputs and manifests (necat_tpu's Project.cleanup)."""
    cfg = config_mod.load_config(_write_config(tmp_path, "clean"))
    prj = Project(cfg, cfg.project)
    gone = ["1-consensus/it0.part0.fasta.gz", "1-consensus/it1.part1.fasta.gz",
            "4-fsa/pm.m4.gz", "final-polish/part0.fasta.gz"]
    kept = ["1-consensus/cns_final.fasta.gz", "1-consensus/correct.done.json",
            "4-fsa/contigs.fasta", "polished_contigs.fasta"]
    for f in gone + kept:
        os.makedirs(os.path.dirname(prj.path(f)), exist_ok=True)
        open(prj.path(f), "w").close()
    prj.cleanup()
    assert [f for f in gone + kept if os.path.exists(prj.path(f))] == kept
