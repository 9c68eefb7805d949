"""The port's correct stage and command line against the JAX package's."""

import json

import numpy as np
import pytest
import torch

from necat_tpu.pipeline import config as jax_config
from necat_tpu.pipeline.stages import Project as JaxProject
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.pipeline import cli
from necat_tpu_torch.pipeline import config as config_mod
from necat_tpu_torch.pipeline.stages import Project
from necat_tpu_torch.utils import shapes
from torch_port_helpers import cap_max_band, indel_store, jax_static_band_wide  # noqa: F401


def _write_config(tmp_path, name, extra=""):
    """Reads of a 4 kb genome (some with planted insertions) and a config
    with NUM_ITER=2: iteration 1 corrects with -r 0, iteration 2 with -r 1
    (the rescue ladder)."""
    reads = tmp_path / "reads.fasta"
    if not reads.exists():
        indel_store(4000, 33, 34)[1].to_fasta(reads)
        (tmp_path / "read_list.txt").write_text(f"{reads}\n")
    cfg = tmp_path / f"{name}.cfg"
    cfg.write_text(
        f"PROJECT={tmp_path / name}\nONT_READ_LIST={tmp_path / 'read_list.txt'}\n"
        "GENOME_SIZE=4000\nMIN_READ_LENGTH=1000\nPREP_OUTPUT_COVERAGE=40\n"
        "CNS_OUTPUT_COVERAGE=4\nNUM_ITER=2\nOVLP_SENSITIVE_OPTIONS=-k 13\n"
        "OVLP_FAST_OPTIONS=-k 13\n" + extra)
    return cfg


def test_run_correct_matches_jax(jax_static_band_wide, monkeypatch, tmp_path):
    """The command line's correct: two iterations (the second with the
    rescue ladder, shapes.MAX_BAND capped at 512 for both packages) write
    the same cns_final as the JAX package's Project.run_correct; a second
    run skips the stage."""
    cap_max_band(monkeypatch, 512)
    cfg = jax_config.load_config(_write_config(tmp_path, "jax"))
    out_j = JaxProject(cfg, cfg.project).run_correct()
    assert cli.main(["correct", str(_write_config(tmp_path, "torch")),
                     "--device", "cpu"]) == 0
    out_t = tmp_path / "torch" / "1-consensus" / "cns_final.fasta.gz"
    a, b = ReadStore.from_fasta(out_t), ReadStore.from_fasta(out_j)
    assert 3 <= a.n_reads < ReadStore.from_fasta(tmp_path / "reads.fasta").n_reads
    assert list(a.names) == list(b.names)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.bases, b.bases)
    done = json.loads((tmp_path / "torch" / "1-consensus" / "correct.done.json").read_text())
    assert done["rc"] == 0
    its = done["iterations"]          # per iteration: seconds and pairs by band
    assert len(its) == 2 and all(i["candidates_s"] > 0 and i["correct_s"] > 0 for i in its)
    assert set(its[0]["pairs_by_band"]) == {"128"}             # -r 0: no ladder
    assert set(its[1]["pairs_by_band"]) <= {"128", "512"} and its[1]["pairs_by_band"]["128"]
    mtime = (tmp_path / "torch" / "1-consensus" / "cns_final.fasta.gz").stat().st_mtime_ns
    cfg = config_mod.load_config(tmp_path / "torch.cfg")
    Project(cfg, cfg.project).run_correct(device="cpu")
    assert (tmp_path / "torch" / "1-consensus" / "cns_final.fasta.gz").stat().st_mtime_ns \
        == mtime


def test_run_correct_refuses_unported_modes(tmp_path, monkeypatch):
    """NECAT_TPU_NUM_PROCS=2 without a coordinator runs as one process (no
    part files, no per-process reports), as in the JAX package; trim on a
    read set at or past shapes.DEVICE_STORE_MAX_BASES (lowered here) is
    still refused: its extension needs the whole set on the device."""
    monkeypatch.setenv("NECAT_TPU_NUM_PROCS", "2")
    monkeypatch.delenv("NECAT_TPU_COORDINATOR", raising=False)
    cfg = config_mod.load_config(_write_config(tmp_path, "hosts", "NUM_ITER=1\n"))
    out = Project(cfg, cfg.project).run_correct(device="cpu")
    assert ReadStore.from_fasta(out).n_reads >= 3
    assert not list((tmp_path / "hosts" / "1-consensus").glob("it*.part*"))
    done = json.loads((tmp_path / "hosts" / "1-consensus" / "correct.done.json").read_text())
    assert "by_process" not in done
    reads = ReadStore.from_fasta(tmp_path / "reads.fasta")
    monkeypatch.setattr(shapes, "DEVICE_STORE_MAX_BASES", reads.total_bases)
    monkeypatch.setattr(Project, "run_correct",
                        lambda self, device="cuda": str(tmp_path / "reads.fasta"))
    cfg = config_mod.load_config(_write_config(tmp_path, "vol"))
    with pytest.raises(NotImplementedError, match="DEVICE_STORE_MAX_BASES"):
        Project(cfg, cfg.project).run_trim(device="cpu")


def test_cli(tmp_path, capsys):
    cfg = tmp_path / "t.cfg"
    assert cli.main(["config", str(cfg)]) == 0
    assert config_mod.load_config(cfg).num_iter == 2
    if not torch.cuda.is_available():
        for cmd in ("correct", "assemble", "bridge"):      # the default device is cuda
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cli.main([cmd, str(cfg)])
    with pytest.raises(SystemExit):
        cli.main(["correct", str(cfg), "--device", "tpu"])
