"""The port's assemble command (correct, trim, assemble, polish) against
the JAX package's Project.run_assemble + run_polish on a small genome."""

import gzip
import json

import pytest

from necat_tpu.pipeline import config as jax_config
from necat_tpu.pipeline.stages import Project as JaxProject
from necat_tpu_torch.io import simulate
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.pipeline import cli
from necat_tpu_torch.pipeline import config as config_mod
from necat_tpu_torch.pipeline.stages import Project
from necat_tpu_torch.utils import shapes
from torch_port_helpers import cap_max_band, jax_static_band  # noqa: F401


ASM_OUTPUTS = ("1-consensus/cns_final.fasta.gz", "trimReads.fasta.gz", "4-fsa/pm.m4.gz",
               "4-fsa/contigs.fasta", "4-fsa/bubbles.fasta", "4-fsa/contig_tiles",
               "4-fsa/bubble_tiles", "4-fsa/readinfos.json", "4-fsa/readinfos.txt",
               "polished_contigs.fasta")


def _write_asm_config(tmp_path, name, extra=""):
    """Reads of a 5 kb genome (8x, 1.5-3 kb, 2.5 % error per kind) and a
    config with NUM_ITER=1 and POLISH_CONTIGS=true; the overlap filter's
    length thresholds are lowered to the reads' length."""
    reads = tmp_path / "asm_reads.fasta"
    if not reads.exists():
        genome = simulate.random_genome(5000, seed=77)
        seqs, *_ = simulate.simulate_reads(
            genome, coverage=8, mean_len=2200, min_len=1500, max_len=3000,
            em=simulate.ErrorModel(sub=0.025, ins=0.025, dele=0.025), seed=3,
            circular=False)
        ReadStore.from_seqs(seqs).to_fasta(reads)
        (tmp_path / "asm_list.txt").write_text(f"{reads}\n")
    cfg = tmp_path / f"{name}.cfg"
    cfg.write_text(
        f"PROJECT={tmp_path / name}\nONT_READ_LIST={tmp_path / 'asm_list.txt'}\n"
        "GENOME_SIZE=5000\nMIN_READ_LENGTH=1000\nPREP_OUTPUT_COVERAGE=40\n"
        "CNS_OUTPUT_COVERAGE=30\nNUM_ITER=1\nPOLISH_CONTIGS=true\n"
        "OVLP_SENSITIVE_OPTIONS=-k 13\nTRIM_OVLP_OPTIONS=-k 13\nASM_OVLP_OPTIONS=-k 13\n"
        "FSA_OL_FILTER_OPTIONS=--min_length=1000 --min_aligned_length=800\n" + extra)
    return cfg


def test_run_assemble_matches_jax(jax_static_band, monkeypatch, tmp_path):
    """The command line's assemble (correct, trim, assemble, polish; every
    ladder off: shapes.MAX_BAND 256 in both packages) writes the same files
    as the JAX package's Project.run_assemble + run_polish; a second run
    skips every stage; an edit of FSA_OL_FILTER_OPTIONS reruns assemble and
    polish only."""
    cap_max_band(monkeypatch, 256)
    cfg = jax_config.load_config(_write_asm_config(tmp_path, "jax"))
    prj = JaxProject(cfg, cfg.project)
    prj.run_polish(prj.run_assemble(), "final")
    cfg_t = _write_asm_config(tmp_path, "torch")
    assert cli.main(["assemble", str(cfg_t), "--device", "cpu"]) == 0
    for f in ASM_OUTPUTS:
        op = gzip.open if f.endswith(".gz") else open
        with op(tmp_path / "jax" / f, "rb") as a, op(tmp_path / "torch" / f, "rb") as b:
            assert a.read() == b.read(), f
    ctg = ReadStore.from_fasta(tmp_path / "torch" / "4-fsa" / "contigs.fasta")
    assert ctg.n_reads >= 1 and ctg.lengths.max() >= 2500

    def done(stage_dir, name):
        return json.loads((tmp_path / "torch" / stage_dir / f"{name}.done.json").read_text())
    assert done("2-trim_bases", "trim")["trim_s"] >= 0
    assert done("4-fsa", "assemble")["overlap_s"] > 0
    pol = done("final-polish", "polish")
    assert set(pol["seconds_by_part"]) >= {"map", "waves", "consensus", "compact"}
    assert set(pol["pairs_by_band"]) == {"256"}

    outs = {f: (tmp_path / "torch" / f).stat().st_mtime_ns for f in ASM_OUTPUTS}
    assert cli.main(["assemble", str(cfg_t), "--device", "cpu"]) == 0
    assert {f: (tmp_path / "torch" / f).stat().st_mtime_ns for f in ASM_OUTPUTS} == outs
    cfg_t.write_text(cfg_t.read_text().replace("--min_aligned_length=800",
                                               "--min_aligned_length=900"))
    assert cli.main(["assemble", str(cfg_t), "--device", "cpu"]) == 0
    again = {f: (tmp_path / "torch" / f).stat().st_mtime_ns for f in ASM_OUTPUTS}
    assert [f for f in ASM_OUTPUTS if again[f] != outs[f]] == [
        "4-fsa/pm.m4.gz", "4-fsa/contigs.fasta", "4-fsa/bubbles.fasta",
        "4-fsa/contig_tiles", "4-fsa/bubble_tiles", "4-fsa/readinfos.json",
        "4-fsa/readinfos.txt", "polished_contigs.fasta"]


@pytest.mark.parametrize("extra", ["SMALL_MEMORY=1\n", "VOL_SIZE=100000\n"])
def test_run_assemble_refuses_unported_modes(tmp_path, monkeypatch, extra):
    """Assemble and polish on a read set at or past
    shapes.DEVICE_STORE_MAX_BASES (lowered here to the raw reads' size) are
    refused before any work, SMALL_MEMORY and VOL_SIZE notwithstanding: their
    extension needs the whole set on the device, as in the JAX package. The
    stages before them are stubbed out."""
    cfg = config_mod.load_config(_write_asm_config(tmp_path, "refused", extra))
    reads = tmp_path / "asm_reads.fasta"
    monkeypatch.setattr(shapes, "DEVICE_STORE_MAX_BASES",
                        ReadStore.from_fasta(reads).total_bases)
    monkeypatch.setattr(Project, "run_trim", lambda self, device="cuda": str(reads))
    prj = Project(cfg, cfg.project)
    with pytest.raises(NotImplementedError, match="DEVICE_STORE_MAX_BASES"):
        prj.run_assemble(device="cpu")
    with pytest.raises(NotImplementedError, match="DEVICE_STORE_MAX_BASES"):
        prj.run_polish(str(reads), "final", device="cpu")
    assert not (tmp_path / "refused" / "4-fsa" / "contigs.fasta").exists()
    assert not (tmp_path / "refused" / "polished_contigs.fasta").exists()
