"""The port's bridge command (correct, trim, assemble, bridge, polish)
against the JAX package's Project on the small genome of
test_torch_assemble_stage.py, files byte for byte."""

import gzip
import json

from necat_tpu.pipeline import config as jax_config
from necat_tpu.pipeline.stages import Project as JaxProject
from necat_tpu_torch.pipeline import cli
from tests.test_torch_assemble_stage import _write_asm_config
from torch_port_helpers import cap_max_band, jax_static_band  # noqa: F401

BRIDGE_OUTPUTS = ("4-fsa/contigs.fasta", "6-bridge_contigs/bridged_contigs.fasta",
                  "polished_contigs.fasta")


def _same_files(tmp_path, files):
    for f in files:
        op = gzip.open if f.endswith(".gz") else open
        with op(tmp_path / "jax" / f, "rb") as a, op(tmp_path / "torch" / f, "rb") as b:
            assert a.read() == b.read(), f


def _mtimes(tmp_path, files):
    return {f: (tmp_path / "torch" / f).stat().st_mtime_ns for f in files}


def test_cli_bridge_matches_jax(jax_static_band, monkeypatch, tmp_path):
    """`cli bridge --device cpu` writes the JAX package's bridged and
    polished contigs (every ladder off: MAX_BAND 256 in both packages); a
    rerun skips every stage; an edit of FSA_CTG_BRIDGE_OPTIONS reruns bridge
    and polish only."""
    cap_max_band(monkeypatch, 256)
    cfgs = {}
    for name in ("jax", "torch"):
        cfgs[name] = _write_asm_config(tmp_path, name, "FSA_CTG_BRIDGE_OPTIONS=\n")
    jcfg = jax_config.load_config(cfgs["jax"])
    jprj = JaxProject(jcfg, jcfg.project)
    jprj.run_polish(jprj.run_bridge(), "final")
    assert cli.main(["bridge", str(cfgs["torch"]), "--device", "cpu"]) == 0
    _same_files(tmp_path, BRIDGE_OUTPUTS)
    done = json.loads((tmp_path / "torch" / "6-bridge_contigs" / "bridge.done.json").read_text())
    assert done["contigs_in"] >= 1 and done["contigs_out"] >= 1
    assert {"map_s", "c2c_s", "graph_s", "junction_s"} <= set(done)

    outs = _mtimes(tmp_path, BRIDGE_OUTPUTS)
    assert cli.main(["bridge", str(cfgs["torch"]), "--device", "cpu"]) == 0
    assert _mtimes(tmp_path, BRIDGE_OUTPUTS) == outs
    cfgs["torch"].write_text(cfgs["torch"].read_text().replace(
        "FSA_CTG_BRIDGE_OPTIONS=", "FSA_CTG_BRIDGE_OPTIONS=--window_size=800"))
    assert cli.main(["bridge", str(cfgs["torch"]), "--device", "cpu"]) == 0
    again = _mtimes(tmp_path, BRIDGE_OUTPUTS)
    assert [f for f in BRIDGE_OUTPUTS if again[f] != outs[f]] == [
        "6-bridge_contigs/bridged_contigs.fasta", "polished_contigs.fasta"]
