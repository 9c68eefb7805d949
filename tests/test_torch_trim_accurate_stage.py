"""The port's TRIM_METHOD=accurate stage against the JAX package's Project
on the small genome of test_torch_assemble_stage.py, files byte for
byte."""

import json

from necat_tpu.pipeline import config as jax_config
from necat_tpu.pipeline.stages import Project as JaxProject
from necat_tpu_torch.pipeline import cli
from tests.test_torch_assemble_stage import _write_asm_config
from tests.test_torch_bridge_stage import _mtimes, _same_files
from torch_port_helpers import cap_max_band, jax_static_band  # noqa: F401


def test_cli_accurate_trim_matches_jax(jax_static_band, monkeypatch, tmp_path):
    """Correct in both packages, then TRIM_METHOD=accurate in both configs
    (every ladder off: MAX_BAND 256; no polish): `cli assemble --device
    cpu` skips correct by its manifest, and trim and assemble write the JAX
    package's trimReads.fasta.gz and contigs."""
    cap_max_band(monkeypatch, 256)
    cfgs = {name: _write_asm_config(tmp_path, name) for name in ("jax", "torch")}
    jcfg = jax_config.load_config(cfgs["jax"])
    JaxProject(jcfg, jcfg.project).run_correct()
    assert cli.main(["correct", str(cfgs["torch"]), "--device", "cpu"]) == 0
    cns = "1-consensus/cns_final.fasta.gz"
    _same_files(tmp_path, [cns])
    before = _mtimes(tmp_path, [cns])

    for cfg in cfgs.values():
        cfg.write_text(cfg.read_text() + "TRIM_METHOD=accurate\nPOLISH_CONTIGS=false\n")
    jcfg = jax_config.load_config(cfgs["jax"])
    JaxProject(jcfg, jcfg.project).run_assemble()
    assert cli.main(["assemble", str(cfgs["torch"]), "--device", "cpu"]) == 0
    assert _mtimes(tmp_path, [cns]) == before
    _same_files(tmp_path, ("trimReads.fasta.gz", "4-fsa/contigs.fasta"))
    trim = json.loads((tmp_path / "torch" / "2-trim_bases" / "trim.done.json").read_text())
    assert json.loads(trim["params"])["method"] == "accurate" and trim["cns_s"] > 0
