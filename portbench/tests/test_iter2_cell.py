"""The cell ecoli40x.cns-iter2 at a size the CPU holds: found by name, a
sound run passes, its controls (the reference's ladder off, bfloat16 pair
weights) fail, and a program that ignores -r 1 comes out not correct.

Its own small root: make_small_root, then this cell's traffic cut to
check_templates 4 and warm_every 4. At 8X of a 16 kb genome no pair hangs
by itself, so the raw reads get an insertion of PLANTED bases in the
middle of every third read: pairs across it in iteration 2 climb the
ladder."""

from __future__ import annotations

import dataclasses
import io
import json

import numpy as np
import pytest

from conftest import REPO, SEED, make_small_root
from portbench import harness

CELL = "ecoli40x.cns-iter2"
PLANTED = 150
# the layers this cell shares with ecoli40x.cns, read by that cell's readers
SHARED = ("ext_roofline", "device_idle", "scatter_sync_share", "scatter_device_share",
          "desc_upload_share", "ext_lane_fill", "cns_compact_share", "cns_emit_share")


def _planted(real):
    def raw_reads(config, seed):
        reads = real(config, seed)
        rng = np.random.default_rng(seed)
        for i in range(0, len(reads), 3):
            m = len(reads[i]) // 2
            reads[i] = np.concatenate([reads[i][:m],
                                       rng.integers(0, 4, PLANTED).astype(np.uint8),
                                       reads[i][m:]])
        return reads
    return raw_reads


@pytest.fixture(scope="module")
def planted():
    from portbench import inputs
    mp = pytest.MonkeyPatch()
    mp.setattr(inputs, "raw_reads", _planted(inputs.raw_reads))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def iter2_root(tmp_path_factory, planted):
    import torch
    torch.set_num_threads(2)
    root = make_small_root(tmp_path_factory.mktemp("iter2"))
    p = root / "portbench" / "traffic" / "cns-iter2.json"
    p.write_text(json.dumps({**json.loads(p.read_text()), "check_templates": 4,
                             "warm_every": 4}))
    return root


@pytest.fixture(scope="module")
def iter2_state(iter2_root):
    """The job after its set-up and one unit, released as the harness
    releases it before the check."""
    cell = harness.load_cell(iter2_root, CELL)
    job = harness.load_module(iter2_root / "portbench" / "jobs" / f"{cell.traffic['job']}.py")
    st = job.setup({"config": cell.config, "traffic": cell.traffic, "seed": SEED,
                    "device": "cpu", "log": io.StringIO()})
    job.unit(st, 0)
    job.release(st)
    return job, st


def test_cell_found_by_name():
    cell = harness.load_cell(REPO, CELL)
    assert cell.traffic["job"] == "correction_iter2"
    assert "-r 1" in cell.config["cns_options"] and "-f 0" in cell.config["cns_options"]
    assert "-r 0" in cell.config["it1_cns_options"] and "-f 1" in cell.config["it1_cns_options"]
    names = {m["name"] for m in cell.per_layer}
    assert names == {"rescue_share.iter2", "rung_lane_share.iter2"} | {
        f"{m}.iter2" for m in SHARED}
    assert [m["name"] for m in cell.end_to_end] == ["cns_Mb_per_s", "setup_s"]


@pytest.mark.parametrize("name", SHARED)
def test_shared_layers_read_as_in_ecoli40x_cns(name):
    """Each .iter2 reader of a shared layer is its .cns reader: the same
    SPAN and the same reading of one observation."""
    d = REPO / "portbench" / "metrics"
    cns, it2 = (harness.load_module(d / f"{name}.{c}.py") for c in ("cns", "iter2"))
    assert getattr(it2, "SPAN", None) == getattr(cns, "SPAN", None)
    obs = {"window_s": 10.0, "busy_s": 6.0, "delta": None,
           "spans": {s: {"device_s": 2.0, "least_s": 0.5, "calls": 3}
                     for s in ("extend_batch", "cns.tag_scatter")},
           "scopes": {"cns.scatter_sync": 1.5, "cns.fused_desc_up": 0.5,
                      "ext.desc_upload": 0.25, "ext.live_Mcols": 3.0, "ext.cell_Mlanes": 4.0,
                      "cns.compact": 0.75, "cns.emit_records": 0.1}}
    assert it2.read(obs) is not None and it2.read(obs) == cns.read(obs)


def test_sound_run_passes_and_controls_fail(iter2_state):
    """The check passes on the program's records, bands and votes of the
    window's unit; the controls, each in the program's place on the same
    sample, fail it: the reference with its ladder off (records, bands and
    votes), and the reference with bfloat16 pair weights (votes)."""
    job, st = iter2_state
    checks = job.check(st, np.random.default_rng(1))
    assert set(checks) == {"records_differ", "bands_differ", "vote_weight_ppm"}
    assert all(v <= lim for v, lim in checks.values()), checks
    assert st["seen"][0]["bands"] and st["seen"][0]["votes"]
    control = job.control(st, np.random.default_rng(1))
    assert control["climbed"] > 0
    for k in ("records_differ", "bands_differ", "vote_weight_ppm"):
        assert control[k] > checks[k][1], control
    assert control["vote_weight_ppm_bf16"] > checks["vote_weight_ppm"][1], control


def _ladder_ignored(real):
    """correct_reads that runs -r 0 whatever its options say."""
    def fake(store, cands, opts, **kw):
        return real(store, cands, dataclasses.replace(opts, rescue_long_indels=False), **kw)
    return fake


def test_program_ignoring_the_ladder_is_not_correct(iter2_root, monkeypatch):
    import necat_tpu_torch.consensus.correct as mod
    monkeypatch.setattr(mod, "correct_reads", _ladder_ignored(mod.correct_reads))
    r = harness.run(CELL, SEED, 0.01, False, root=iter2_root, device="cpu",
                    log=io.StringIO())
    assert r["correct"] is False
    assert r["checks"]["bands_differ"]["value"] > 0
