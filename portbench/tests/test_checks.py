"""What decides `correct`, at a size the CPU holds: each cell's control
fails its comparison, a sound run passes, and a run with the program
broken underneath its timed path comes out not correct."""

from __future__ import annotations

import io

import numpy as np
import pytest

from conftest import SEED
from portbench import harness

CELLS = ("ecoli40x.cns",)


def _setup(root, workload):
    cell = harness.load_cell(root, workload)
    job = harness.load_module(root / "portbench" / "jobs" / f"{cell.traffic['job']}.py")
    st = job.setup({"config": cell.config, "traffic": cell.traffic, "seed": SEED,
                    "device": "cpu", "log": io.StringIO()})
    for i in range(2):
        job.unit(st, i)
    job.release(st)
    return job, st


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_passes_and_control_fails(small_root, workload):
    job, st = _setup(small_root, workload)
    checks = job.check(st, np.random.default_rng(1))
    assert all(v <= lim for v, lim in checks.values()), checks
    control = job.control(st, np.random.default_rng(1))
    assert any(control[k] > lim for k, (_, lim) in checks.items()), control


def _unchanged_reads(real):
    """correct_reads that returns every template as it came in."""
    def fake(store, cands, opts, *, device, template_ids=None, **kw):
        from necat_tpu_torch.consensus.correct import CnsRecord
        ids = range(store.n_reads) if template_ids is None else template_ids
        return [CnsRecord(tid=int(t), left=0, right=int(store.lengths[t]),
                          org_size=int(store.lengths[t]), seq=store.get(int(t)),
                          corrected=False) for t in ids]
    return fake


def _half_templates(real):
    """correct_reads over every other template only."""
    def fake(store, cands, opts, *, template_ids=None, **kw):
        ids = np.arange(store.n_reads) if template_ids is None else np.asarray(template_ids)
        return real(store, cands, opts, template_ids=ids[::2], **kw)
    return fake


def _altered_records(real):
    def fake(*a, **kw):
        recs = real(*a, **kw)
        for r in recs:
            r.seq = r.seq.copy()
            r.seq[len(r.seq) // 2] ^= 1
        return recs
    return fake


FAULTS = [
    ("ecoli40x.cns", "necat_tpu_torch.consensus.correct", "correct_reads", _unchanged_reads),
    ("ecoli40x.cns", "necat_tpu_torch.consensus.correct", "correct_reads", _half_templates),
    ("ecoli40x.cns", "necat_tpu_torch.consensus.correct", "correct_reads", _altered_records),
]


@pytest.mark.parametrize("workload,module,name,fault", FAULTS,
                         ids=[f"{w}-{f.__name__.strip('_')}" for w, _, _, f in FAULTS])
def test_broken_program_is_not_correct(small_root, monkeypatch, workload, module, name, fault):
    import importlib
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    r = harness.run(workload, SEED, 0.01, False, root=small_root, device="cpu",
                    log=io.StringIO())
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_reference_search_matches_port_on_cpu(small_root):
    """The reference's candidate rows of every query equal the port's own
    CPU search (the witness that sides with the reference where the card
    departs from both, PERF.md section 7)."""
    from necat_tpu_torch.io.readstore import ReadStore
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.overlap.overlapper import find_all_candidates

    from portbench import inputs
    from portbench.reference import search as S
    cfg = harness.load_cell(small_root, "ecoli40x.cns").config
    reads = inputs.raw_reads(cfg, SEED)
    store = ReadStore.from_seqs(reads)
    port = find_all_candidates(store, store, MapOptions.from_string(cfg["ovlp_options"]),
                               pairwise=True, device="cpu")
    o = S.parse_map_options(cfg["ovlp_options"])
    vol = S.Volume(reads, o["k"], "cpu")
    ref = [r for q in range(len(reads)) for r in S.query_rows(vol, q, o)]
    assert len(ref) > 0
    assert inputs.rows_differ(port, ref) == 0
    for t in range(0, len(reads), 3):
        mine = port.take(np.flatnonzero(port.sid == t))
        assert inputs.rows_differ(mine, S.subject_rows(vol, t, o)) == 0


@pytest.mark.cuda
def test_cns_cell_on_card(card):
    """A short run of the cell through run.py on the card."""
    import json
    import subprocess
    import sys

    from conftest import REPO
    p = subprocess.run([sys.executable, str(REPO / "portbench" / "run.py"), "--workload",
                        "ecoli40x.cns", "--seed", str(SEED), "--seconds", "2",
                        "--trace", "0"], cwd=REPO, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
