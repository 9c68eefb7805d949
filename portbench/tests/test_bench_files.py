"""The benchmark's files: found by name, a new cell made of new files only,
the frozen generator, the imports it may not make, a run without a card."""

from __future__ import annotations

import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO, SEED, make_small_root
from portbench import harness, simulate


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_cells_found_by_name(workload):
    cell = harness.load_cell(REPO, workload)
    job = harness.load_module(REPO / "portbench" / "jobs" / f"{cell.traffic['job']}.py")
    for fn in ("setup", "unit", "release", "check", "control"):
        assert callable(getattr(job, fn)), fn
    for m in cell.per_layer:
        reader = harness.load_module(REPO / "portbench" / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)
        if hasattr(reader, "SPAN"):
            assert (REPO / "portbench" / "spans" / f"{reader.SPAN}.py").exists()
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert set(names) - {"setup_s"} <= set(cell.traffic["rates"])


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_cell_from_new_files_only(tmp_path):
    root = make_small_root(tmp_path)
    before = _digests(root / "portbench")
    # a new configuration, traffic mix and per-layer metric, as files of
    # their own, and their entries in BENCHMARK.json
    cfg = json.loads((root / "portbench/configs/ecoli-ont-40x.json").read_text())
    cfg.update(name="tiny-fixed-cutoff",
               cns_options="-a 2000 -x 4 -y 12 -l 1000 -e 0.5 -p 0.8 -u 1 -r 0 -f 1")
    (root / "portbench/configs/tiny-fixed-cutoff.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/cns-again.json").write_text(json.dumps(
        {"job": "correction", "check_templates": 2, "warm_every": 8,
         "rates": {"cns_again_Mb_per_s": {"counter": "template_bases", "scale": 1e-6}}}))
    (root / "portbench/metrics/window_s.tiny.py").write_text(
        "def read(obs):\n    return obs['window_s']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-fixed-cutoff", "source": "test",
                             "file": "portbench/configs/tiny-fixed-cutoff.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "tiny.cns", "config": "tiny-fixed-cutoff",
                               "traffic": "cns-again", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "cns_again_Mb_per_s", "unit": "Mb/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny.cns"]})
    bench["per_layer"].append({"name": "window_s.tiny", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "test",
                               "moves": "cns_again_Mb_per_s", "workloads": ["tiny.cns"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    log = io.StringIO()
    r0 = harness.run("tiny.cns", SEED, 0.01, False, root=root, device="cpu", log=log)
    r1 = harness.run("tiny.cns", SEED, 0.01, True, root=root, device="cpu", log=log)
    assert r0["correct"] and r1["correct"]
    assert set(r0["metrics"]) == {"cns_again_Mb_per_s", "setup_s"}
    assert "window_s.tiny" in r1["metrics"]
    after = _digests(root / "portbench")
    assert {p: d for p, d in after.items() if p in before} == before


def test_generator_reproduces_benchdata():
    from necat_tpu_torch.utils.benchdata import gen_benchmark_reads
    genome, store, (st, sd, ln) = gen_benchmark_reads(60_000, 8, seed=2**31 + 3)
    g2, reads, (st2, sd2, ln2) = simulate.bench_reads(60_000, 8, 2**31 + 3)
    assert np.array_equal(genome, g2)
    assert store.n_reads == len(reads)
    assert np.array_equal(store.bases, np.concatenate(reads))
    for x, y in ((st, st2), (sd, sd2), (ln, ln2)):
        assert np.array_equal(x, y)


_IMPORTS = """
import sys, json
sys.path.insert(0, {repo!r})
import pathlib
from portbench import harness, inputs, bound, trace, readers, simulate, sets
root = pathlib.Path({repo!r})
for sub in ("jobs", "metrics", "spans"):
    for p in sorted((root / "portbench" / sub).glob("*.py")):
        harness.load_module(p)
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(extra: str = "") -> set:
    out = subprocess.run([sys.executable, "-c", _IMPORTS.format(repo=str(REPO), extra=extra)],
                         capture_output=True, text=True, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_no_jax_or_jax_package_imported():
    # the jobs' imports of the port happen inside their functions: run one
    # small cell in the same process to load what a run loads
    extra = (f"import tempfile; sys.path.insert(0, {str(REPO / 'portbench' / 'tests')!r})\n"
             "from conftest import make_small_root\n"
             "r = make_small_root(pathlib.Path(tempfile.mkdtemp()))\n"
             "harness.run('ecoli40x.cns', 5, 0.01, True, root=r, device='cpu')\n")
    top = _top_level(extra)
    assert "necat_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "necat_tpu"}


def test_reference_imports_nothing_of_the_port():
    extra = "\n".join(f"import portbench.reference.{p.stem}"
                      for p in sorted((REPO / "portbench/reference").glob("*.py")))
    top = _top_level(extra)
    assert not top & {"jax", "jaxlib", "flax", "necat_tpu", "necat_tpu_torch"}


def test_run_without_card_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, str(REPO / "portbench" / "run.py"), "--workload",
                        "ecoli40x.cns", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, env=env, capture_output=True, text=True)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
