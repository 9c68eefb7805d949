"""Fixtures of the benchmark's own tests: a copy of the benchmark with its
cells cut to a size the CPU runs in seconds, and the check for a card."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SMALL_READS = {"mean_len": 6000, "min_len": 3000, "max_len": 12000,
               "sub": 0.05, "ins": 0.05, "dele": 0.05}
SMALL = {"genome_size": 16000, "coverage": 8, "reads": SMALL_READS}
SMALL_TRAFFIC = {"cns": {"check_templates": 4, "warm_every": 4}}
SEED = 2**31 + 11


def make_small_root(dst: Path) -> Path:
    """BENCHMARK.json and portbench/ copied under dst, every configuration
    cut to a 16 kb genome at 8X and the checks to few answers."""
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(SMALL)
        (dst / c["file"]).write_text(json.dumps(cfg))
    for name, upd in SMALL_TRAFFIC.items():
        p = dst / "portbench" / "traffic" / f"{name}.json"
        p.write_text(json.dumps({**json.loads(p.read_text()), **upd}))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    import torch
    torch.set_num_threads(2)
    return make_small_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
