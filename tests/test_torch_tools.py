"""The port's read and overlap tools (pipeline/tools.py), DUST masking and
the M4 text formats against the JAX package's: the same inputs, identical
output bytes and arrays."""

import dataclasses
import gzip

import numpy as np
import pytest

from necat_tpu.overlap.m4 import M4Records as JaxM4Records
from necat_tpu.pipeline import tools as jtools
from necat_tpu.utils import dust as jdust
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.m4 import M4Records
from necat_tpu_torch.pipeline import tools
from necat_tpu_torch.utils import dust
from tests.test_trim import mk_m4


def _reads(seed=3, n=30):
    """Reads of 300-3000 bases; every seventh a low-complexity repeat with a
    short random tail (DUST masks it)."""
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(n):
        L = int(rng.integers(300, 3000))
        if i % 7 == 3:
            unit = rng.integers(0, 4, int(rng.integers(2, 5))).astype(np.uint8)
            s = np.concatenate([np.tile(unit, L // len(unit) + 1)[:L],
                                rng.integers(0, 4, 120).astype(np.uint8)])
        else:
            s = rng.integers(0, 4, L).astype(np.uint8)
        seqs.append(s)
    return seqs


def _m4_rows():
    return [dict(qid=3, sid=1, qoff=10, qend=500, qsize=600, soff=0, send=480, ssize=2000,
                 ident=91.25, vscore=77),
            dict(qid=4, sid=2, qdir=1, qoff=0, qend=100, qsize=100, soff=5, send=99,
                 ssize=200, ident=88.5),
            dict(qid=0, sid=4, qdir=1, qoff=120, qend=900, qsize=1000, soff=30, send=820,
                 ssize=900, ident=99.0, vscore=1234),
            dict(qid=2, sid=0, qoff=0, qend=700, qsize=800, sdir=1, soff=100, send=790,
                 ssize=800, ident=95.5)]


def _both_m4():
    jm4 = mk_m4(_m4_rows())
    return jm4, M4Records(**{f.name: getattr(jm4, f.name) for f in dataclasses.fields(jm4)})


COMMANDS = {
    "n50": ["{reads}"],
    "stats": ["{reads}"],
    "longest": ["{reads}", "{out}/long.fasta", "20000", "1.5"],
    "split": ["{reads}", "{out}/part", "3"],
    "extract": ["{reads}", "{out}/ext.fasta", "5", "7"],
    "preprocess": ["{reads}", "{out}/pp.fasta", "500"],
    "simulate": ["{out}/sim.fasta", "20000", "3", "5"],
    "m4topaf": ["{m4}", "{out}/x.paf"],
    "split_name": ["{reads}", "{out}/names", "4"],
    "check": ["{reads}"],
}


@pytest.mark.parametrize("cmd", sorted(COMMANDS))
def test_tools_command_matches_jax(tmp_path, capsys, cmd):
    """Each command on the same inputs: identical stdout and output files."""
    reads = tmp_path / "reads.fasta"
    ReadStore.from_seqs(_reads()).to_fasta(reads)
    m4 = tmp_path / "ovl.m4"
    _both_m4()[1].save(m4)
    runs = {}
    for name, mod in (("jax", jtools), ("torch", tools)):
        out = tmp_path / name
        out.mkdir()
        argv = [cmd] + [a.format(reads=reads, m4=m4, out=out) for a in COMMANDS[cmd]]
        assert mod.main(argv) == 0
        files = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
        runs[name] = (capsys.readouterr().out, files)
    assert runs["torch"] == runs["jax"]
    if cmd == "preprocess":
        assert "0 repeat reads dropped" not in runs["torch"][0]
    assert tools.main(["nosuch"]) == 1 and jtools.main(["nosuch"]) == 1


def _dust_seqs():
    rng = np.random.default_rng(11)
    seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in (0, 2, 3, 40, 64, 500)]
    for unit in ([0, 1], [2, 2, 3], [1, 0, 3, 3]):
        rep = np.tile(np.array(unit, np.uint8), 200)
        seqs.append(np.concatenate([rng.integers(0, 4, 300).astype(np.uint8), rep,
                                    rng.integers(0, 4, 300).astype(np.uint8)]))
    seqs.append(np.zeros(1000, np.uint8))
    return seqs


@pytest.mark.parametrize("i", range(len(_dust_seqs())))
def test_dust_matches_jax(i):
    s = _dust_seqs()[i]
    np.testing.assert_array_equal(dust.triplet_codes(s), jdust.triplet_codes(s))
    for window in (16, 64):
        np.testing.assert_array_equal(dust.window_scores(s, window),
                                      jdust.window_scores(s, window))
        assert dust.dust_intervals(s, window) == jdust.dust_intervals(s, window)
    assert dust.masked_size(s) == jdust.masked_size(s)
    assert dust.is_nonrepeat_sequence(s) == jdust.is_nonrepeat_sequence(s)


@pytest.mark.parametrize("fname, named", [("x.m4", False), ("x.m4a", True), ("x.paf", True),
                                          ("x.paf", False), ("x.ovl", False),
                                          ("x.m4a.gz", True), ("x.paf.gz", True)])
def test_m4_formats_match_jax(tmp_path, fname, named):
    """M4Records.save by extension writes the same bytes (gzip: the same
    text) as the JAX package's, and load_any reads the same arrays."""
    jm4, m4 = _both_m4()
    names = [f"read/{i}" for i in range(5)] if named else None
    opener = gzip.open if fname.endswith(".gz") else open
    paths = []
    for sub, rec in (("jax", jm4), ("torch", m4)):
        (tmp_path / sub).mkdir()
        paths.append(tmp_path / sub / fname)
        rec.save(paths[-1], names)
    texts = []
    for p in paths:
        with opener(p, "rb") as f:
            texts.append(f.read())
    assert texts[0] == texts[1] and len(texts[0].splitlines()) == len(m4)
    name2id = {n: i for i, n in enumerate(names)} if named else None
    got = M4Records.load_any(paths[1], name2id)
    want = JaxM4Records.load_any(paths[0], name2id)
    for f in dataclasses.fields(JaxM4Records):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), f.name)
    if fname.startswith("x.m4a"):
        (ga, gn), (wa, wn) = M4Records.load_m4a(paths[1]), JaxM4Records.load_m4a(paths[0])
        assert gn == wn
        np.testing.assert_array_equal(ga.qid, wa.qid)
