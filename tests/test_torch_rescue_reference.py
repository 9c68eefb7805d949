"""The port's correction with iteration 2's options (-r 1: the long-indel
rescue ladder; -f 0: broken consensus) against the benchmark's plain
reference, portbench/reference/correct_rescue.py, on the CPU, on the port's
own iteration-1 output of a 16 kb genome at 8X with two long insertions
planted: the records of every template equal with the whole ladder (round
0's ladder and replay), and those of the templates next to the planted
reads with the later rounds' ladder alone (a fixed cutoff) capped at
rescue_band_max_scale=8; the rescue's scopes and counters where the ladder
runs, and none of them in iteration 1 (-r 0)."""

import collections
import contextlib
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

from necat_tpu_torch.consensus import fused
from necat_tpu_torch.consensus.correct import correct_reads
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.candidates import Candidates
from necat_tpu_torch.overlap.options import MapOptions
from necat_tpu_torch.overlap.overlapper import find_all_candidates
from necat_tpu_torch.utils import logging as tlogging
import torch_port_helpers  # noqa: F401  (one torch thread a test process)

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from portbench import inputs  # noqa: E402
from portbench.reference import correct_rescue as R, search as S  # noqa: E402

CFG = json.loads((REPO / "portbench/configs/ecoli-ont-40x-iter2.json").read_text())
# a 16 kb genome at 8X; reads of 3-5.5 kb keep the plain kernels' length
# tier at 8192
SMALL = dict(genome_size=16000, coverage=8,
             reads=dict(CFG["reads"], mean_len=4000, min_len=3000, max_len=5500))
SEED = 2**31 + 23
# the batching the CPU runs fastest; records do not depend on it
BATCH = dict(templates_per_batch=16, pairs_per_chunk=16)
# insertions planted in the middle of the two longest reads of iteration
# 2: past the band at W=128, short enough for the chains to cross
PLANTED = (120, 200)
RESCUE_NAMES = ("cns.ident_ladder", "cns.round0_replay", "cns.defer_ladder",
                "cns.rung_lanes", "cns.replay_lanes")


def _both_roles(store, opts: str):
    c = find_all_candidates(store, store, MapOptions.from_string(opts), pairwise=True,
                            device="cpu")
    return Candidates.concat([c, c.swap_roles()])


def _cns(opts: str, **kw) -> CnsOptions:
    return dataclasses.replace(CnsOptions.from_string(opts), **BATCH, **kw)


@pytest.fixture(scope="module")
def it1():
    """(iteration 2's reads, iteration 1's timing report, the planted
    reads): the port's iteration-1 records (whole reads) sorted by (tid,
    left), as run_correct stores them, with two insertions planted."""
    store = ReadStore.from_seqs(inputs.raw_reads({**CFG, **SMALL}, SEED))
    with _timing():
        recs = correct_reads(store, _both_roles(store, CFG["it1_ovlp_options"]),
                             _cns(CFG["it1_cns_options"]), device="cpu")
        rep = tlogging.timing_report(None)
    assert any(r.corrected for r in recs)
    reads = [r.seq for r in sorted(recs, key=lambda r: (r.tid, r.left))]
    rng = np.random.default_rng(SEED)
    planted = np.argsort([-len(r) for r in reads])[:len(PLANTED)]
    for i, n in zip(planted, PLANTED):
        r = reads[i]
        reads[i] = np.concatenate([r[:len(r) // 2], rng.integers(0, 4, n).astype(np.uint8),
                                   r[len(r) // 2:]])
    return reads, rep, planted


@contextlib.contextmanager
def _timing():
    """Timing on with the spans kept; cleared before and after."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tlogging, "TIMING_ON", True)
    mp.setattr(tlogging, "TRACE_PATH", "unused")
    tlogging.reset_timers()
    try:
        yield
    finally:
        tlogging.reset_timers()
        mp.undo()


# iteration 2's options over the configuration's; the later rounds run
# alone with a fixed cutoff (no round 0), on the templates that a planted
# read is a candidate of
CASES = {"ladder": {}, "fixed-cutoff-max-scale-8": dict(use_fixed_ident_cutoff=True,
                                                        rescue_band_max_scale=8)}
_RUNS: dict = {}


def _run(it1, case):
    """(records, timing report, kept spans, pairs by band, template ids) of
    the port's iteration 2, once a case."""
    if case not in _RUNS:
        reads, _, planted = it1
        store = ReadStore.from_seqs(reads)
        cands = _both_roles(store, CFG["ovlp_options"])
        tids = np.arange(len(reads))
        if case != "ladder":
            tids = np.unique(cands.sid[np.isin(cands.qid, planted)])
        fused.pairs_by_band.clear()
        with _timing():
            recs = correct_reads(store, cands, _cns(CFG["cns_options"], **CASES[case]),
                                 device="cpu", template_ids=tids)
            _RUNS[case] = (recs, tlogging.timing_report(None), tlogging.spans(),
                           dict(fused.pairs_by_band), tids)
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_records_equal_reference(it1, case):
    """Every template's records (left, right, corrected, bases) equal the
    reference's, corrected pieces and uncorrected stretches alike."""
    reads = it1[0]
    recs, *_, tids = _run(it1, case)
    mo = S.parse_map_options(CFG["ovlp_options"])
    o = R.parse_cns_options(CFG["cns_options"])
    o["fixed_cutoff"] = CASES[case].get("use_fixed_ident_cutoff", False)
    o["rescue_band_max_scale"] = CASES[case].get("rescue_band_max_scale", 32)
    ref = R.correct(S.Volume(reads, mo["k"], "cpu"), tids, mo, o, "cpu")
    assert any(r.corrected for r in ref) and any(r.left > 0 for r in ref)
    assert inputs.records_differ(recs, ref) == 0
    assert len(recs) == len(ref)


@pytest.mark.parametrize("case", list(CASES))
def test_planted_indel_climbs_the_ladder(it1, case):
    """Pairs across a planted insertion climb: cns.rung_lanes counts them,
    up to the capped ladder's top; round 0's lanes are dispatched twice
    (cns.replay_lanes)."""
    _, rep, _, by_band, _ = _run(it1, case)
    assert rep["cns.rung_lanes"][0] > 0
    assert rep["cns.rung_lanes"][0] + rep.get("cns.replay_lanes", (0,))[0] \
        < rep["ext.real_lanes"][0]
    top = 128 * CASES[case].get("rescue_band_max_scale", 32)
    assert max(by_band) <= top and set(by_band) - {128}
    if case == "ladder":
        assert rep["cns.replay_lanes"][0] > 0
    else:
        assert "cns.replay_lanes" not in rep and rep["cns.defer_ladder"][1] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_rescue_scopes_nest(it1, case):
    """The rescue's scopes are spans inside cns.extend_pairs_total."""
    _, rep, spans, _, _ = _run(it1, case)
    by_id = {s.id: s for s in spans}
    parents = collections.defaultdict(set)
    for s in spans:
        parents[s.name].add(by_id[s.parent].name if s.parent else None)
    names = (("cns.ident_ladder", "cns.round0_replay") if case == "ladder"
             else ("cns.defer_ladder",))
    for name in names:
        assert rep[name][1] > 0
        assert parents[name] == {"cns.extend_pairs_total"}


def test_ladder_off_has_no_rescue_names(it1):
    """Iteration 1 (-r 0) opens none of the rescue's scopes and moves none
    of its counters; all of them are the port's own names."""
    rep = it1[1]
    assert "cns.extend_pairs_total" in rep
    assert not set(RESCUE_NAMES) & set(rep)
    assert set(RESCUE_NAMES) <= set(tlogging.PORT_ONLY)


def test_reference_rungs_follow_the_options():
    o = R.parse_cns_options(CFG["cns_options"])
    assert o["rescue"] and not o["full_consensus"]
    assert R.rungs(o) == [512, 1024, 2048, 4096]
    assert R.rungs({**o, "rescue_band_max_scale": 8}) == [512, 1024]
