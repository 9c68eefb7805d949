"""The port in its adaptive-band mode (NECAT_TPU_NO_PALLAS) against the JAX
package as that package runs on the CPU by default, with no band forced on
it: the correction slice, a ladder case and a polish case."""

import dataclasses

import numpy as np

from necat_tpu.consensus import backbone as jbackbone
from necat_tpu.consensus import correct as jcorrect
from necat_tpu.io.readstore import ReadStore as JaxReadStore
from necat_tpu.overlap import overlapper as joverlapper
from necat_tpu.overlap.candidates import Candidates as JaxCandidates
from necat_tpu.polish import polish as jpolish
from necat_tpu_torch.consensus import correct
from necat_tpu_torch.consensus.correct import correct_reads
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap import overlapper
from necat_tpu_torch.overlap.candidates import Candidates
from necat_tpu_torch.polish import polish
from test_torch_adaptive import adaptive_band  # noqa: F401
from test_torch_polish import collapsed_repeat_case
from torch_port_helpers import (SMALL_MAP_OPTIONS, as_jax, cap_max_band, indel_store,
                                small_store)


def _same_records(recs_t, recs_j, min_corrected):
    assert sum(r.corrected for r in recs_j) >= min_corrected
    assert len(recs_t) == len(recs_j)
    for a, b in zip(recs_t, recs_j):
        assert (a.tid, a.left, a.right, a.corrected) == \
            (b.tid, b.left, b.right, b.corrected)
        np.testing.assert_array_equal(a.seq, b.seq)


def test_correction_slice_matches_jax_default(adaptive_band):
    """find_all_candidates -> swap_roles -> correct_reads in each package;
    candidates equal field for field, records identical (tid, left, right,
    corrected, seq)."""
    jrs, rs = small_store()
    co = CnsOptions(templates_per_batch=4, pairs_per_chunk=32)
    cj = joverlapper.find_all_candidates(jrs, jrs, as_jax(SMALL_MAP_OPTIONS), pairwise=True)
    recs_j = jcorrect.correct_reads(jrs, JaxCandidates.concat([cj, cj.swap_roles()]),
                                    as_jax(co))
    ct = overlapper.find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise=True,
                                        device="cpu")
    for f in dataclasses.fields(Candidates):
        np.testing.assert_array_equal(getattr(ct, f.name), getattr(cj, f.name))
    recs_t = correct_reads(rs, Candidates.concat([ct, ct.swap_roles()]), co, device="cpu")
    _same_records(recs_t, recs_j, 10)


def test_correction_ladder_matches_jax_default(adaptive_band, monkeypatch):
    """correct_reads with rescue_long_indels on indel_store's planted
    insertions, the ladder capped at 512 in both packages: records
    identical."""
    cap_max_band(monkeypatch, 512)
    jrs, rs = indel_store(6000, 33, 34)
    co = CnsOptions(templates_per_batch=16, pairs_per_chunk=64, rescue_long_indels=True)
    ct = overlapper.find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise=True,
                                        device="cpu")
    recs_t = correct_reads(rs, Candidates.concat([ct, ct.swap_roles()]), co, device="cpu")
    cj = JaxCandidates(*[getattr(ct, f.name) for f in dataclasses.fields(Candidates)])
    recs_j = jcorrect.correct_reads(jrs, JaxCandidates.concat([cj, cj.swap_roles()]),
                                    as_jax(co))
    _same_records(recs_t, recs_j, 5)


def test_polish_matches_jax_default(adaptive_band, monkeypatch):
    """polish_contigs on tests/test_polish.py's collapsed repeat at band 256
    with 3 insb words (max_delta 22), the ladder capped at 256 (off): the
    tag weights of every bucket within atol 1e-5 (sums in another order),
    coverage and the polished contig exactly."""
    cap_max_band(monkeypatch, 256)
    draft, reads = collapsed_repeat_case()
    seen = {"torch": [], "jax": []}
    for mod, key in ((correct, "torch"), (jbackbone, "jax")):
        fn = mod.hot_insertion_mask

        def spy(w, cov, *a, _f=fn, _k=key):
            seen[_k].append((np.asarray(w), np.asarray(cov)))
            return _f(w, cov, *a)
        monkeypatch.setattr(mod, "hot_insertion_mask", spy)
    po = dict(segment_size=16384, min_ident=75.0, templates_per_batch=2)
    assert polish.PolishOptions(**po).band_width == 256
    got = polish.polish_contigs(ReadStore.from_seqs([draft], ["ctg0"]),
                                ReadStore.from_seqs(reads), device="cpu",
                                opts=polish.PolishOptions(**po))
    want = jpolish.polish_contigs(JaxReadStore.from_seqs([draft], ["ctg0"]),
                                  JaxReadStore.from_seqs(reads),
                                  opts=jpolish.PolishOptions(**po))
    assert list(got.names) == list(want.names) == ["ctg0_polished"]
    np.testing.assert_array_equal(got.get(0), want.get(0))
    assert len(seen["torch"]) == len(seen["jax"]) >= 1
    for (wt, ct), (wj, cj) in zip(seen["torch"], seen["jax"]):
        assert wt.shape == wj.shape and wt.shape[1] == 22
        np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(ct, cj)
