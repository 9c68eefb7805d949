"""Port consensus pieces and the whole correction slice against the JAX
package (forced onto the static band for the slice)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from necat_tpu.consensus import backbone as jbackbone
from necat_tpu.consensus import correct as jcorrect
from necat_tpu.consensus import fused as jfused
from necat_tpu.consensus import tags as jtags
from necat_tpu.overlap import overlapper as joverlapper
from necat_tpu.overlap.candidates import Candidates as JaxCandidates
from necat_tpu_torch.align import banded
from necat_tpu_torch.consensus import backbone, fused, tags
from necat_tpu_torch.consensus import correct as tcorrect
from necat_tpu_torch.consensus.correct import correct_reads
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.overlap.candidates import Candidates
from necat_tpu_torch.overlap.overlapper import find_all_candidates
from torch_port_helpers import (SMALL_MAP_OPTIONS, as_jax, extension_batch,  # noqa: F401
                                jax_static_band, small_store)

T = torch.from_numpy


@pytest.mark.parametrize("D,words", [(8, 1), (10, 2)])
def test_scatter_chunk_matches_scatter_chunk_mm(D, words):
    """Weights to 1e-5 (the sums run in another order); coverage exact."""
    P, L, W = 8, 1024, 64
    TB, Lt = 3, 1200
    q, ql, t, tl, aq, at = extension_batch(5, P, L)
    ext = banded.extend_batch(*[T(x) for x in (q, ql, t, tl, aq, at)], W=W,
                              insb_words=words)
    rng = np.random.default_rng(2)
    pair_row = np.array([0, 1, 2, 0, 1, TB, 2, 0], np.int32)   # one dropped pair
    pair_w = (rng.random(P) * 0.5 + 0.5).astype(np.float32)
    tsize = np.minimum(tl + rng.integers(0, 50, P), Lt).astype(np.int32)
    at_abs = (at + rng.integers(0, 100, P)).astype(np.int32)

    def insb(side):
        return tuple([ext[f"{side}_insb"]] + [ext[f"{side}_insb{w}"]
                                              for w in range(2, words + 1)])

    side_args = lambda side, conv: (conv(ext[f"{side}_cols"]),
                                    tuple(conv(x) for x in insb(side)),
                                    conv(ext[f"{side}_lead"]), conv(ext[f"{side}_leadb"]),
                                    conv(ext[f"{side}_jc"]))
    to_j = lambda x: jnp.asarray(x.numpy())
    w_j, c_j = jtags.scatter_chunk_mm(
        jnp.zeros((TB + 1, D, 5, Lt), jnp.float32), jnp.zeros((TB + 1, Lt), jnp.int32),
        *side_args("left", to_j), *side_args("right", to_j),
        *[jnp.asarray(x) for x in (at_abs, pair_row, pair_w, tsize)])
    w = torch.zeros((TB + 1, D, 5, Lt), dtype=torch.float32)
    c = torch.zeros((TB + 1, Lt), dtype=torch.int32)
    tags.scatter_chunk(w, c, *side_args("left", lambda x: x),
                       *side_args("right", lambda x: x),
                       *[T(x) for x in (at_abs, pair_row, pair_w, tsize)])
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=1e-5)
    assert c.numpy()[:TB].sum() > 0 and w.numpy()[:TB, 1:].sum() > 0


def test_consensus_packed_matches_jax():
    rng = np.random.default_rng(11)
    TB, L, D = 4, 256, 8
    w = (rng.random((TB, D, 5, L)) * 3).astype(np.float32)
    w[:, 0, 1, ::7] = w[:, 0, 2, ::7]                  # argmax ties: first wins
    cov = rng.integers(0, 12, (TB, L)).astype(np.int32)
    ref = np.asarray(jbackbone.consensus_packed(jnp.asarray(w), jnp.asarray(cov),
                                                4, 0.2, 1.0))
    out = backbone.consensus_packed(T(w), T(cov), 4, 0.2, 1.0)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_cutoff_from_idents_matches_jax():
    rng = np.random.default_rng(4)
    TBp1, S = 9, fused.IDENT_SLOTS
    ibuf = np.zeros((TBp1, S, 3), np.float32)
    ibuf[:, :, 0] = 80 + rng.random((TBp1, S)) * 20
    ibuf[:, :, 1] = rng.random((TBp1, S)) < np.linspace(0.1, 0.9, TBp1)[:, None]
    ibuf[:, :, 2] = rng.random((TBp1, S)) < 0.7
    ibuf[0, 6:] = 0                                     # n < 8 and n < 5 rows
    ibuf[1, 3:] = 0
    ref = np.asarray(jfused.cutoff_from_idents(jnp.asarray(ibuf), n_ident=15))
    out = fused.cutoff_from_idents(T(ibuf), n_ident=15).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert out[1] == 0.0 and (out[2:] > 0).all()


def test_correct_reads_refuses_unported_modes():
    """A list of devices holding one that is no CPU or CUDA device stays
    refused, and so do the JAX package's objects; small_memory and the
    legacy flow (fused=False) run (without candidates every read passes
    through uncorrected)."""
    jrs, rs = small_store(G=6000, coverage=2)
    empty = Candidates.concat([])
    for opts in (CnsOptions(small_memory=True), CnsOptions(fused=False)):
        recs = correct_reads(rs, empty, opts, device="cpu")
        assert [r.tid for r in recs] == list(range(rs.n_reads))
        assert not any(r.corrected for r in recs)
    with pytest.raises(ValueError):
        correct_reads(rs, empty, CnsOptions(), device=["cpu", "meta"])
    for store, opts in ((jrs, CnsOptions()), (rs, as_jax(CnsOptions()))):
        with pytest.raises(TypeError):                 # the JAX package's objects
            correct_reads(store, empty, opts, device="cpu")


def test_correction_slice_matches_jax_static_band(jax_static_band):
    """The slice end to end: find_all_candidates -> swap_roles ->
    correct_reads in each package; records identical (tid, left, right,
    corrected, seq)."""
    jrs, rs = small_store()
    co = CnsOptions(templates_per_batch=4, pairs_per_chunk=32)
    cj = joverlapper.find_all_candidates(jrs, jrs, as_jax(SMALL_MAP_OPTIONS), pairwise=True)
    recs_j = jcorrect.correct_reads(jrs, JaxCandidates.concat([cj, cj.swap_roles()]),
                                    as_jax(co))
    ct = find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise=True, device="cpu")
    for f in dataclasses.fields(Candidates):
        np.testing.assert_array_equal(getattr(ct, f.name), getattr(cj, f.name))
    recs_t = correct_reads(rs, Candidates.concat([ct, ct.swap_roles()]), co,
                           device="cpu")
    assert sum(r.corrected for r in recs_j) >= 10
    assert len(recs_t) == len(recs_j)
    for a, b in zip(recs_t, recs_j):
        assert (a.tid, a.left, a.right, a.corrected) == \
            (b.tid, b.left, b.right, b.corrected)
        np.testing.assert_array_equal(a.seq, b.seq)


def test_correction_options_match_jax_static_band(jax_static_band):
    """The other correct_reads options the port keeps: fixed identity cutoff
    (no round 0), two buckets per supergroup, whole-read output (-f 1)."""
    jrs, rs = small_store(G=6000, gseed=77, rseed=78, coverage=5)
    co = CnsOptions(templates_per_batch=4, pairs_per_chunk=32,
                    buckets_per_supergroup=2, use_fixed_ident_cutoff=True,
                    error=0.3, full_consensus=True)
    ct = find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise=True, device="cpu")
    recs_t = correct_reads(rs, Candidates.concat([ct, ct.swap_roles()]), co,
                           device="cpu")
    cj = JaxCandidates(*[getattr(ct, f.name) for f in dataclasses.fields(Candidates)])
    recs_j = jcorrect.correct_reads(jrs, JaxCandidates.concat([cj, cj.swap_roles()]),
                                    as_jax(co))
    assert sum(r.corrected for r in recs_j) >= 3
    assert len(recs_t) == len(recs_j)
    for a, b in zip(recs_t, recs_j):
        assert (a.tid, a.left, a.right, a.corrected) == \
            (b.tid, b.left, b.right, b.corrected)
        np.testing.assert_array_equal(a.seq, b.seq)


@pytest.fixture(scope="module")
def narrow_inputs():
    """The port's store and role-expanded candidates of
    test_correction_options_match_jax_static_band's read set."""
    _, rs = small_store(G=6000, gseed=77, rseed=78, coverage=5)
    ct = find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise=True, device="cpu")
    return rs, Candidates.concat([ct, ct.swap_roles()])


def _packed_flow(monkeypatch, rs, cands, co):
    """correct_reads with each bucket's consensus decoded as the packed flow
    decodes it: consensus_packed downloaded, the template rows copied by
    ReadStore.padded_batch, compact_from_packed on the host (min_run 0.85 *
    min_size under full_consensus), the records emitted from the copy."""
    packed = []

    def stream(w, cov, min_cov, ins_frac, ins_offset, _fn=backbone.consensus_stream):
        packed.append(backbone.consensus_packed(w, cov, min_cov, ins_frac,
                                                ins_offset).cpu().numpy())
        return _fn(w, cov, min_cov, ins_frac, ins_offset)

    def compact(store, buckets, tpls, opts, template_cuts):
        recs = []
        min_run = max(1, int(opts.min_size * 0.85)) if opts.full_consensus else None
        for b in buckets:
            tbatch, _ = store.padded_batch(b.ids, pad_to=b.Lt, multiple=1)
            pieces = backbone.compact_from_packed(packed.pop(0), b.tlens, tbatch,
                                                  opts.min_size, opts.raw_min_gap,
                                                  max_delta=opts.max_delta, min_run=min_run)
            recs.extend(tcorrect._emit_records(b, pieces, tbatch, opts))
        return recs

    with monkeypatch.context() as mp:
        mp.setattr(tcorrect, "consensus_stream", stream)
        mp.setattr(tcorrect, "_compact_supergroup", compact)
        recs = correct_reads(rs, cands, co, device="cpu")
    assert not packed
    return recs


@pytest.mark.parametrize("full_consensus", [False, True], ids=["pieces", "full_consensus"])
def test_narrow_stream_compaction_equals_packed_flow(monkeypatch, narrow_inputs,
                                                     full_consensus):
    """On the narrow-delta path the stream compaction gives the records of
    the packed flow (its oracle) record for record, whatever
    templates_per_batch buckets the templates by."""
    rs, cands = narrow_inputs
    co = CnsOptions(templates_per_batch=4, pairs_per_chunk=32, full_consensus=full_consensus)
    want = _packed_flow(monkeypatch, rs, cands, co)
    assert sum(r.corrected for r in want) >= 3
    for tb in (4, 3):
        got = correct_reads(rs, cands, dataclasses.replace(co, templates_per_batch=tb),
                            device="cpu")
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert (a.tid, a.left, a.right, a.org_size, a.corrected) == \
                (b.tid, b.left, b.right, b.org_size, b.corrected)
            assert a.seq.dtype == b.seq.dtype == np.uint8
            np.testing.assert_array_equal(a.seq, b.seq)
