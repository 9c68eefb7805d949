"""The port's polish stage and its wide-delta consensus (max_delta 22: the
stream consensus and the host link-DP repair of insertion hotspots) against
the JAX package's: the same inputs to both, exact equality."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from necat_tpu.consensus import backbone as jbackbone
from necat_tpu.consensus import correct as jcorrect
from necat_tpu.io.readstore import ReadStore as JaxReadStore
from necat_tpu.overlap.candidates import Candidates as JaxCandidates
from necat_tpu.polish import polish as jpolish
from necat_tpu_torch.consensus import backbone
from necat_tpu_torch.consensus import correct
from necat_tpu_torch.io import simulate
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.candidates import Candidates
from necat_tpu_torch.polish import polish
from torch_port_helpers import cap_max_band, jax_static_band_wide  # noqa: F401

D = 22                      # PolishOptions.max_delta
MIN_COV, INS_FRAC, INS_OFFSET = 1, 0.2, 1.0


def tag_tensor(seed: int, TB: int = 3, L: int = 512):
    """Seeded weights f32[TB, D, 5, L] and coverage i32[TB, L]. Every weight
    is a multiple of 1/8, so that float32 and float64 sums are exact and
    both packages meet the same ties: some columns get an insertion run of
    1..21 bases, some a weak column (no base near the majority), one column
    an insertion weight of exactly 0.5 * cov."""
    rng = np.random.default_rng(seed)
    cov = rng.integers(1, 9, (TB, L)).astype(np.int32)
    cov[rng.random((TB, L)) < 0.01] = 0
    cov[:, L // 3:L // 3 + 20] = 0                          # an uncovered gap
    w = np.zeros((TB, D, 5, L), np.float32)
    for b in range(TB):
        for t in range(L):
            c = int(cov[b, t])
            if c == 0:
                continue
            if rng.random() < 0.15:                         # weak column
                w[b, 0, :, t] = c / 5
            else:
                w[b, 0, rng.integers(0, 5), t] = c - 0.125 * rng.integers(0, 8)
                w[b, 0, rng.integers(0, 5), t] += 0.125 * rng.integers(0, 8)
            if rng.random() < 0.12:                         # an insertion run
                for k in range(1, int(rng.integers(1, D))):
                    w[b, k, rng.integers(0, 4), t] = c * 0.125 * rng.integers(2, 9)
            if rng.random() < 0.3:                          # insertion noise
                w[b, 1, rng.integers(0, 4), t] += 0.125 * rng.integers(1, 4)
    w[0, :, :, 5] = 0
    cov[0, 5] = 4
    w[0, 0, 2, 5] = 4.0
    w[0, 1, 1, 5] = 2.0                                     # ins_w == 0.5 * cov
    return w, cov


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_consensus_matches_jax(seed):
    """hot_insertion_mask, consensus_stream (stream, cum_t, n_emit, cov8) and
    compact_from_stream with overrides and cuts: exact equality, below the
    JAX package's stream bound SL (past it the JAX package drops bases)."""
    w, cov = tag_tensor(seed)
    TB, L = cov.shape
    SL = L + max(1024, L // 4)                              # correct.py's SL
    jw, jc = jnp.asarray(w), jnp.asarray(cov)
    j_hot = np.asarray(jbackbone.hot_insertion_mask(jw, jc, MIN_COV))
    j_out = [np.asarray(x) for x in jbackbone.consensus_stream(
        jw, jc, MIN_COV, INS_FRAC, INS_OFFSET, SL=SL)]
    tw, tc = torch.from_numpy(w), torch.from_numpy(cov)
    hot = backbone.hot_insertion_mask(tw, tc, MIN_COV).numpy()
    stream, cum_t, n_emit, cov8 = (x.numpy() for x in backbone.consensus_stream(
        tw, tc, MIN_COV, INS_FRAC, INS_OFFSET))
    assert n_emit.max() <= SL and stream.shape == (TB, n_emit.max())
    assert n_emit.max() > L // 2 and (cum_t[:, -1] == n_emit).all()
    np.testing.assert_array_equal(hot, j_hot)
    assert hot.any() and not hot.all() and hot[0, 5]
    np.testing.assert_array_equal(stream, j_out[0][:, :stream.shape[1]])
    assert not j_out[0][:, stream.shape[1]:].any()
    for x, y in zip((cum_t, n_emit, cov8), j_out[1:], strict=True):
        np.testing.assert_array_equal(x, y)
    # the deepest delta emits somewhere: the run outgrows the packed int32
    emit, _ = backbone.call_consensus(tw, tc, MIN_COV, INS_FRAC, INS_OFFSET)
    assert emit[:, :, 11:].any()

    rng = np.random.default_rng(seed + 10)
    templates = rng.integers(0, 4, (TB, L)).astype(np.uint8)
    tlens = np.array([L, L - 37, L // 2][:TB], np.int32)
    hot_t = np.flatnonzero(hot[1])[:3]
    overrides = {1: {int(t): rng.integers(0, 4, 1 + int(t) % 5).astype(np.uint8)
                     for t in hot_t}}
    cuts = {0: [100, 300], 2: [50]}
    args = (cum_t, cov8, tlens, templates, MIN_COV, 20, 10)
    got = backbone.compact_from_stream(stream, *args, overrides=overrides, cut_at=cuts)
    want = jbackbone.compact_from_stream(j_out[0], *args, overrides=overrides,
                                         cut_at=cuts)
    assert len(got) == len(want) == TB
    for (gc, gr), (wc, wr) in zip(got, want):
        assert len(gc) == len(wc) and len(gr) == len(wr)
        for x, y in zip(gc + gr, wc + wr):
            assert x[:2] == y[:2]
            np.testing.assert_array_equal(x[2], y[2])
    assert any(s <= t < e for (s, e, _) in got[1][0] for t in overrides[1])


@pytest.mark.parametrize("seg,halo", [(10000, 0), (10000, 2000), (7000, 3000)])
def test_split_contigs_matches_jax(seg, halo):
    rng = np.random.default_rng(seg + halo)
    seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in (25000, 9000, 14001)]
    names = ["a", "b", "c"]
    s_t, i_t = polish.split_contigs(ReadStore.from_seqs(seqs, names), seg, halo)
    s_j, i_j = jpolish.split_contigs(JaxReadStore.from_seqs(seqs, names), seg, halo)
    assert i_t == i_j and list(s_t.names) == list(s_j.names)
    np.testing.assert_array_equal(s_t.offsets, s_j.offsets)
    np.testing.assert_array_equal(s_t.bases, s_j.bases)


@pytest.mark.parametrize("ratio", [0.8, 0.95])
def test_filter_unique_placement_matches_jax(ratio):
    """Reads placed on several segments of three contigs, some ambiguously."""
    rng = np.random.default_rng(int(ratio * 100))
    n = 60
    f = dict(qid=rng.integers(0, 15, n).astype(np.int32),
             sid=rng.integers(0, 6, n).astype(np.int32),
             qdir=rng.integers(0, 2, n).astype(np.int8),
             score=rng.integers(10, 100, n).astype(np.int32),
             qbeg=np.zeros(n, np.int32), qend=np.full(n, 50, np.int32),
             sbeg=np.zeros(n, np.int32), send=np.full(n, 50, np.int32),
             qsize=np.full(n, 60, np.int32), ssize=np.full(n, 60, np.int32))
    info = [(0, 0, 0), (0, 100, 80), (1, 0, 0), (1, 100, 80), (2, 0, 0), (2, 100, 80)]
    got = polish._filter_unique_placement(Candidates(**f), info, ratio)
    want = jpolish._filter_unique_placement(JaxCandidates(**f), info, ratio)
    assert 0 < len(got.qid) < n
    for k in f:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)


def collapsed_repeat_case():
    """tests/test_polish.py's collapsed repeat: a 20 kb genome whose draft
    misses 300 bases at 9000, three reads across the site and four elsewhere,
    at 3 % error per kind."""
    rng = np.random.default_rng(21)
    truth = simulate.random_genome(20000, seed=25)
    drop = 9000
    draft = np.concatenate([truth[:drop], truth[drop + 300:]])
    em = simulate.ErrorModel(0.03, 0.03, 0.03)
    reads = [simulate.mutate(truth[s:s + 8000], em, rng) for s in (5500, 6500, 7500)]
    reads += [simulate.mutate(truth[s:s + 6000], em, rng) for s in (0, 2000, 12000, 14000)]
    return draft, reads


def test_polish_collapsed_repeat_matches_jax(jax_static_band_wide, monkeypatch):
    """polish_contigs on the collapsed repeat in both packages (the JAX
    package on its static band, the ladder capped at 1024): the same polished
    contig, and the hotspot repair returned the same non-empty override."""
    cap_max_band(monkeypatch, 1024)
    draft, reads = collapsed_repeat_case()
    seen = {}

    def spy(mod, key):
        fn = mod._bucket_hot_overrides

        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen.setdefault(key, []).append(out)
            return out
        monkeypatch.setattr(mod, "_bucket_hot_overrides", wrapped)

    spy(correct, "torch")
    spy(jcorrect, "jax")
    po = dict(segment_size=16384, min_ident=75.0, templates_per_batch=2)
    got = polish.polish_contigs(ReadStore.from_seqs([draft], ["ctg0"]),
                                ReadStore.from_seqs(reads), device="cpu",
                                opts=polish.PolishOptions(**po))
    want = jpolish.polish_contigs(JaxReadStore.from_seqs([draft], ["ctg0"]),
                                  JaxReadStore.from_seqs(reads),
                                  opts=jpolish.PolishOptions(**po))
    assert list(got.names) == list(want.names) == ["ctg0_polished"]
    np.testing.assert_array_equal(got.get(0), want.get(0))
    assert any(seen["torch"])                        # some override was made
    assert len(seen["torch"]) == len(seen["jax"])
    for a, b in zip(seen["torch"], seen["jax"]):
        assert a.keys() == b.keys()
        for row in a:
            assert a[row].keys() == b[row].keys()
            for t in a[row]:
                np.testing.assert_array_equal(a[row][t], b[row][t])
    assert correct.seconds_by_part["overrides"] > 0
    assert dataclasses.asdict(polish.PolishOptions()) == dataclasses.asdict(
        jpolish.PolishOptions())
