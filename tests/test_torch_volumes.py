"""The port's subject-volume tiling against the JAX package's: ReadStore
volumes, candidates_by_volumes, overlap_all_vs_all(vol_size=), and the
candidate search past the device store's bound (host-built query batches).

The port puts the tiled candidates in the order of the untiled search, so
it is held to its untiled candidates field for field; the JAX package
concatenates the volumes, so it is held to the same set."""

import dataclasses

import numpy as np
import pytest

from necat_tpu.io.readstore import ReadStore as JaxReadStore
from necat_tpu.overlap import overlapper as joverlapper
from necat_tpu_torch.io import simulate
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap import overlapper
from necat_tpu_torch.overlap.candidates import Candidates
from necat_tpu_torch.overlap.m4 import M4Records
from necat_tpu_torch.overlap.options import MapOptions
from necat_tpu_torch.utils import shapes
from torch_port_helpers import (SMALL_MAP_OPTIONS, as_jax, both_stores, cap_max_band,  # noqa: F401
                                jax_static_band)

VOL_MAP_OPTIONS = MapOptions(kmer_size=13, max_hits=1 << 18, max_pairs=8192)
CAND_FIELDS = [f.name for f in dataclasses.fields(Candidates)]
M4_FIELDS = [f.name for f in dataclasses.fields(M4Records)]


def volume_store():
    """tests/test_candidates.py:208's read set: a 30 kb genome at 6x, reads of
    4-8 kb at 3 % error per kind (32 reads, 183 kb)."""
    genome = simulate.random_genome(30000, seed=5)
    reads, *_ = simulate.simulate_reads(
        genome, coverage=6, mean_len=6000, min_len=4000, max_len=8000,
        em=simulate.ErrorModel(0.03, 0.03, 0.03), seed=6)
    return both_stores(reads)


def rows(obj, fields):
    """The records as a sorted list of tuples (their order left out)."""
    return sorted(zip(*[getattr(obj, f).tolist() for f in fields]))


def assert_same(a, b, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("lengths,vol_size", [
    ([500, 300, 2000, 100, 100, 100], 1000),     # a read longer than a volume
    ([400, 600, 1000, 250, 250, 500], 1000),     # volumes filled exactly
    ([100] * 7, 10_000),                         # one volume
    ([], 1000),
])
def test_volumes_match_jax(lengths, vol_size):
    seqs = [np.zeros(n, np.uint8) for n in lengths]
    vols = ReadStore.from_seqs(seqs).volumes(vol_size)
    assert vols == JaxReadStore.from_seqs(seqs).volumes(vol_size)
    assert [lo for lo, _ in vols[1:]] == [hi for _, hi in vols[:-1]]     # contiguous


def test_candidates_by_volumes_matches_untiled_and_jax():
    """Five volumes (vol_size 40 kb): the port's tiled candidates equal its
    untiled ones field for field and in order, and hold the JAX package's
    tiled and untiled candidate sets. One volume gives the untiled search."""
    jrs, rs = volume_store()
    assert len(rs.volumes(40_000)) >= 3
    opts = VOL_MAP_OPTIONS
    one = overlapper.find_all_candidates(rs, rs, opts, pairwise=True, device="cpu")
    overlapper.index_build_s.clear()
    tiled = overlapper.candidates_by_volumes(rs, opts, 40_000, device="cpu")
    assert len(overlapper.index_build_s) == len(rs.volumes(40_000))
    assert len(one) > 0
    assert_same(tiled, one, CAND_FIELDS)
    assert_same(overlapper.candidates_by_volumes(rs, opts, 10**9, device="cpu"), one,
                CAND_FIELDS)
    j_tiled = joverlapper.candidates_by_volumes(jrs, as_jax(opts), vol_size=40_000)
    j_one = joverlapper.find_all_candidates(jrs, jrs, as_jax(opts), pairwise=True)
    assert rows(tiled, CAND_FIELDS) == rows(j_tiled, CAND_FIELDS) == rows(j_one, CAND_FIELDS)


def test_find_all_candidates_on_a_volume_matches_jax():
    """One subject volume (the middle one) searched by the reads from its
    first read on: subject_read_start and query_ids as in the JAX package,
    the same candidates in the same order."""
    jrs, rs = volume_store()
    slo, shi = rs.volumes(40_000)[1]
    off = rs.offsets
    svol = ReadStore(bases=rs.bases[off[slo]:off[shi]], offsets=off[slo:shi + 1] - off[slo],
                     names=rs.names[slo:shi])
    jvol = JaxReadStore(bases=svol.bases.copy(), offsets=svol.offsets.copy(),
                        names=list(svol.names))
    qids = np.arange(slo, rs.n_reads)
    got = overlapper.find_all_candidates(rs, svol, VOL_MAP_OPTIONS, pairwise=True,
                                         device="cpu", subject_read_start=slo,
                                         query_ids=qids)
    want = joverlapper.find_all_candidates(jrs, jvol, as_jax(VOL_MAP_OPTIONS), pairwise=True,
                                           subject_read_start=slo, query_ids=qids)
    assert len(got) > 0 and (got.sid >= slo).all() and (got.sid < shi).all()
    assert (got.qid >= slo).all() and (got.sid < got.qid).all()
    assert_same(got, want, CAND_FIELDS)


def test_candidates_by_volumes_two_chains_keep_untiled_order():
    """Two chains per pair and ncan 5, so that the top-n cut meets ties: the
    tiled candidates are still the untiled ones, in their order."""
    _, rs = volume_store()
    opts = dataclasses.replace(VOL_MAP_OPTIONS, n_chains_per_pair=2, ncan=5)
    one = overlapper.find_all_candidates(rs, rs, opts, pairwise=True, device="cpu")
    assert len(one) > 0
    assert_same(overlapper.candidates_by_volumes(rs, opts, 40_000, device="cpu"), one,
                CAND_FIELDS)


def test_host_batches_past_the_bound_match_device_rows(monkeypatch):
    """With shapes.DEVICE_STORE_MAX_BASES below the query store's size, the
    query batches are built on the host; the candidates are the ones the
    device-gathered batches give, untiled and in volumes."""
    _, rs = volume_store()
    opts = VOL_MAP_OPTIONS
    gathered = overlapper.find_all_candidates(rs, rs, opts, pairwise=True, device="cpu")
    tiled = overlapper.candidates_by_volumes(rs, opts, 40_000, device="cpu")
    monkeypatch.setattr(shapes, "DEVICE_STORE_MAX_BASES", rs.total_bases // 2)
    monkeypatch.setattr(overlapper, "DeviceReadStore", None)    # must not be used
    assert_same(overlapper.find_all_candidates(rs, rs, opts, pairwise=True, device="cpu"),
                gathered, CAND_FIELDS)
    assert_same(overlapper.candidates_by_volumes(rs, opts, 40_000, device="cpu"), tiled,
                CAND_FIELDS)


def corrected_store():
    """A 12 kb genome at 5x, reads of 3-5.5 kb at 1 % error per kind (the
    overlaps trim and assembly see; 17 reads, 62 kb)."""
    genome = simulate.random_genome(12000, seed=33)
    reads, *_ = simulate.simulate_reads(
        genome, coverage=5, mean_len=4000, min_len=3000, max_len=5500,
        em=simulate.ErrorModel(sub=0.01, ins=0.01, dele=0.01), seed=34)
    return both_stores(reads)


def test_overlap_all_vs_all_volumes_match_jax(jax_static_band, monkeypatch):
    """overlap_all_vs_all(vol_size=) in three or more volumes gives the JAX
    package's M4 rows (every ladder off: MAX_BAND 256 in both packages)."""
    cap_max_band(monkeypatch, 256)
    jrs, rs = corrected_store()
    vol = 20_000
    assert len(rs.volumes(vol)) >= 3
    tm = overlapper.overlap_all_vs_all(rs, SMALL_MAP_OPTIONS, device="cpu", vol_size=vol)
    jm = joverlapper.overlap_all_vs_all(jrs, as_jax(SMALL_MAP_OPTIONS), vol_size=vol)
    assert len(tm) >= rs.n_reads and (tm.sid < tm.qid).all()
    assert rows(tm, M4_FIELDS) == rows(jm, M4_FIELDS)
