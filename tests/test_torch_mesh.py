"""Several devices against one: the sharded candidate search
(parallel/mesh.py) and the pair-parallel extension on lists of CPU devices
equal the one-device port and the JAX package's single-device results,
field for field and in order. Analogues of tests/test_mesh.py (which the
JAX package runs on a forced 8-device CPU mesh) and of the overlap half of
__graft_entry__.py's dry run."""

import dataclasses

import numpy as np
import pytest
import torch

from necat_tpu.overlap import overlapper as joverlapper
from necat_tpu_torch.index.kmer_index import KmerIndex
from necat_tpu_torch.io import simulate
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.options import MapOptions
from necat_tpu_torch.overlap.overlapper import (candidates_by_volumes, extend_candidates,
                                               find_all_candidates, overlap_all_vs_all)
from necat_tpu_torch.parallel.mesh import ShardedIndex
from necat_tpu_torch.utils.device import resolve_devices
from torch_port_helpers import (as_jax, both_stores, cap_max_band,  # noqa: F401
                                jax_static_band)

# tests/test_mesh.py's options
OPTS = MapOptions(kmer_size=13, max_hits=1 << 17, max_pairs=4096,
                  chain_min_score=20, align_size_cutoff=300)
# ["cpu", "cpu:0"]: two distinct devices, so the shards' passes run in a
# host thread each (mesh.device_threads), as on two cards
DEVICE_LISTS = (["cpu", "cpu"], ["cpu"] * 3, ["cpu", "cpu:0"])


def _dataset(seed=17, G=20000, coverage=8):
    """tests/test_mesh.py:_dataset as both packages' stores."""
    genome = simulate.random_genome(G, seed=seed)
    reads, *_ = simulate.simulate_reads(genome, coverage=coverage, mean_len=4000,
                                        min_len=2500, max_len=6000, seed=seed + 1)
    return both_stores(reads)


def _assert_same(a, b) -> None:
    assert len(a) == len(b)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name),
                                      err_msg=f.name)


@pytest.fixture(scope="module")
def jax_candidates():
    """The JAX package's single-device candidates of _dataset(), by pairwise."""
    jrs, rs = _dataset()
    return rs, {pw: joverlapper.find_all_candidates(jrs, jrs, as_jax(OPTS), pairwise=pw)
                for pw in (True, False)}


def test_resolve_devices():
    cpu = torch.device("cpu")
    assert resolve_devices("cpu") == [cpu]
    assert resolve_devices("cpu, cpu") == [cpu, cpu]
    assert resolve_devices(["cpu"] * 3) == [cpu] * 3
    assert resolve_devices((cpu, "cpu")) == [cpu, cpu]
    for bad in ([], ["cpu", "meta"], "cpu,tpu", "cpu,"):
        with pytest.raises(ValueError):
            resolve_devices(bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_devices(["cpu", "cuda"])


def test_sharded_index_splits_reads_as_jax():
    """ceil(n_reads / D) contiguous reads a shard (necat_tpu/parallel/
    mesh.py:132-175), each shard's index that of its own reads; a device
    left without reads gets no shard."""
    _, rs = _dataset()
    n = rs.n_reads
    for D in (2, 3, n + 2):
        shards = ShardedIndex(["cpu"] * D, rs, k=13, occ_cutoff=500).shards
        per = -(-n // D)
        assert [(s.lo, s.hi) for s in shards] == [
            (lo, min(lo + per, n)) for lo in range(0, n, per)]
        assert [s.slot for s in shards] == list(range(len(shards)))
        for s in shards[:2]:
            sub = rs.slice(s.lo, s.hi)
            host = KmerIndex.build(sub.bases, sub.offsets, device="cpu", k=13,
                                   n_bucket_bits=14)
            assert s.base == rs.offsets[s.lo]
            np.testing.assert_array_equal(s.offsets.numpy(), sub.offsets)
            for f in ("sorted_hashes", "sorted_positions", "bucket_starts", "run_end"):
                np.testing.assert_array_equal(getattr(s.index, f).numpy(),
                                              getattr(host, f).numpy())


@pytest.mark.parametrize("pairwise", [True, False])
@pytest.mark.parametrize("devices", DEVICE_LISTS, ids=",".join)
def test_sharded_candidates_match_jax_single_device(jax_candidates, devices, pairwise):
    """Field for field and in order, not only as a set (tests/test_mesh.py:
    45-56 compares sets): row order reaches top_n_per_query and the string
    graph."""
    rs, want = jax_candidates
    got = find_all_candidates(rs, rs, OPTS, pairwise, device=devices)
    assert len(got) > 50
    _assert_same(got, want[pairwise])
    _assert_same(got, find_all_candidates(rs, rs, OPTS, pairwise, device="cpu"))


def test_volumes_on_devices_match_untiled(jax_candidates):
    """candidates_by_volumes with a list (volume v on device v mod D) equals
    the untiled one-device search."""
    rs, want = jax_candidates
    assert len(rs.volumes(25000)) >= 3
    _assert_same(candidates_by_volumes(rs, OPTS, 25000, device="cpu,cpu"), want[True])
    with pytest.raises(ValueError):            # a caller's index serves one device
        find_all_candidates(rs, rs, OPTS, True, device=["cpu", "cpu"],
                            index=KmerIndex.build(rs.bases, rs.offsets, device="cpu"))


def test_sharded_extension_matches_single_device():
    """tests/test_mesh.py:59's case (band 64, min_align_size 300) on the first
    64 candidates: chunks round-robin over three devices."""
    _, rs = _dataset(seed=23)
    cands = find_all_candidates(rs, rs, OPTS, True, device="cpu").take(np.arange(64))
    one = extend_candidates(cands, rs, rs, device="cpu", min_align_size=300, band_width=64)
    three = extend_candidates(cands, rs, rs, device=["cpu", "cpu:0", "cpu"],
                              min_align_size=300, band_width=64)
    assert len(one) > 40
    _assert_same(three, one)


def test_extension_on_devices_matches_jax_static_band(jax_static_band, monkeypatch):
    """One small case against the JAX package on its static band: 12
    candidates, band 64, the ladder capped at 256 in both packages."""
    cap_max_band(monkeypatch, 256)
    jrs, rs = _dataset(seed=23, G=12000, coverage=4)
    cands = find_all_candidates(rs, rs, OPTS, True, device="cpu").take(np.arange(12))
    from necat_tpu.overlap.candidates import Candidates as JaxCandidates
    jc = JaxCandidates(**{f.name: getattr(cands, f.name).copy()
                          for f in dataclasses.fields(cands)})
    want = joverlapper.extend_candidates(jc, jrs, jrs, min_align_size=300, band_width=64)
    got = extend_candidates(cands, rs, rs, device=["cpu", "cpu"], min_align_size=300,
                            band_width=64)
    assert len(got) >= 6
    _assert_same(got, want)


def test_overlap_all_vs_all_on_devices():
    """The stage function with a list equals one device: __graft_entry__.py's
    dry-run read set and options (tests/test_mesh.py:86 on its own set)."""
    genome = simulate.random_genome(16000, seed=9)
    reads, *_ = simulate.simulate_reads(genome, coverage=6, mean_len=3500, min_len=2500,
                                        max_len=5000, seed=10)
    rs = ReadStore.from_seqs(reads)
    opts = MapOptions(kmer_size=13, max_hits=1 << 16, max_pairs=2048,
                      chain_min_score=20, align_size_cutoff=300)
    one = overlap_all_vs_all(rs, opts, device="cpu")
    assert len(one) > 0
    _assert_same(overlap_all_vs_all(rs, opts, device=["cpu", "cpu"]), one)
