"""Port candidate detection against the JAX package, both given one index."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from necat_tpu.index.kmer_index import KmerIndex as JaxKmerIndex
from necat_tpu.index.kmer_index import _lookup_ranges
from necat_tpu.overlap import overlapper as joverlapper
from necat_tpu.overlap.chain import chain_pairs as jchain_pairs
from necat_tpu_torch.index.kmer_index import KmerIndex, _build_numpy, index_from_numpy
from necat_tpu_torch.overlap.chain import chain_pairs
from necat_tpu_torch.overlap.overlapper import find_all_candidates
from torch_port_helpers import SMALL_MAP_OPTIONS, as_jax, small_store


def _shared_index(rs, opts):
    jidx = JaxKmerIndex.build(rs.bases, rs.offsets, k=opts.kmer_size,
                              occ_cutoff=opts.occ_cutoff)
    tidx = index_from_numpy(
        k=jidx.k, occ_cutoff=jidx.occ_cutoff, n_bucket_bits=jidx.n_bucket_bits,
        sorted_hashes=np.asarray(jidx.sorted_hashes),
        sorted_positions=np.asarray(jidx.sorted_positions),
        bucket_starts=np.asarray(jidx.bucket_starts), run_end=np.asarray(jidx.run_end),
        n_search_steps=jidx.n_search_steps, device="cpu")
    return jidx, tidx


def _key_set(c):
    return sorted(zip(c.qid.tolist(), c.sid.tolist(), c.qdir.tolist(),
                      c.qbeg.tolist(), c.qend.tolist(), c.sbeg.tolist(),
                      c.send.tolist(), c.score.tolist()))


def test_find_all_candidates_matches_jax():
    jrs, rs = small_store()
    jidx, tidx = _shared_index(rs, SMALL_MAP_OPTIONS)
    cj = joverlapper.find_all_candidates(jrs, jrs, as_jax(SMALL_MAP_OPTIONS), pairwise=True,
                                         index=jidx)
    ct = find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise=True, device="cpu",
                             index=tidx)
    assert len(cj) > 20
    assert _key_set(ct) == _key_set(cj)
    # the port's own index build gives the same index
    own = KmerIndex.build(rs.bases, rs.offsets, device="cpu", k=13)
    for f in ("sorted_hashes", "sorted_positions", "bucket_starts", "run_end"):
        np.testing.assert_array_equal(getattr(own, f).numpy(),
                                      np.asarray(getattr(jidx, f)))


def test_lookup_ranges_matches_jax():
    _, rs = small_store()
    jidx, tidx = _shared_index(rs, SMALL_MAP_OPTIONS)
    rng = np.random.default_rng(1)
    sh = np.asarray(jidx.sorted_hashes)
    qh = np.concatenate([rng.choice(sh, 500), rng.integers(0, 1 << 26, 500)])
    qh = qh.astype(np.int32).reshape(10, 100)
    start_j, count_j = _lookup_ranges(
        jidx.sorted_hashes, jidx.bucket_starts, jnp.asarray(qh),
        2 * jidx.k - jidx.n_bucket_bits, jidx.occ_cutoff, jidx.n_search_steps,
        run_end=jidx.run_end)
    start, count = tidx.lookup_ranges(torch.from_numpy(qh))
    count_j = np.asarray(count_j)
    np.testing.assert_array_equal(count.numpy(), count_j)
    hit = count_j > 0
    assert hit.sum() >= 400
    np.testing.assert_array_equal(start.numpy()[hit], np.asarray(start_j)[hit])


@pytest.mark.parametrize("S", [16, 64])
def test_chain_pairs_matches_jax(S):
    rng = np.random.default_rng(S)
    P, k = 64, 13
    qo = np.zeros((P, S), np.int32)
    so = np.zeros((P, S), np.int32)
    mask = np.zeros((P, S), bool)
    for p in range(P):
        n = int(rng.integers(1, S + 1))
        bq = np.sort(rng.integers(0, 8000, n))
        bs = bq + 3000 + rng.integers(-60, 60, n)
        bs = np.where(rng.random(n) < 0.2, rng.integers(0, 20000, n), bs)
        order = np.lexsort((bq, bs))
        qo[p, :n], so[p, :n], mask[p, :n] = bq[order], bs[order], True
    ref = jchain_pairs(jnp.asarray(qo), jnp.asarray(so), jnp.asarray(mask), k)
    out = chain_pairs(torch.from_numpy(qo), torch.from_numpy(so),
                      torch.from_numpy(mask), k)
    for key in ("score", "n_seeds", "qbeg", "qend", "sbeg", "send"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)


def test_candidates_swap_roles_matches_jax():
    from necat_tpu.overlap.candidates import Candidates as JaxCandidates
    from necat_tpu_torch.overlap.candidates import Candidates
    _, rs = small_store()
    c = find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise=True, device="cpu")
    jc = JaxCandidates(*[getattr(c, f.name) for f in dataclasses.fields(Candidates)])
    for a, b in ((c.swap_roles(), jc.swap_roles()),
                 (Candidates.concat([c, c]), JaxCandidates.concat([jc, jc]))):
        for f in dataclasses.fields(Candidates):
            np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))


def test_index_build_without_native_library():
    """The plain NumPy build (_build_numpy) gives the index that
    KmerIndex.build makes with the port's native radix sort."""
    from necat_tpu_torch.index.kmer_index import _run_ends, _search_steps
    _, rs = small_store(G=6000, coverage=3)
    with_native = KmerIndex.build(rs.bases, rs.offsets, device="cpu", k=13)
    sh, sp, bs = _build_numpy(rs.bases, rs.offsets, 13, with_native.n_bucket_bits)
    without = index_from_numpy(k=13, occ_cutoff=with_native.occ_cutoff,
                               n_bucket_bits=with_native.n_bucket_bits, sorted_hashes=sh,
                               sorted_positions=sp, bucket_starts=bs, run_end=_run_ends(sh),
                               n_search_steps=_search_steps(bs), device="cpu")
    for f in ("sorted_hashes", "sorted_positions", "bucket_starts", "run_end"):
        np.testing.assert_array_equal(getattr(without, f).numpy(),
                                      getattr(with_native, f).numpy())
    assert without.n_search_steps == with_native.n_search_steps
