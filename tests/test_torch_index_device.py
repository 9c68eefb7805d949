"""KmerIndex.build_on_device (torch ops over the packed words) against the
host builds (_build_numpy, the native radix sort) and the JAX package's
device build cut to its real k-mers, array for array."""

import dataclasses

import numpy as np
import pytest

from necat_tpu.index.kmer_index import KmerIndex as JaxKmerIndex
from necat_tpu.io.readstore import ReadStore as JaxReadStore
from necat_tpu_torch.index import kmer_index
from necat_tpu_torch.index.kmer_index import KmerIndex, _build_numpy, build_index
from necat_tpu_torch.io.devstore import DeviceReadStore
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.overlapper import find_all_candidates
from necat_tpu_torch.utils import shapes
from torch_port_helpers import SMALL_MAP_OPTIONS, small_store

FIELDS = ("sorted_hashes", "sorted_positions", "bucket_starts", "run_end")


def _reads(seed: int, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, n).astype(np.uint8) for n in lengths]


# reads shorter than k, reads ending on and off 16-base word boundaries
CASES = {
    "short": (1, [3, 12, 14, 15, 16, 2, 40]),
    "boundaries": (2, [16, 32, 17, 31, 48, 15, 64, 100, 33]),
    "mixed": (3, [200, 5, 160, 77, 13, 300, 16, 1, 250]),
}


def _host_arrays(bases, offsets, k, nbb):
    sh, sp, bs = _build_numpy(bases, offsets, k, nbb)
    return {"sorted_hashes": sh, "sorted_positions": sp, "bucket_starts": bs,
            "run_end": kmer_index._run_ends(sh)}


def _assert_index(idx: KmerIndex, want: dict, steps: int) -> None:
    for f in FIELDS:
        got = getattr(idx, f).numpy()
        assert got.dtype == np.int32, f
        np.testing.assert_array_equal(got, want[f], err_msg=f)
    assert idx.n_search_steps == steps


@pytest.mark.parametrize("k,nbb", [(13, 22), (15, 12)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_build_on_device_matches_host_and_jax(case, k, nbb):
    seed, lengths = CASES[case]
    seqs = _reads(seed, lengths)
    rs = ReadStore.from_seqs(seqs)
    want = _host_arrays(rs.bases, rs.offsets, k, nbb)
    native = KmerIndex.build(rs.bases, rs.offsets, device="cpu", k=k, n_bucket_bits=nbb)
    _assert_index(native, want, native.n_search_steps)
    for src in (rs, DeviceReadStore(rs, "cpu")):
        _assert_index(KmerIndex.build_on_device(src, device="cpu", k=k, n_bucket_bits=nbb),
                      want, native.n_search_steps)
    # the JAX package's device build pads to a power of two: cut to n_real
    jidx = JaxKmerIndex.build_on_device(JaxReadStore.from_seqs(seqs), k=k,
                                        n_bucket_bits=nbb)
    bs = np.asarray(jidx.bucket_starts)
    n_real = int(bs[-1])
    np.testing.assert_array_equal(bs, want["bucket_starts"])
    for f in ("sorted_hashes", "sorted_positions", "run_end"):
        np.testing.assert_array_equal(np.asarray(getattr(jidx, f))[:n_real], want[f],
                                      err_msg=f)
    assert jidx.n_search_steps == native.n_search_steps


@pytest.mark.parametrize("lo,hi", [(1, 6), (3, 9), (7, 8), (0, 9)])
def test_build_on_device_of_a_volume_slice(lo, hi):
    """A slice of the device store (a subject volume, whose first base lies
    mid-word) indexes its own reads with positions from its first base, as
    the host build of the volume's bases does."""
    seqs = _reads(4, CASES["mixed"][1])
    rs = ReadStore.from_seqs(seqs)
    vol = rs.slice(lo, hi)
    assert lo == 0 or rs.offsets[lo] % 16          # these volumes start mid-word
    want = _host_arrays(vol.bases, vol.offsets, 15, 22)
    native = KmerIndex.build(vol.bases, vol.offsets, device="cpu")
    dev = DeviceReadStore(rs, "cpu").slice(lo, hi)
    _assert_index(KmerIndex.build_on_device(dev, device="cpu"), want, native.n_search_steps)
    jidx = JaxKmerIndex.build_on_device(JaxReadStore.from_seqs(seqs[lo:hi]))
    n_real = int(np.asarray(jidx.bucket_starts)[-1])
    np.testing.assert_array_equal(np.asarray(jidx.sorted_positions)[:n_real],
                                  want["sorted_positions"])


def test_build_on_device_of_an_empty_store():
    """No read reaches k bases: an empty index, as the host builds give."""
    rs = ReadStore.from_seqs(_reads(5, [3, 14, 7]))
    want = _host_arrays(rs.bases, rs.offsets, 15, 10)
    assert len(want["sorted_hashes"]) == 0
    idx = KmerIndex.build_on_device(rs, device="cpu", n_bucket_bits=10)
    _assert_index(idx, want, KmerIndex.build(rs.bases, rs.offsets, device="cpu",
                                             n_bucket_bits=10).n_search_steps)
    with pytest.raises(ValueError):
        KmerIndex.build_on_device(rs, device="cpu", k=16)


def test_device_index_candidates_match_host_index():
    """Candidates from a device-built index equal those of a host-built one,
    field for field; build_index on the CPU builds on the host (the JAX
    package's CPU backend does too) and records each build's seconds."""
    _, rs = small_store()
    k = SMALL_MAP_OPTIONS.kmer_size
    dev_idx = KmerIndex.build_on_device(rs, device="cpu", k=k)
    host_idx = KmerIndex.build(rs.bases, rs.offsets, device="cpu", k=k)
    for pairwise in (True, False):
        a = find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise, device="cpu",
                                index=dev_idx)
        b = find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise, device="cpu",
                                index=host_idx)
        assert len(a) > 20
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    n_builds = len(kmer_index.index_build_s)
    built = build_index(rs, device="cpu", k=k, occ_cutoff=500)
    assert len(kmer_index.index_build_s) == n_builds + 1
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(built, f).numpy(), getattr(host_idx, f).numpy())
    assert shapes.DEVICE_INDEX_MAX_BASES == int(3e8)
