"""SMALL_MEMORY correction (each supergroup uploads only the reads it
touches and extends on local ids) against the JAX package's SMALL_MEMORY run
and against the port with the mode off."""

import dataclasses

import numpy as np

from necat_tpu.consensus.correct import correct_reads as j_correct_reads
from necat_tpu.overlap.candidates import Candidates as JaxCandidates
from necat_tpu_torch.consensus import correct as correct_mod
from necat_tpu_torch.consensus import fused
from necat_tpu_torch.consensus.correct import correct_reads
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.overlap.candidates import Candidates
from necat_tpu_torch.overlap.overlapper import find_all_candidates
from necat_tpu_torch.utils import shapes
from torch_port_helpers import (SMALL_MAP_OPTIONS, as_jax, cap_max_band, indel_store,  # noqa: F401
                                jax_static_band, small_store)


def role_expanded(rs):
    """The port's candidates of rs, both roles, and the same arrays as the
    JAX package's Candidates."""
    c = find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise=True, device="cpu")
    call = Candidates.concat([c, c.swap_roles()])
    return call, JaxCandidates(**{f.name: getattr(call, f.name).copy()
                                  for f in dataclasses.fields(Candidates)})


def assert_same_records(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.tid, x.left, x.right, x.corrected) == (y.tid, y.left, y.right, y.corrected)
        np.testing.assert_array_equal(x.seq, y.seq)


def count_stores(monkeypatch):
    """Record the base count of every DeviceReadStore correct_reads builds."""
    sizes = []

    class Counting(correct_mod.DeviceReadStore):
        def __init__(self, store, device):
            sizes.append(store.total_bases)
            super().__init__(store, device)
    monkeypatch.setattr(correct_mod, "DeviceReadStore", Counting)
    return sizes


def test_small_memory_matches_jax_and_mode_off(jax_static_band, monkeypatch):
    """small_memory=True with four templates a supergroup: the records of
    the JAX package's SMALL_MEMORY run and of the port without the mode;
    each supergroup uploads a store of its own (of its templates and their
    queries: here the last one holds fewer reads than the read set)."""
    jrs, rs = small_store(G=8000)
    call, jcall = role_expanded(rs)
    opts = CnsOptions(templates_per_batch=4, pairs_per_chunk=32, small_memory=True)
    sizes = count_stores(monkeypatch)
    got = correct_reads(rs, call, opts, device="cpu")
    assert len(sizes) >= 2 and min(sizes) < rs.total_bases
    assert sum(r.corrected for r in got) >= 4
    assert_same_records(got, j_correct_reads(jrs, jcall, as_jax(opts)))
    sizes.clear()
    assert_same_records(got, correct_reads(rs, call, dataclasses.replace(
        opts, small_memory=False), device="cpu"))
    assert sizes == [rs.total_bases]


def test_small_memory_turns_itself_on_at_the_bound(monkeypatch):
    """With shapes.DEVICE_STORE_MAX_BASES lowered to the read set's size the
    mode turns itself on and gives the records of the run without it, the
    rescue ladders included (planted insertions, rungs up to 512; one
    template a supergroup, so that each touches part of the read set)."""
    cap_max_band(monkeypatch, 512)
    _, rs = indel_store(6000, 33, 34)
    call, _ = role_expanded(rs)
    opts = CnsOptions(templates_per_batch=1, pairs_per_chunk=32, rescue_long_indels=True)
    want = correct_reads(rs, call, opts, device="cpu")
    sizes = count_stores(monkeypatch)
    monkeypatch.setattr(shapes, "DEVICE_STORE_MAX_BASES", rs.total_bases)
    fused.pairs_by_band.clear()
    got = correct_reads(rs, call, opts, device="cpu")
    assert fused.pairs_by_band[512] > 0
    assert len(sizes) >= 2 and max(sizes) < rs.total_bases
    assert sum(r.corrected for r in got) >= 4
    assert_same_records(got, want)
