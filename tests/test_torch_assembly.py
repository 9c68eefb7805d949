"""The port's overlapper, trim, assembly and link-DP modules against the JAX
package's: the same inputs to both, exact equality of every output.

The overlaps come from overlap_all_vs_all in both packages of a read set
shaped like small_store's but at the error of corrected reads (what trim and
assembly see), the JAX package forced onto its static band (Pallas in
interpret mode) and the rescue ladder capped at 512 in both; the host stages
(trim, overlap filter, assembly) then get identical M4 arrays."""

import dataclasses

import numpy as np
import pytest

from necat_tpu.assembly import contigs as jcontigs
from necat_tpu.assembly import overlap_filter as jfilter
from necat_tpu.consensus import linkdp as jlinkdp
from necat_tpu.overlap import m4 as jm4
from necat_tpu.overlap.overlapper import overlap_all_vs_all as j_overlap_all_vs_all
from necat_tpu.trim import lcr as jlcr
from necat_tpu.utils import args as jargs
from necat_tpu_torch.assembly import contigs, overlap_filter
from necat_tpu_torch.consensus import linkdp
from necat_tpu_torch.io import simulate
from necat_tpu_torch.overlap import m4
from necat_tpu_torch.overlap.overlapper import overlap_all_vs_all
from necat_tpu_torch.trim import lcr
from necat_tpu_torch.utils import args
from torch_port_helpers import (SMALL_MAP_OPTIONS, _force_static_band, as_jax,
                                both_stores, cap_max_band)

M4_FIELDS = [f.name for f in dataclasses.fields(m4.M4Records)]


def as_jax_m4(rec: m4.M4Records) -> jm4.M4Records:
    return jm4.M4Records(**{f: getattr(rec, f).copy() for f in M4_FIELDS})


def assert_same_m4(a, b) -> None:
    for f in M4_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def assert_same_store(a, b) -> None:
    assert list(a.names) == list(b.names)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.bases, b.bases)


def corrected_store():
    """small_store's genome and read lengths at 8x and 1 % error per kind:
    corrected reads, whose overlaps clear trim's 90 % identity."""
    genome = simulate.random_genome(12000, seed=33)
    reads, *_ = simulate.simulate_reads(
        genome, coverage=8, mean_len=4000, min_len=3000, max_len=5500,
        em=simulate.ErrorModel(sub=0.01, ins=0.01, dele=0.01), seed=34)
    return both_stores(reads)


@pytest.fixture(scope="module")
def overlaps():
    """(JAX store, port store, JAX M4, port M4) of corrected_store()."""
    mp = pytest.MonkeyPatch()
    static = _force_static_band(mp, pallas_enc=True)
    next(static)
    try:
        cap_max_band(mp, 512)
        jrs, rs = corrected_store()
        jm = j_overlap_all_vs_all(jrs, as_jax(SMALL_MAP_OPTIONS))
        tm = overlap_all_vs_all(rs, SMALL_MAP_OPTIONS, device="cpu")
    finally:
        next(static, None)             # undo the patches, clear the jit caches
    return jrs, rs, jm, tm


def test_overlap_all_vs_all_matches_jax(overlaps):
    _, rs, jm, tm = overlaps
    assert len(tm) >= rs.n_reads              # each read overlaps some other
    assert (tm.sid < tm.qid).all()            # each overlap reported once
    assert_same_m4(tm, jm)


def test_m4_helpers_match_jax(overlaps):
    _, _, _, tm = overlaps
    jm = as_jax_m4(tm)
    idx = np.arange(len(tm))[::3]
    assert_same_m4(m4.M4Records.concat([tm, tm.swap_roles()]),
                   jm4.M4Records.concat([jm, jm.swap_roles()]))
    assert_same_m4(tm.take(idx), jm.take(idx))
    for x, y in zip(tm.fwd_query_range(), jm.fwd_query_range(), strict=True):
        np.testing.assert_array_equal(x, y)
    assert (tm.qdir == 1).any()               # the mirrored branch was taken


def _trimmed(overlaps):
    jrs, rs, _, tm = overlaps
    return lcr.trim_reads(rs, tm), jlcr.trim_reads(jrs, as_jax_m4(tm))


def test_trim_reads_matches_jax(overlaps):
    (t_store, t_kept, t_ranges), (j_store, j_kept, j_ranges) = _trimmed(overlaps)
    assert 0 < t_store.n_reads
    assert_same_store(t_store, j_store)
    np.testing.assert_array_equal(t_kept, j_kept)
    np.testing.assert_array_equal(t_ranges, j_ranges)


@pytest.mark.parametrize("opts", ["", "--min_length=1500 --min_aligned_length=1000 --bestn 5"])
def test_filter_overlaps_matches_jax(overlaps, opts):
    jrs, rs, _, tm = overlaps
    t = overlap_filter.filter_overlaps(tm, rs.n_reads,
                                       overlap_filter.FilterOptions.from_string(opts))
    j = jfilter.filter_overlaps(as_jax_m4(tm), jrs.n_reads,
                                jfilter.FilterOptions.from_string(opts))
    assert_same_m4(t.m4, j.m4)
    assert (t.min_identity, t.max_overhang) == (j.min_identity, j.max_overhang)
    for f in ("contained", "filtered_reads", "read_ident", "read_cov"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)


def test_assemble_matches_jax(overlaps):
    """Overlap filter, string graph, path graph and contigs of the same reads
    and overlaps (filter length thresholds lowered to the 3-5.5 kb reads)."""
    jrs, rs, _, tm = overlaps
    fo = "--min_length=1500 --min_aligned_length=1000"
    t = contigs.assemble(rs, tm, overlap_filter.FilterOptions.from_string(fo),
                         min_contig_length=1000)
    j = jcontigs.assemble(jrs, as_jax_m4(tm), jfilter.FilterOptions.from_string(fo),
                          min_contig_length=1000)
    assert t.contigs.n_reads >= 1
    assert_same_store(t.contigs, j.contigs)
    assert_same_store(t.bubbles, j.bubbles)
    for tt, jt in ((t.tiles, j.tiles), (t.bubble_tiles, j.bubble_tiles)):
        assert ([[dataclasses.astuple(x) for x in c] for c in tt]
                == [[dataclasses.astuple(x) for x in c] for c in jt])
    assert (t.n_paths, t.min_identity, t.max_overhang) == (j.n_paths, j.min_identity,
                                                          j.max_overhang)
    np.testing.assert_array_equal(t.read_ident, j.read_ident)
    np.testing.assert_array_equal(t.read_cov, j.read_cov)


@pytest.mark.parametrize("s", ["", "--min_length=2000 --bestn 5 --lack_of_support",
                               "--min_identity=-1 --max_overhang 300 --unknown_flag=3"])
def test_named_options_match_jax(s):
    assert args.parse_named(s) == jargs.parse_named(s)
    assert dataclasses.asdict(overlap_filter.FilterOptions.from_string(s)) \
        == dataclasses.asdict(jfilter.FilterOptions.from_string(s))
    a = "--min_contig_length=800 --select_branch=best " + s
    assert dataclasses.asdict(contigs.AssembleOptions.from_string(a)) \
        == dataclasses.asdict(jcontigs.AssembleOptions.from_string(a))


def _linkdp_case(seed: int):
    """A random template and six 5 %-error copies of it."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, 300).astype(np.uint8)
    em = simulate.ErrorModel(sub=0.05, ins=0.05, dele=0.05)
    return t, [simulate.mutate(t, em, rng) for _ in range(6)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_linkdp_matches_jax(seed):
    """host_edit_ops (full and banded), tags_from_ops and consensus_linkdp."""
    t, qs = _linkdp_case(seed)
    tags_t, tags_j = [], []
    for i, q in enumerate(qs):
        for band in (None, 40):
            ot, oj = linkdp.host_edit_ops(q, t, band), jlinkdp.host_edit_ops(q, t, band)
            np.testing.assert_array_equal(ot[0], oj[0])
            assert ot[1:] == oj[1:]
        np.testing.assert_array_equal(linkdp._host_edit_ops_banded(q, t, 24)[0],
                                      jlinkdp._host_edit_ops_banded(q, t, 24)[0])
        ops, q0, _ = ot
        w = 0.5 + 0.1 * i
        tags_t.append(linkdp.tags_from_ops(ops, len(ops), q, q0, 0, w, max_delta=4))
        tags_j.append(jlinkdp.tags_from_ops(ops, len(ops), q, q0, 0, w, max_delta=4))
    assert tags_t == tags_j
    kept = [x for tg in tags_t if tg for x in tg]
    s_t, s_j = linkdp.consensus_linkdp(kept, len(t)), jlinkdp.consensus_linkdp(kept, len(t))
    np.testing.assert_array_equal(s_t[0], s_j[0])
    assert s_t[1:] == s_j[1:]
    assert len(s_t[0]) > len(t) // 2
    p_t = linkdp.consensus_linkdp_path(kept, len(t), 10, 200)
    assert p_t == jlinkdp.consensus_linkdp_path(kept, len(t), 10, 200)

