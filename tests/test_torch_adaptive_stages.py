"""The stages that the adaptive-band tests of test_torch_adaptive_slice.py do
not reach, the port under NECAT_TPU_NO_PALLAS against the JAX package as it
runs on the CPU by default: the all-vs-all overlaps and the fast trim, the
read-to-contig mapping with its ladder at 1024-4096, and bridge_contigs.
Exact equality: M4 arrays and trimmed reads field for field, bridged
contigs byte for byte."""

import dataclasses

import numpy as np

from necat_tpu.bridge import bridge as jbridge
from necat_tpu.io.readstore import ReadStore as JaxReadStore
from necat_tpu.overlap import overlapper as joverlapper
from necat_tpu.overlap.options import MapOptions as JaxMapOptions
from necat_tpu.trim import lcr as jlcr
from necat_tpu_torch.bridge import bridge
from necat_tpu_torch.io import simulate
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap import overlapper
from necat_tpu_torch.trim import lcr
from test_torch_adaptive import adaptive_band  # noqa: F401
from test_torch_assembly import assert_same_m4, assert_same_store, corrected_store
from test_torch_bridge import BRIDGE_MAP
from test_torch_bridge_contigs import _gap_case
from torch_port_helpers import SMALL_MAP_OPTIONS, as_jax, both_stores, cap_max_band


def test_trim_overlaps_match_jax_default(adaptive_band, monkeypatch):
    """overlap_all_vs_all of small_store's genome and read lengths at the
    error of corrected reads (what trim sees; corrected_store), the ladder
    capped at 512 in both packages, then the fast trim of each package's own
    overlaps: M4 and trimmed reads, ids and ranges identical."""
    cap_max_band(monkeypatch, 512)
    jrs, rs = corrected_store()
    tm = overlapper.overlap_all_vs_all(rs, SMALL_MAP_OPTIONS, device="cpu")
    jm = joverlapper.overlap_all_vs_all(jrs, as_jax(SMALL_MAP_OPTIONS))
    assert len(tm) >= rs.n_reads
    assert_same_m4(tm, jm)
    (t_store, t_kept, t_ranges), (j_store, j_kept, j_ranges) = \
        lcr.trim_reads(rs, tm), jlcr.trim_reads(jrs, jm)
    assert t_store.n_reads > 0
    assert_same_store(t_store, j_store)
    np.testing.assert_array_equal(t_kept, j_kept)
    np.testing.assert_array_equal(t_ranges, j_ranges)


# ladder_case's reads: (position on the contig, inserted bases) of each
# read's insertions
LADDER_READS = ((), ((4500, 470),), ((3000, 250), (3500, 250)), ((3000, 300), (3500, 300)))


def ladder_case(seed=14, clen=7000, span=(1000, 6000), plants=LADDER_READS):
    """A 7 kb contig and reads of its span copied at 1 % error per kind, with
    random insertions planted (plants): one long insertion or two close
    ones keep the candidate chain across them, but the mapping from band 256
    stops there, and the ladder climbs 1024, 2048 and 4096. (contig,
    reads)."""
    rng = np.random.default_rng(seed)
    em = simulate.ErrorModel(sub=0.01, ins=0.01, dele=0.01)
    ctg = simulate.random_genome(clen, seed=seed)
    reads = []
    for plant in plants:
        cuts = [span[0]] + [p for p, _ in plant] + [span[1]]
        parts = [simulate.mutate(ctg[cuts[0]:cuts[1]], em, rng)]
        for (_, n), lo, hi in zip(plant, cuts[1:], cuts[2:]):
            parts += [rng.integers(0, 4, n).astype(np.uint8),
                      simulate.mutate(ctg[lo:hi], em, rng)]
        reads.append(np.concatenate(parts).astype(np.uint8))
    return ctg, reads


def test_mapping_ladder_matches_jax_default(adaptive_band):
    """map_reads_to_reference at band 256 with the bridge's map options and
    the full ladder (1024-4096): identical M4 arrays, and rungs of 1024 and
    above ran."""
    ctg, reads = ladder_case()
    (jr, r), (jc, c) = both_stores(reads), both_stores([ctg])
    overlapper.pairs_by_band.clear()
    m4 = overlapper.map_reads_to_reference(r, c, BRIDGE_MAP, device="cpu",
                                           min_align_size=2000, band_width=256)
    rungs = {w for w, n in overlapper.pairs_by_band.items() if w >= 1024 and n}
    jm4 = joverlapper.map_reads_to_reference(jr, jc, JaxMapOptions(**dataclasses.asdict(
        BRIDGE_MAP)), min_align_size=2000, band_width=256)
    assert rungs == {1024, 2048, 4096}, dict(overlapper.pairs_by_band)
    assert len(m4) >= 3
    assert_same_m4(m4, jm4)


def test_bridge_contigs_matches_jax_default(adaptive_band):
    """bridge_contigs of tests/test_bridge.py's two-contig gap case with the
    full ladder: the bridged contigs byte for byte, and one contig."""
    contigs, names, reads, kw = _gap_case()
    jr, r = both_stores(reads)
    out = bridge.bridge_contigs(ReadStore.from_seqs(contigs, names), r,
                                opts=bridge.BridgeOptions(**kw), device="cpu")
    jout = jbridge.bridge_contigs(JaxReadStore.from_seqs(contigs, names), jr,
                                  opts=jbridge.BridgeOptions(**kw))
    assert out.n_reads == 1
    assert out.names == jout.names
    np.testing.assert_array_equal(out.offsets, jout.offsets)
    np.testing.assert_array_equal(out.bases, jout.bases)
