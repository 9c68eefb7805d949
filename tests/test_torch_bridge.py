"""The port's contig bridging against the JAX package's: link collection,
the contig graph and its path walk, the option string, the read-to-contig
mapping and the contig-to-contig extension (the JAX package forced onto its
static band), exact equality; the extension's chunk plan for contig-length
pairs. bridge_contigs end to end: test_torch_bridge_contigs.py."""

import dataclasses

import numpy as np
import pytest

from necat_tpu.bridge import bridge as jbridge
from necat_tpu.overlap import overlapper as joverlapper
from necat_tpu.overlap.m4 import M4Records as JaxM4Records
from necat_tpu.overlap.options import MapOptions as JaxMapOptions
from necat_tpu_torch.align.engine import ExtendEngine
from necat_tpu_torch.bridge import bridge
from necat_tpu_torch.io.devstore import DeviceReadStore
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap import overlapper
from necat_tpu_torch.overlap.m4 import M4Records
from necat_tpu_torch.overlap.options import MapOptions
from necat_tpu_torch.utils import shapes
from tests.test_torch_bridge_contigs import _gap_case, _overlap_case
from tests.test_trim import mk_m4
from torch_port_helpers import both_stores, cap_max_band, jax_static_band_wide  # noqa: F401

LENS = np.array([10000, 8000, 1900, 12000, 9000])


def _placement(rid, sid, qdir, qoff, qend, qsize, soff, send, vscore=100):
    return dict(qid=rid, sid=sid, qdir=qdir, qoff=qoff, qend=qend, qsize=qsize,
                soff=soff, send=send, ssize=int(LENS[sid]), vscore=vscore)


def _link_rows():
    """Reads placed on five contigs (mk_m4 rows): 0 -> 1 in both read
    orientations, a read spanning 0 -> 2 -> 3 (the covered middle 2),
    3 -> 4 reverse, a branch 1 -> 3 competing with 1 -> 4, and placements
    that stop short of a contig end (no link)."""
    rows = []
    for r, (g0, g1) in enumerate([(4000, 4500), (3900, 4400), (4100, 4700)]):
        rows += [_placement(r, 0, 0, 0, g0, 9000, 6000 + r * 10, 10000),
                 _placement(r, 1, 0, g1, 9000, 9000, 0, 4500 - r * 30)]
    # a reverse-strand read over 0 -> 1 (placements in qdir-strand coordinates)
    rows += [_placement(3, 1, 1, 0, 4500, 9000, 0, 4480),
             _placement(3, 0, 1, 5000, 9000, 9000, 6000, 10000)]
    for r in (4, 5):                              # 0 -> 2 -> 3 and 0 -> 3
        rows += [_placement(r, 0, 0, 0, 3000, 9000, 7000, 10000),
                 _placement(r, 2, 0, 3300, 5200, 9000, 0, 1900),
                 _placement(r, 3, 0, 5500, 9000, 9000, 0, 3500)]
    for r in (6, 7, 8):                           # 3 -> 4, 4 reversed
        rows += [_placement(r, 3, 0, 0, 4000, 8000, 8000, 12000),
                 _placement(r, 4, 1, 4200, 8000, 8000, 5200, 9000)]
    for r in (9, 10):                             # 1 -> 4 competing with 1 -> 3
        rows += [_placement(r, 1, 0, 0, 3000, 7000, 5000, 8000),
                 _placement(r, 4, 0, 3400, 7000, 7000, 0, 3600)]
    rows += [_placement(11, 0, 0, 0, 3000, 7000, 3000, 6000),    # far from the ends
             _placement(11, 1, 0, 3500, 7000, 7000, 2000, 5500)]
    return rows


def _m4_pair(rows):
    jm4 = mk_m4(rows)
    return jm4, M4Records(**{f.name: getattr(jm4, f.name) for f in dataclasses.fields(jm4)})


def _graph_view(g, paths):
    edges = {k: (e.support, e.removed, e.med_gap(), sorted(e.reads()),
                 None if e.covered is None else tuple((c.u, c.v) for c in e.covered))
             for k, e in g.edges.items()}
    return edges, [[(n, None if e is None else (e.u, e.v)) for n, e in p] for p in paths]


@pytest.mark.parametrize("method", ["no", "one", "best"])
@pytest.mark.parametrize("min_support", [1, 2])
def test_links_and_contig_graph_match_jax(method, min_support):
    """find_links, then ContigGraph's drop_weak, remove_covered_edges and
    identify_paths with each select_branch: identical links, edges and
    paths."""
    jm4, m4 = _m4_pair(_link_rows())
    opts = bridge.BridgeOptions(min_support=min_support, select_branch=method)
    jopts = jbridge.BridgeOptions(**dataclasses.asdict(opts))
    links = bridge.find_links(m4, LENS, opts)
    assert dict(links) == dict(jbridge.find_links(jm4, LENS, jopts))
    assert (0, 0, 1, 0) in links and (0, 0, 2, 0) in links and (3, 0, 4, 1) in links
    views = []
    for mod, o in ((bridge, opts), (jbridge, jopts)):
        g = mod.ContigGraph(o)
        for key, ev in links.items():
            g.add_link(key, [(e, False) for e in ev])
        g.drop_weak(o.min_support)
        g.remove_covered_edges()
        views.append(_graph_view(g, g.identify_paths()))
    assert views[0] == views[1]
    assert any(len(p) > 1 for p in views[0][1])


@pytest.mark.parametrize("s", [
    "", "--read2ctg_min_identity=82 --select_branch=best",
    "--read2ctg_min_aligned_length=1500 --read2ctg_min_coverage=3 "
    "--ctg2ctg_min_aligned_length=1000 --window_size=800 --num_threads=4"])
def test_bridge_options_from_string_matches_jax(s):
    opts = bridge.BridgeOptions.from_string(s)
    assert dataclasses.asdict(opts) == dataclasses.asdict(jbridge.BridgeOptions.from_string(s))


# the map options bridge_contigs uses by default
BRIDGE_MAP = MapOptions(scan_window=5, ncan=20, block_score_cutoff=2, max_hits=1 << 20,
                        max_pairs=8192)


def _same_m4(m4, jm4):
    for f in dataclasses.fields(JaxM4Records):
        np.testing.assert_array_equal(getattr(m4, f.name), getattr(jm4, f.name), f.name)


def test_map_reads_to_reference_matches_jax(jax_static_band_wide, monkeypatch):
    """Raw reads of the gap case mapped to its contigs (band 256, the
    bridge's map options): identical M4 arrays."""
    cap_max_band(monkeypatch, 1024)
    contigs, names, reads, _ = _gap_case()
    (jr, r), (jc, c) = both_stores(reads), both_stores(contigs)
    m4 = overlapper.map_reads_to_reference(r, c, BRIDGE_MAP, device="cpu",
                                           min_align_size=2000, band_width=256)
    jmo = JaxMapOptions(**dataclasses.asdict(BRIDGE_MAP))
    jm4 = joverlapper.map_reads_to_reference(jr, jc, jmo, min_align_size=2000,
                                             band_width=256)
    assert len(m4) >= 6
    _same_m4(m4, jm4)


def test_c2c_extension_past_top_tier_matches_jax(jax_static_band_wide, monkeypatch):
    """The contig-to-contig search and extension of the overlap case
    (_add_c2c_links' calls) with the port's length tiers cut at 8192 and its
    chunk budget at one lane of the 32768 tier, so that both contigs lie
    beyond the largest tier as megabase contigs do: every chunk holds one
    lane, and the M4 rows equal the JAX package's (its own tiers, chunks of
    8 lanes)."""
    cap_max_band(monkeypatch, 1024)
    monkeypatch.setattr(shapes, "LENGTH_TIERS", (2048, 4096, 8192))
    monkeypatch.setattr(shapes, "EXTENSION_BYTES", 32768 * 256)
    lanes, plan = [], ExtendEngine.plan

    def spy(self, *args, **kwargs):
        chunks = plan(self, *args, **kwargs)
        lanes.extend(p["PB"] for p in chunks)
        return chunks

    monkeypatch.setattr(ExtendEngine, "plan", spy)
    contigs = _overlap_case()[0]
    jc, c = both_stores(contigs)
    kw = dict(min_align_size=bridge.BridgeOptions().c2c_min_len, min_ident=80.0,
              band_width=256)
    m4 = overlapper.extend_candidates(
        overlapper.find_all_candidates(c, c, BRIDGE_MAP, pairwise=True, device="cpu"),
        c, c, device="cpu", **kw)
    jmo = JaxMapOptions(**dataclasses.asdict(BRIDGE_MAP))
    jm4 = joverlapper.extend_candidates(
        joverlapper.find_all_candidates(jc, jc, jmo, pairwise=True), jc, jc, **kw)
    assert len(m4) >= 1 and lanes and set(lanes) == {1}
    _same_m4(m4, jm4)


@pytest.mark.parametrize("qlen, W, n, lanes", [
    (300_000, 256, 3, [4]),                  # 524288 tier: up to 16 pairs, no floor of 8
    (300_000, 4096, 3, [1, 1, 1]),           # one pair a chunk
    (3_000_000, 256, 3, [2, 1]),             # 4 Mi tier: two pairs a chunk
    (30_000, 256, 3, [8]),                   # read tiers keep their chunks
    (30_000, 4096, 20, [16, 8])])
def test_plan_sizes_contig_length_chunks(qlen, W, n, lanes):
    """ExtendEngine.plan beyond the largest length tier (the c2c extension
    of megabase contigs): a chunk holds what EXTENSION_BYTES allows for
    L * W dirs bytes, at least one pair, padded to a power of two of
    its pairs; at the read tiers the chunks stay as they were."""
    dev = DeviceReadStore(ReadStore.from_seqs([np.zeros(16, np.uint8)] * 2), "cpu")
    q = np.full(n, qlen, np.int64)
    plan = ExtendEngine(dev, dev).plan(np.zeros(n, np.int64), np.zeros(n, np.int32), q,
                                       np.zeros(n, np.int64), q, q // 2, q // 2, W)
    assert [p["PB"] for p in plan] == lanes
    assert sum(p["n_real"] for p in plan) == n
