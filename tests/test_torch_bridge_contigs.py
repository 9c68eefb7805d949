"""bridge_contigs of the port against the JAX package's (forced onto its
static band, the ladder capped at 1024 in both) on tests/test_bridge.py's
cases and a contig-to-contig overlap: identical bridged sequences and
names. The cases share one static-band setting, hence the JAX package's
compiled functions."""

import numpy as np
import pytest

from necat_tpu.bridge import bridge as jbridge
from necat_tpu.io.readstore import ReadStore as JaxReadStore
from necat_tpu_torch.bridge import bridge
from necat_tpu_torch.io import seqio, simulate
from necat_tpu_torch.io.readstore import ReadStore
from torch_port_helpers import _force_static_band, both_stores, cap_max_band


def _gap_case():
    """tests/test_bridge.py:40: a 40 kb genome cut into two contigs with a
    2 kb gap; five reads at 1 % error per kind (three across the gap) and
    one reverse-strand read across it."""
    G = simulate.random_genome(40000, seed=51)
    em = simulate.ErrorModel(sub=0.01, ins=0.01, dele=0.01)
    rng = np.random.default_rng(9)
    reads = [simulate.mutate(G[s:s + 12000], em, rng) for s in (13000, 14500, 15500)]
    reads += [simulate.mutate(G[s:s + 8000], em, rng) for s in (2000, 30000)]
    reads.append(seqio.revcomp(simulate.mutate(G[14000:25000], em, rng)))
    return [G[:18000].copy(), G[20000:40000].copy()], ["c0", "c1"], reads, {"min_support": 2}


def _chain_case(perm=(0, 1, 2, 3)):
    """tests/test_bridge.py:142 (and :183 with perm): four contigs of a 36 kb
    genome, the short second one covered by reads spanning the first three,
    stored in the order perm."""
    G = simulate.random_genome(36000, seed=77)
    bounds = [(0, 10000), (10300, 12200), (12500, 23000), (23800, 36000)]
    em = simulate.ErrorModel(sub=0.01, ins=0.01, dele=0.01)
    rng = np.random.default_rng(19)
    reads = [simulate.mutate(G[s:s + 12000], em, rng) for s in (4000, 5000, 6000)]
    reads += [simulate.mutate(G[s:s + 10000], em, rng) for s in (19000, 20000, 21000)]
    contigs = [G[bounds[p][0]:bounds[p][1]].copy() for p in perm]
    return contigs, [f"c{i}" for i in range(4)], reads, {"min_support": 2,
                                                          "min_align_size": 1500}


def _overlap_case():
    """Two contigs of a 30 kb genome whose ends overlap by 3 kb, the second
    reverse-complemented, and no read across the junction: only the
    contig-to-contig overlap can join them."""
    G = simulate.random_genome(30000, seed=61)
    em = simulate.ErrorModel(sub=0.01, ins=0.01, dele=0.01)
    rng = np.random.default_rng(5)
    reads = [simulate.mutate(G[s:s + 7000], em, rng) for s in (1000, 21000)]
    return [G[:16500].copy(), seqio.revcomp(G[13500:30000])], ["a", "b"], reads, {}


CASES = {"gap": _gap_case, "covered_chain": _chain_case,
         "permuted": lambda: _chain_case((1, 0, 2, 3)), "c2c_overlap": _overlap_case}


@pytest.fixture(scope="module")
def static_band_1024():
    """jax_static_band_wide and cap_max_band(1024), once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        cap_max_band(mp, 1024)
        yield from _force_static_band(mp, pallas_enc=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bridge_contigs_matches_jax(static_band_1024, case):
    """bridge_contigs with the mapping, the contig-to-contig links and the
    junction fills: identical bridged sequences and names, and the case's
    contigs joined into one."""
    contigs, names, reads, kw = CASES[case]()
    jr, r = both_stores(reads)
    out = bridge.bridge_contigs(ReadStore.from_seqs(contigs, names), r,
                                opts=bridge.BridgeOptions(**kw), device="cpu")
    jout = jbridge.bridge_contigs(JaxReadStore.from_seqs(contigs, names), jr,
                                  opts=jbridge.BridgeOptions(**kw))
    assert out.names == jout.names
    np.testing.assert_array_equal(out.offsets, jout.offsets)
    np.testing.assert_array_equal(out.bases, jout.bases)
    assert out.n_reads == 1
    assert set(bridge.stats) >= {"map_s", "c2c_s", "graph_s", "junction_s", "links"}
