"""Shared inputs and fixtures of the necat_tpu_torch tests.

Inputs are made with numpy from a seed and handed to both packages, each
package getting its own objects (read stores, options) built from the same
arrays: the port imports nothing of necat_tpu. The JAX package runs a
different band on each backend: on the CPU its extension takes the adaptive
band scan, on the TPU the static band of its Pallas kernels. The port
implements the static band, so it is compared with the JAX package forced
onto the static band, its Pallas kernels in interpret mode
(`jax_static_band`).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from necat_tpu.consensus.options import CnsOptions as JaxCnsOptions
from necat_tpu.io.readstore import ReadStore as JaxReadStore
from necat_tpu.overlap.options import MapOptions as JaxMapOptions
from necat_tpu.utils import shapes as jax_shapes
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.io import simulate
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.options import MapOptions
from necat_tpu_torch.utils import shapes

SMALL_MAP_OPTIONS = MapOptions(kmer_size=13, max_hits=1 << 18, max_pairs=4096)


def as_jax(opts):
    """The JAX package's options with the same fields as the port's."""
    cls = {MapOptions: JaxMapOptions, CnsOptions: JaxCnsOptions}[type(opts)]
    return cls(**dataclasses.asdict(opts))


def both_stores(seqs):
    """(necat_tpu ReadStore, necat_tpu_torch ReadStore) of the same reads."""
    return JaxReadStore.from_seqs(seqs), ReadStore.from_seqs(seqs)


def cap_max_band(monkeypatch, value: int) -> None:
    """Cap the rescue ladder's band in both packages (each reads its own
    shapes.MAX_BAND at call time)."""
    monkeypatch.setattr(jax_shapes, "MAX_BAND", value)
    monkeypatch.setattr(shapes, "MAX_BAND", value)

# The plain kernel versions are long chains of small ops, which intra-op
# threads do not speed up; with one test process per core those threads
# oversubscribe the cores and slow every process several times over.
torch.set_num_threads(1)


def _force_static_band(monkeypatch, pallas_enc: bool):
    from necat_tpu.align import banded, pallas_banded
    jax.clear_caches()
    monkeypatch.setattr(banded, "_use_pallas", lambda B: B % 8 == 0)
    monkeypatch.setattr(pallas_banded, "banded_forward_pallas",
                        functools.partial(pallas_banded.banded_forward_pallas,
                                          interpret=True))
    monkeypatch.setattr(pallas_banded, "banded_backtrack_cols",
                        functools.partial(pallas_banded.banded_backtrack_cols,
                                          interpret=True))
    if pallas_enc:
        diag_pallas = pallas_banded._diag_sub_matrix_pallas
        diag_xla = pallas_banded._diag_sub_matrix
        monkeypatch.setattr(
            pallas_banded, "_diag_sub_matrix",
            lambda a, b, la, lb, W, MC: (
                diag_pallas(a, b, la, lb, W, MC, 128, interpret=True) if W >= 512
                else diag_xla(a, b, la, lb, W, MC)))
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.fixture
def jax_static_band(monkeypatch):
    """Route the JAX extension through the static-band Pallas kernels in
    interpret mode. The jit caches are cleared before and after: traces of
    the other band must not be reused, and xdist may run other test files in
    the same worker afterwards."""
    yield from _force_static_band(monkeypatch, pallas_enc=False)


@pytest.fixture
def jax_static_band_wide(monkeypatch):
    """jax_static_band for the rescue ladder's widths: from W = 512 on, the
    ENC of the interpret-mode forward comes from the Pallas K2 (in interpret
    mode) instead of the XLA Hankel stack, a stack of W slices that takes
    minutes to build at W = 2048 (below 512 the stack is the faster one)."""
    yield from _force_static_band(monkeypatch, pallas_enc=True)


def small_store(G=12000, gseed=33, rseed=34, coverage=6):
    """The read set of tests/test_consensus.py::_small_call (19 reads of
    3-5.5 kb at 6x of a 12 kb genome), as both_stores."""
    genome = simulate.random_genome(G, seed=gseed)
    reads, *_ = simulate.simulate_reads(
        genome, coverage=coverage, mean_len=4000, min_len=3000, max_len=5500,
        seed=rseed)
    return both_stores(reads)


def indel_store(G, gseed, rseed, ins=250, every=3):
    """Simulated reads at 6x (2-3.5 kb: one length tier) with a random
    insertion of `ins` bases planted in the middle of every `every`-th read:
    candidates across it hang until a rung of the ladder crosses it. Both
    packages' stores (both_stores)."""
    genome = simulate.random_genome(G, seed=gseed)
    reads, *_ = simulate.simulate_reads(genome, coverage=6, mean_len=2800, min_len=2000,
                                        max_len=3500, seed=rseed)
    rng = np.random.default_rng(rseed)
    for i in range(0, len(reads), every):
        m = len(reads[i]) // 2
        reads[i] = np.concatenate([reads[i][:m], rng.integers(0, 4, ins).astype(np.uint8),
                                   reads[i][m:]])
    return both_stores(reads)


def band_pairs(seed: int, PB: int, L: int, W: int, clamp: bool = True):
    """PB (query, target) pairs u8[PB, L] with lengths i32[PB], simulated at
    ~16 % error. Every fourth pair has a query shorter than its target by an
    odd amount (la < lb, odd difference); with clamp=False every fourth pair
    has a query far longer than its target (la >> lb). With clamp, lengths
    are clamped to |la - lb| <= W/4 as the extension clamps them."""
    rng = np.random.default_rng(seed)
    em = simulate.ErrorModel(sub=0.05, ins=0.06, dele=0.05)
    a = np.zeros((PB, L), np.uint8)
    b = np.zeros((PB, L), np.uint8)
    la = np.zeros(PB, np.int32)
    lb = np.zeros(PB, np.int32)
    for i in range(PB):
        t = rng.integers(0, 4, int(rng.integers(L // 2, L - L // 8))).astype(np.uint8)
        q = simulate.mutate(t, em, rng)[:L]
        if i % 4 == 1:
            q = q[:len(t) - 2 * int(rng.integers(1, W // 8)) - 1]
        elif i % 4 == 2 and not clamp:
            t = t[:len(t) // 3]
        a[i, :len(q)] = q
        b[i, :len(t)] = t
        la[i], lb[i] = len(q), len(t)
    if clamp:
        la, lb = np.minimum(la, lb + W // 4), np.minimum(lb, la + W // 4)
    return a, b, la.astype(np.int32), lb.astype(np.int32)


def extension_batch(seed, P, L):
    """Pairs with junk tails on either side of the query (one-sided tails far
    longer than W/4) and anchors near the middle."""
    rng = np.random.default_rng(seed)
    em = simulate.ErrorModel(sub=0.05, ins=0.05, dele=0.05)
    q = np.zeros((P, L), np.uint8)
    t = np.zeros((P, L), np.uint8)
    ql, tl, aq, at = (np.zeros(P, np.int32) for _ in range(4))
    for i in range(P):
        tt = rng.integers(0, 4, int(rng.integers(L // 2, L - 200))).astype(np.uint8)
        qq = simulate.mutate(tt, em, rng)
        junk = rng.integers(0, 4, int(rng.integers(0, 150))).astype(np.uint8)
        qq = np.concatenate([junk, qq] if i % 2 else [qq, junk])[:L]
        q[i, :len(qq)] = qq
        t[i, :len(tt)] = tt
        ql[i], tl[i] = len(qq), len(tt)
        at[i] = len(tt) // 2
        aq[i] = at[i] + (len(junk) if i % 2 else 0)
    return q, ql, t, tl, aq, at
