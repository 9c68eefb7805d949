"""The port's static-band kernels (plain versions, on the CPU) and extension
against the JAX package's Pallas kernels in interpret mode: exact equality
everywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from necat_tpu.align import banded as jbanded
from necat_tpu.align import engine as jengine
from necat_tpu.align import pallas_banded as jpb
from necat_tpu.io.devstore import DeviceReadStore as JaxDeviceReadStore
from necat_tpu_torch.align import banded, banded_kernels as bk, engine
from necat_tpu_torch.io import simulate
from necat_tpu_torch.io.devstore import DeviceReadStore
from torch_port_helpers import (band_pairs, both_stores, extension_batch,  # noqa: F401
                                jax_static_band, jax_static_band_wide)

T = torch.from_numpy


def _diag_case(W, case, PB=16, L=512):
    """K2 inputs: random bases 0..3 and lengths, the first four pairs with
    la < lb at an odd difference ("mixed"); b narrower than the MC = L
    columns, so that the last columns read PAD_TARGET ("short-target"); la
    within 8 of L, so that lanes past the row read PAD_BASE on the right
    ("long-query"); every pair with la < lb at an odd difference up to W/4,
    so that the first columns read PAD_BASE on the left ("left-pad")."""
    rng = np.random.default_rng(W + len(case))
    a = rng.integers(0, 4, (PB, L)).astype(np.uint8)
    b = rng.integers(0, 4, (PB, L)).astype(np.uint8)
    la = rng.integers(100, L, PB).astype(np.int32)
    lb = rng.integers(100, L, PB).astype(np.int32)
    if case == "mixed":
        la[:4] = lb[:4] - np.array([1, 3, 5, 7])
    elif case == "short-target":
        b = np.ascontiguousarray(b[:, :L - 3 * W // 2 - 5])
        lb = np.minimum(lb, b.shape[1]).astype(np.int32)
    elif case == "long-query":
        la = rng.integers(L - 8, L + 1, PB).astype(np.int32)
        lb = (la - rng.integers(0, W // 4 + 1, PB)).astype(np.int32)
    elif case == "left-pad":
        lb = rng.integers(W, L, PB).astype(np.int32)
        la = (lb - (2 * rng.integers(0, W // 8, PB) + 1)).astype(np.int32)
    return a, b, la, lb


@pytest.mark.parametrize("W,case", [
    pytest.param(64, "mixed", id="64"), pytest.param(128, "mixed", id="128"),
    pytest.param(256, "mixed", id="256"),
    pytest.param(100, "mixed", id="100"),                  # a W outside KERNEL_WIDTHS
    pytest.param(128, "short-target", id="128-short-target"),
    pytest.param(100, "short-target", id="100-short-target"),
    pytest.param(64, "long-query", id="64-long-query"),
    pytest.param(256, "left-pad", id="256-left-pad")])
def test_diag_sub_matrix_matches_pallas(W, case):
    """K2's plain version equals the JAX package's XLA ENC builder and its
    Pallas K2 in interpret mode, byte for byte, MC = L = 512 columns."""
    a, b, la, lb = _diag_case(W, case)
    L = a.shape[1]
    if case == "short-target":
        assert b.shape[1] < L and (lb == b.shape[1]).any()
    if case == "long-query":
        assert (la >= L - 8).all() and (la == L).any()
    if case in ("mixed", "left-pad"):
        assert ((lb - la) % 2 == 1).sum() >= 4
    ja = [jnp.asarray(x) for x in (a, b, la, lb)]
    ref_xla = np.asarray(jpb._diag_sub_matrix(*ja, W, L))
    ref_pallas = np.asarray(jpb._diag_sub_matrix_pallas(*ja, W, L, 128, interpret=True))
    out = bk.diag_sub_matrix(T(a), T(b), T(la), T(lb), W, L).numpy()
    np.testing.assert_array_equal(out, ref_xla)
    np.testing.assert_array_equal(out, ref_pallas)
    assert out.shape == (a.shape[0], L, W)
    if case == "short-target":                  # PAD_TARGET matches no query byte
        assert (out[:, b.shape[1]:] & 1).all()


@pytest.mark.parametrize("W,clamp", [(64, True), (128, True), (128, False)])
def test_banded_forward_matches_pallas(W, clamp):
    PB, L = 16, 512
    a, b, la, lb = band_pairs(7, PB, L, W, clamp=clamp)
    assert ((la - lb) % 2 == 1).any() and (la < lb).any()
    if not clamp:
        assert (la > 2 * lb).any()
    dirs_j, _, _, cost_j = jpb.banded_forward_pallas(
        *[jnp.asarray(x) for x in (a, b, la, lb)], W, L, interpret=True)
    dirs, cost = bk.banded_forward(T(a), T(b), T(la), T(lb), W)
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_j))
    np.testing.assert_array_equal(cost.numpy(), np.asarray(cost_j))


@pytest.mark.parametrize("W", [64, 128, 512])
def test_banded_forward_reads_rows_as_pallas(jax_static_band_wide, W):
    """K1 from the query and target rows reads them as the JAX package's ENC
    builder does: bases past la and lb are read as they are (not as
    padding), target columns past b's width as padding (max_cols > Lb). At
    W = 512 the JAX ENC comes from the Pallas K2 in interpret mode."""
    PB, L = (16, 512) if W < 512 else (8, 1024)
    a, b, la, lb = band_pairs(W + 3, PB, L, W)
    rng = np.random.default_rng(W)
    for i in range(PB):
        a[i, la[i]:] = rng.integers(0, 4, L - la[i])
        b[i, lb[i]:] = rng.integers(0, 4, L - lb[i])
    b = np.ascontiguousarray(b[:, :3 * L // 4])
    assert (lb > b.shape[1]).any() and (la < L).all()
    dirs_j, _, _, cost_j = jpb.banded_forward_pallas(
        *[jnp.asarray(x) for x in (a, b, la, lb)], W, L, interpret=True)
    dirs, cost = bk.banded_forward(T(a), T(b), T(la), T(lb), W, max_cols=L)
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_j))
    np.testing.assert_array_equal(cost.numpy(), np.asarray(cost_j))


@pytest.mark.parametrize("W,words", [(64, 1), (128, 1), (128, 2), (256, 3)])
def test_backtrack_matches_pallas(W, words):
    PB, L = 16, 512
    a, b, la, lb = band_pairs(11, PB, L, W)
    dirs_j, _, _, _ = jpb.banded_forward_pallas(
        *[jnp.asarray(x) for x in (a, b, la, lb)], W, L, interpret=True)
    cols_j, insb_j, lead_j = jpb.banded_backtrack_cols(
        dirs_j, jnp.asarray(la), jnp.asarray(lb), W, max_cols=L, interpret=True,
        words=words)
    cols, insb, lead = bk.banded_backtrack_cols(T(np.array(dirs_j)), T(la), T(lb),
                                                W, words)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(cols_j))
    assert len(insb) == len(insb_j) == words
    for x, y in zip(insb, insb_j):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(lead.numpy(), np.asarray(lead_j))
    assert (cols.numpy() >> 5).max() > 0        # insertion runs were exercised


@pytest.mark.parametrize("insb_words", [1, 2, 3])
def test_extend_batch_matches_jax_static_band(jax_static_band, insb_words):
    P, L, W = 8, 1024, 64
    args = extension_batch(3, P, L)
    ref = jbanded._extend_batch_jit(*[jnp.asarray(x) for x in args], W=W,
                                    tail_match=jbanded.TAIL_MATCH,
                                    insb_words=insb_words)
    out = banded.extend_batch(*[T(x) for x in args], W=W, insb_words=insb_words)
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    # some tails were clipped (one-sided junk longer than W/4)
    assert (out["qoff"].numpy() > 0).any() or (out["qend"].numpy() < args[1]).any()


def test_engine_submit_collect_stats_matches_jax(jax_static_band):
    """ExtendEngine.submit + collect_stats against the JAX engine: every
    chunk output (the gathered query rows included) and the merged per-pair
    stats. Subjects are random reads, queries mutated copies of them, every
    other one stored reverse-complemented (qdir 1); two groups and a chunk
    cap of 3 cut the pairs into several chunks."""
    rng = np.random.default_rng(9)
    em = simulate.ErrorModel(sub=0.05, ins=0.05, dele=0.05)
    n = 8
    subj = [rng.integers(0, 4, int(rng.integers(1200, 1800))).astype(np.uint8)
            for _ in range(n)]
    qry = [simulate.mutate(t, em, rng) for t in subj]
    qdir = np.arange(n) % 2
    stored = [(3 - q[::-1]).astype(np.uint8) if d else q for q, d in zip(qry, qdir)]
    jrs, rs = both_stores(subj + stored)
    qsize = np.array([len(q) for q in qry], np.int64)
    tsize = np.array([len(t) for t in subj], np.int64)
    args = (np.arange(n), np.arange(n, 2 * n), qdir, qsize, rs.offsets[:n],
            tsize, qsize // 2, tsize // 2, 64)
    groups = np.arange(n) // 5
    jeng = jengine.ExtendEngine(*[JaxDeviceReadStore(jrs)] * 2, pairs_per_chunk=3)
    jchunks = jeng.submit(*args, groups=groups)
    teng = engine.ExtendEngine(*[DeviceReadStore(rs, "cpu")] * 2, pairs_per_chunk=3)
    tchunks = teng.submit(*args, groups=groups)
    assert len(tchunks) == len(jchunks) >= 3
    for tc, jc in zip(tchunks, jchunks):
        assert (tc.n_real, tc.L, tc.group) == (jc.n_real, jc.L, jc.group)
        np.testing.assert_array_equal(tc.sel, jc.sel)
        np.testing.assert_array_equal(tc.ws, jc.ws)
        assert set(tc.out) == set(jc.out)
        for key in jc.out:
            np.testing.assert_array_equal(tc.out[key].numpy(), np.asarray(jc.out[key]),
                                          err_msg=key)
    st_t, st_j = engine.new_stats(n), jengine.new_stats(n)
    engine.collect_stats(tchunks, st_t)
    jengine.collect_stats(jchunks, st_j)
    assert st_t["lane"] == st_j["lane"]
    for key in ("qoff", "qend", "toff", "tend", "n_cols", "ident"):
        np.testing.assert_array_equal(st_t[key], st_j[key], err_msg=key)
    assert (st_t["ident"] > 75).all()       # every query aligned to its subject


def test_wrappers_refuse_other_devices():
    a = torch.zeros((8, 64), dtype=torch.uint8, device="meta")
    la = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        bk.diag_sub_matrix(a, a, la, la, 64, 64)
    with pytest.raises(ValueError):
        bk.banded_forward(a, a, la.to("meta"), la.to("meta"), 64)
