"""The port's adaptive-band plain versions (on the CPU) against the JAX
package's scan path (necat_tpu/align/banded.py without Pallas): exact
equality everywhere. Dirs are compared on columns 1..lb and offs on 0..lb
(the port writes OP_PAD past lb, as K1 does)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from necat_tpu.align import banded as jbanded
from necat_tpu_torch.align import banded, banded_kernels as bk
from necat_tpu_torch.io import simulate
from test_torch_package import band_edge_pairs, long_run_walk_inputs, random_walk_inputs
from torch_port_helpers import band_pairs, extension_batch

T = torch.from_numpy
J = jnp.asarray


@pytest.fixture
def adaptive_band(monkeypatch):
    """NECAT_TPU_NO_PALLAS for both packages: the port in its adaptive mode,
    the JAX extension as it runs on the CPU with or without the variable.
    _use_pallas is read at trace time, and other files in the same worker
    force the static band, so the JAX jit caches are cleared before and
    after."""
    monkeypatch.setenv("NECAT_TPU_NO_PALLAS", "1")
    jax.clear_caches()
    assert banded.adaptive_band()
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _adaptive_case(W, case, PB=12, L=384):
    """band_pairs without the clamp (odd negative la - lb, la >> lb), then:
    "equal" la = lb on every pair; "edges" la = 0, lb = 0 and both 0 on the
    first three pairs; "drift" test_align.py:85's 10 % deletion bias (one
    pair of 3000 bases)."""
    if case == "drift":
        rng = np.random.default_rng(3)
        t = rng.integers(0, 4, 3000).astype(np.uint8)
        q = simulate.mutate(t, simulate.ErrorModel(sub=0.02, ins=0.01, dele=0.10), rng)
        a = np.zeros((1, 3072), np.uint8)
        b = np.zeros((1, 3072), np.uint8)
        a[0, :len(q)], b[0, :len(t)] = q, t
        return a, b, np.array([len(q)], np.int32), np.array([len(t)], np.int32)
    a, b, la, lb = band_pairs(W + len(case), PB, L, W, clamp=False)
    if case == "equal":
        la = lb.copy()
    elif case == "edges":
        la[0], lb[1], la[2], lb[2] = 0, 0, 0, 0
    return a, b, la, lb


def _forward_both(a, b, la, lb, W):
    dj, oj, sj, cj = jbanded.banded_forward(J(a), J(b), J(la), J(lb), W, a.shape[1])
    out = bk.banded_forward_adaptive_ref(T(a), T(b), T(la), T(lb), W, a.shape[1])
    return [np.asarray(x) for x in (dj, oj, sj, cj)], [x.numpy() for x in out]


CASES = [(64, "mixed"), (128, "mixed"), (256, "mixed"), (128, "equal"), (64, "edges"),
         (64, "drift")]


@pytest.mark.parametrize("W,case", CASES, ids=[f"{w}-{c}" for w, c in CASES])
def test_forward_adaptive_matches_jax(W, case):
    a, b, la, lb = _adaptive_case(W, case)
    if case == "mixed":
        assert ((la - lb) % 2 == 1).any() and (la < lb).any() and (la > 2 * lb).any()
    (dj, oj, sj, cj), (d, o, s, c) = _forward_both(a, b, la, lb, W)
    for p in range(len(la)):
        np.testing.assert_array_equal(d[p, :lb[p]], dj[p, :lb[p]], err_msg=f"dirs {p}")
        np.testing.assert_array_equal(o[p, :lb[p] + 1], oj[p, :lb[p] + 1],
                                      err_msg=f"offs {p}")
        assert (d[p, lb[p]:] == bk.OP_PAD).all()
    np.testing.assert_array_equal(s, sj)
    np.testing.assert_array_equal(c, cj)
    if case == "drift":
        assert o[0].max() > 200          # the band followed the ~300-base drift


@pytest.mark.parametrize("W,case", CASES[:5], ids=[f"{w}-{c}" for w, c in CASES[:5]])
def test_traceback_and_cols_match_jax(W, case):
    """banded_traceback_ref, ops_to_cols_ref (1 and 3 insb words), clip_tail
    and their composition (K3a's plain version) against the JAX functions."""
    a, b, la, lb = _adaptive_case(W, case)
    (dj, oj, _, _), (d, o, _, _) = _forward_both(a, b, la, lb, W)
    max_ops = 2 * a.shape[1]
    ops_j, n_j = jbanded.banded_traceback(J(dj), J(oj), J(la), J(lb), max_ops=max_ops)
    ops, n = bk.banded_traceback_ref(T(d), T(o), T(la), T(lb), max_ops)
    np.testing.assert_array_equal(ops.numpy(), np.asarray(ops_j))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_j))
    nc_j, m_j = jbanded.clip_tail(ops_j, n_j, J(a), J(b))
    nc, m = bk.clip_tail(ops, n, T(a), T(b))
    np.testing.assert_array_equal(nc.numpy(), np.asarray(nc_j))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))
    MC = a.shape[1]
    for words in (1, 3):
        cols_j, insb_j, lead_j = jbanded.ops_to_cols(ops_j, n_j, J(a), J(b), MC=MC,
                                                     words=words)
        got = bk.ops_to_cols_ref(ops, n, T(a), T(b), MC, words)
        k3a = bk.adaptive_backtrack_cols(T(d), T(o), T(a), T(b), T(la), T(lb), W, words)
        for out in (got, k3a):
            cols, insb, lead = out
            np.testing.assert_array_equal(cols.numpy(), np.asarray(cols_j))
            assert len(insb) == len(insb_j) == words
            for x, y in zip(insb, insb_j):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            np.testing.assert_array_equal(lead.numpy(), np.asarray(lead_j))
    assert (np.asarray(cols_j) >> 5).max() > 0     # insertion runs were exercised


def test_backtrack_cols_random_walks_match_jax():
    """K3a's plain version on random dirs and offs against the JAX
    traceback + ops_to_cols, 1 and 3 insb words: walks stopped on OP_PAD
    (their columns counted from the stop, as the JAX op string counts them)
    and slots clipped at both band edges."""
    dirs, offs, a, b, la, lb = random_walk_inputs(17)
    W, MC = dirs.shape[2], dirs.shape[1]
    ops_j, n_j = jbanded.banded_traceback(J(dirs), J(offs), J(la), J(lb),
                                          max_ops=a.shape[1] + MC)
    for words in (1, 3):
        cols_j, insb_j, lead_j = jbanded.ops_to_cols(ops_j, n_j, J(a), J(b), MC=MC,
                                                     words=words)
        cols, insb, lead = bk.adaptive_backtrack_cols(*[T(x) for x in (dirs, offs, a, b,
                                                                        la, lb)], W, words)
        np.testing.assert_array_equal(cols.numpy(), np.asarray(cols_j))
        for x, y in zip(insb, insb_j):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        np.testing.assert_array_equal(lead.numpy(), np.asarray(lead_j))
    # some walks stopped short of the origin: fewer ops than la + lb
    ops = np.asarray(ops_j)
    moved = ((ops == 0) * 2 + (ops == 1) + (ops == 2)).sum(axis=1)
    assert (moved < la + lb).any()


def _cols_both(dirs, offs, a, b, la, lb, W, words):
    """K3a's plain version and the JAX traceback + ops_to_cols on the same
    dirs and offs; asserts equality, returns the cols and the JAX ops."""
    MC = dirs.shape[1]
    ops_j, n_j = jbanded.banded_traceback(J(dirs), J(offs), J(la), J(lb),
                                          max_ops=a.shape[1] + MC)
    cols_j, insb_j, lead_j = jbanded.ops_to_cols(ops_j, n_j, J(a), J(b), MC=MC, words=words)
    cols, insb, lead = bk.adaptive_backtrack_cols(*[T(x) for x in (dirs, offs, a, b, la, lb)],
                                                  W, words)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(cols_j))
    assert len(insb) == len(insb_j) == words
    for x, y in zip(insb, insb_j):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(lead.numpy(), np.asarray(lead_j))
    return cols.numpy(), np.asarray(ops_j)


@pytest.mark.parametrize("W", [64, 128, 512, 1024])
def test_band_decision_edges_match_jax(W):
    """band_edge_pairs: first-minimum ties at lanes W//3, W//3 + 1 and 2W//3,
    2W//3 + 1 (the first lane of a tie decides the shift), runs of shifts by
    2 (from 512 the band's rows move past a warp boundary every column) and
    an insertion run of g > 21 bases (at 1024 one across K3a's warp
    boundary): the plain versions equal the JAX scan, traceback and
    ops_to_cols at 1 and 3 insb words. The clip of off at max(la, 0) never
    binds: a shift needs the first minimum past lane W//3, in a row <= la."""
    a, b, la, lb, ties = band_edge_pairs(W)
    for p, (j, lane) in ties.items():
        S = bk.banded_forward_adaptive_ref(T(a[p:p + 1]), T(b[p:p + 1]), T(la[p:p + 1]),
                                           T(lb[p:p + 1]), W, max_cols=j)[2][0]
        assert int(S.argmin()) == lane and S[lane] == S[lane + 1] < bk.INF
    (dj, oj, sj, cj), (d, o, s, c) = _forward_both(a, b, la, lb, W)
    for p in range(len(la)):
        np.testing.assert_array_equal(d[p, :lb[p]], dj[p, :lb[p]], err_msg=f"dirs {p}")
        np.testing.assert_array_equal(o[p, :lb[p] + 1], oj[p, :lb[p] + 1],
                                      err_msg=f"offs {p}")
    np.testing.assert_array_equal(s, sj)
    np.testing.assert_array_equal(c, cj)
    if W < 1024:
        assert (np.diff(o, axis=1) == 2).sum() > 10
    for words in (1, 3):
        cols, _ = _cols_both(d, o, a, b, la, lb, W, words)
        assert (cols >> 5).max() > 3 * bk.N_INSB


@pytest.mark.parametrize("W", [64, 1024])
def test_backtrack_long_runs_and_pad_stops_match_jax(W):
    """K3a's plain version on long_run_walk_inputs (insertion runs past 3
    insb words; walks stopped on OP_PAD, which K3a walks twice) against the
    JAX traceback + ops_to_cols, 1 and 3 insb words."""
    dirs, offs, a, b, la, lb = long_run_walk_inputs(W, W)
    for words in (1, 3):
        cols, ops = _cols_both(dirs, offs, a, b, la, lb, W, words)
    assert ((cols >> 5) > 3 * bk.N_INSB).any()
    moved = ((ops == 0) * 2 + (ops == 1) + (ops == 2)).sum(axis=1)
    assert (moved < la + lb).any()


@pytest.mark.parametrize("W,insb_words", [(64, 1), (128, 3)])
def test_extend_batch_adaptive_matches_jax(adaptive_band, W, insb_words):
    """extend_batch with NECAT_TPU_NO_PALLAS against _extend_batch_jit on the
    CPU (its scan path), every field."""
    args = extension_batch(5, 8, 1024)
    ref = jbanded._extend_batch_jit(*[J(x) for x in args], W=W,
                                    tail_match=jbanded.TAIL_MATCH, insb_words=insb_words)
    bk.reset_launches()
    out = banded.extend_batch(*[T(x) for x in args], W=W, insb_words=insb_words)
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    assert (out["qoff"].numpy() > 0).any() or (out["qend"].numpy() < args[1]).any()


def test_extend_batch_mode_is_read_at_each_call(monkeypatch):
    """The variable picks the band at each call: K1a/K3a under it, K1/K3
    without it (the wrappers spied on), with the same results as before."""
    args = [T(x) for x in extension_batch(6, 8, 1024)]
    calls = []
    for name in ("banded_forward", "banded_backtrack_cols", "banded_forward_adaptive",
                 "adaptive_backtrack_cols"):
        fn = getattr(bk, name)
        monkeypatch.setattr(bk, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    monkeypatch.delenv("NECAT_TPU_NO_PALLAS", raising=False)
    static = banded.extend_batch(*args, W=64)
    assert calls == ["banded_forward", "banded_backtrack_cols"]
    monkeypatch.setenv("NECAT_TPU_NO_PALLAS", "1")
    banded.extend_batch(*args, W=64)
    assert calls[2:] == ["banded_forward_adaptive", "adaptive_backtrack_cols"]
    monkeypatch.delenv("NECAT_TPU_NO_PALLAS")
    again = banded.extend_batch(*args, W=64)
    assert calls[4:] == ["banded_forward", "banded_backtrack_cols"]
    assert all(torch.equal(static[k], again[k]) for k in static)
