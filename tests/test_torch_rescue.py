"""The long-indel rescue ladder of the port against the JAX package: the wide
plain K1/K3 against the Pallas kernels in interpret mode, the rescue
deferral of the fused chunk programs and extend_candidates (the JAX package
forced onto its static band in all of them). The correction slice with
rescue_long_indels is in test_torch_rescue_slice.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from necat_tpu.align import pallas_banded as jpb
from necat_tpu.consensus import fused as jfused
from necat_tpu.io.devstore import DeviceReadStore as JaxDeviceReadStore
from necat_tpu.overlap import overlapper as joverlapper
from necat_tpu.overlap.candidates import Candidates as JaxCandidates
from necat_tpu_torch.align import banded_kernels as bk
from necat_tpu_torch.align.engine import ExtendEngine
from necat_tpu_torch.consensus import fused
from necat_tpu_torch.io import simulate
from necat_tpu_torch.io.devstore import DeviceReadStore
from necat_tpu_torch.overlap import overlapper
from necat_tpu_torch.overlap.candidates import Candidates
from torch_port_helpers import (band_pairs, both_stores, cap_max_band,  # noqa: F401
                                jax_static_band, jax_static_band_wide)

T = torch.from_numpy


@pytest.mark.parametrize("W", [2048, 4096])
def test_wide_kernels_match_pallas(jax_static_band_wide, W):
    """K1 (from the query and target rows) and K3 (insb words 1 and 2) at
    the rescue ladder's widths, byte for byte."""
    PB, L = 8, 2048
    a, b, la, lb = band_pairs(W, PB, L, W)
    assert ((la - lb) % 2 == 1).any() and (la < lb).any()
    dirs_j, _, _, cost_j = jpb.banded_forward_pallas(
        *[jnp.asarray(x) for x in (a, b, la, lb)], W, L, interpret=True)
    dirs, cost = bk.banded_forward(T(a), T(b), T(la), T(lb), W)
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_j))
    np.testing.assert_array_equal(cost.numpy(), np.asarray(cost_j))
    for words in (1, 2):
        cols_j, insb_j, lead_j = jpb.banded_backtrack_cols(
            dirs_j, jnp.asarray(la), jnp.asarray(lb), W, max_cols=L,
            interpret=True, words=words)
        cols, insb, lead = bk.banded_backtrack_cols(dirs, T(la), T(lb), W, words)
        np.testing.assert_array_equal(cols.numpy(), np.asarray(cols_j))
        for x, y in zip(insb, insb_j, strict=True):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        np.testing.assert_array_equal(lead.numpy(), np.asarray(lead_j))
    assert (cols.numpy() >> 5).max() > 0        # insertion runs were exercised


def _planted(ins_lens, seed=5, tlen=2500):
    """Template reads 0..k-1 and query reads k..2k-1, query i a copy of
    template i at 2 % error with a random insertion of ins_lens[i] bases in
    the middle; candidate i anchors query i on template i 100 bases in (the
    shape of tests/test_rescue.py:_pair_with_insert). Returns the stores and
    the candidates of both packages (JAX store, port store, port candidates,
    JAX candidates)."""
    rng = np.random.default_rng(seed)
    em = simulate.ErrorModel(sub=0.02, ins=0.02, dele=0.02)
    subj, qry = [], []
    for n in ins_lens:
        t = rng.integers(0, 4, tlen).astype(np.uint8)
        ins = rng.integers(0, 4, n).astype(np.uint8)
        head = simulate.mutate(t[:tlen // 2], em, rng)
        tail = simulate.mutate(t[tlen // 2:], em, rng)
        subj.append(t)
        qry.append(np.concatenate([head, ins, tail]).astype(np.uint8))
    k = len(ins_lens)
    qsize = np.array([len(q) for q in qry], np.int32)
    f = dict(qid=np.arange(k, 2 * k, dtype=np.int32), sid=np.arange(k, dtype=np.int32),
             qdir=np.zeros(k, np.int8), score=np.full(k, 100, np.int32),
             qbeg=np.full(k, 100, np.int32), qend=qsize - 100,
             sbeg=np.full(k, 100, np.int32), send=np.full(k, tlen - 100, np.int32),
             qsize=qsize, ssize=np.full(k, tlen, np.int32))
    return (*both_stores(subj + qry), Candidates(**f), JaxCandidates(**f))


def _chunk_desc(rs, cands, W, nc0):
    """One fused chunk's desc (DESC_COLS + FUSED_EXTRA) for the candidates,
    template rows 0..k-1 of one bucket, as dispatch_wave builds it."""
    k = len(cands)
    eng = ExtendEngine(*[DeviceReadStore(rs, "cpu")] * 2, pairs_per_chunk=64)
    zeros = np.zeros(k, np.int64)
    extra = dict(row=np.arange(k), tsfull=cands.ssize.astype(np.int64), ws=zeros,
                 slot=np.arange(k) % 3, qe=cands.qend.astype(np.int64), nc0=nc0)
    (p,) = eng.plan(cands.qid, cands.qdir.astype(np.int32),
                    cands.qsize.astype(np.int64), rs.offsets[cands.sid],
                    cands.ssize.astype(np.int64), cands.qbeg.astype(np.int64),
                    cands.sbeg.astype(np.int64), W, extra_cols=extra)
    p["desc"][:p["n_real"], fused._C["ws"]] = p["ws"]
    return eng, p


INSERTS = (0, 100, 250, 0, 400, 30)


@pytest.mark.parametrize("rescue_defer,cols_guard", [(True, False), (True, True)])
def test_extend_scatter_rescue_matches_jax(jax_static_band, rescue_defer, cols_guard):
    """The deferral flags of one correction chunk: stats exact (deferred
    included), weights to 1e-5 (sums in another order), coverage exact."""
    jrs, rs, cands, _ = _planted(INSERTS)
    W, TB, D = 64, len(INSERTS), 8
    nc0 = np.where(np.arange(len(INSERTS)) % 2, 10_000, 0)     # half fail the guard
    eng, p = _chunk_desc(rs, cands, W, nc0)
    Lt = int(cands.ssize.max())
    cutoff = np.zeros(TB + 1, np.float32)
    jq = JaxDeviceReadStore(jrs)
    w_j, c_j, st_j = jfused.extend_scatter(
        jq.words, jq.words, jnp.asarray(p["desc"]), jnp.asarray(cutoff),
        jnp.zeros((TB + 1, D, 5, Lt), jnp.float32), jnp.zeros((TB + 1, Lt), jnp.int32),
        np.int32(400), np.float32(0.5), np.bool_(True), np.bool_(rescue_defer),
        np.bool_(cols_guard), W=W, L=p["L"], tail_match=8, insb_words=1)
    w = torch.zeros((TB + 1, D, 5, Lt), dtype=torch.float32)
    c = torch.zeros((TB + 1, Lt), dtype=torch.int32)
    st = fused.extend_scatter(eng.qdev, eng.sdev, T(p["desc"]), T(cutoff), w, c,
                              min_align_size=400, mapping_ratio=0.5,
                              allow_fullcov=True, W=W, L=p["L"],
                              rescue_defer=rescue_defer, cols_guard=cols_guard)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_j))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=1e-5)
    deferred, ok = st.numpy()[7, :p["n_real"]], st.numpy()[6, :p["n_real"]]
    assert deferred.any() and ok.any() and not (deferred & ok).any()


def test_ident_pass_cols_guard_matches_jax(jax_static_band):
    """A rescue rung's ident pass: lanes that align fewer than nc0 columns
    keep their earlier ident-buffer entries."""
    jrs, rs, cands, _ = _planted(INSERTS)
    W, TB = 64, len(INSERTS)
    nc0 = np.where(np.arange(len(INSERTS)) % 2, 10_000, 0)
    eng, p = _chunk_desc(rs, cands, W, nc0)
    rng = np.random.default_rng(3)
    ibuf = np.zeros((TB + 1, fused.IDENT_SLOTS, 3), np.float32)
    ibuf[:TB, :3] = rng.random((TB, 3, 3)).astype(np.float32) * [90, 1, 1]
    jq = JaxDeviceReadStore(jrs)
    ib_j, st_j, _ = jfused.ident_pass(jq.words, jq.words, jnp.asarray(p["desc"]),
                                      jnp.asarray(ibuf), np.int32(400), np.int32(200),
                                      np.bool_(True), W=W, L=p["L"], tail_match=8)
    ib = T(ibuf.copy())
    st, _ = fused.ident_pass(eng.qdev, eng.sdev, T(p["desc"]), ib, min_align_size=400,
                             good_end_margin=200, W=W, L=p["L"], cols_guard=True)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_j))
    np.testing.assert_allclose(ib.numpy(), np.asarray(ib_j), rtol=0, atol=1e-5)
    kept = ib.numpy()[1:TB:2, :3]                       # the guarded lanes' rows
    np.testing.assert_array_equal(kept, ibuf[1:TB:2, :3])
    assert not np.array_equal(ib.numpy()[0:TB:2], ibuf[0:TB:2])


@pytest.mark.parametrize("rescue", [False, True])
def test_extend_candidates_matches_jax(jax_static_band_wide, monkeypatch, rescue):
    """M4 records identical with and without the ladder (W0 64): rungs 256
    and 512 with shapes.MAX_BAND capped at 512 for both packages, none with
    it capped at 128, below the first rung (the JAX package with its
    rescue_long_indels off)."""
    cap_max_band(monkeypatch, 512 if rescue else 128)
    jrs, rs, cands, jcands = _planted(INSERTS)
    kw = dict(min_align_size=400, band_width=64)
    m4_j = joverlapper.extend_candidates(jcands, jrs, jrs, rescue_long_indels=rescue, **kw)
    m4_t = overlapper.extend_candidates(cands, rs, rs, device="cpu", **kw)
    for f in dataclasses.fields(m4_j):
        np.testing.assert_array_equal(getattr(m4_t, f.name), getattr(m4_j, f.name),
                                      err_msg=f.name)
    span = dict(zip(m4_t.qid.tolist(), (m4_t.qend - m4_t.qoff).tolist()))
    crossed = span.get(len(INSERTS) + 1, 0) > 2000       # the 100 bp insertion
    assert crossed == rescue
