"""The legacy two-program correction (fused=False, NECAT_TPU_FUSED=0) of the
port against the JAX package's: its tag scatter (scatter_pass_cols), the
host identity cutoff, the mode switch, and the slice on small_store (the
JAX package forced onto its static band) with the timing scopes on."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from necat_tpu.consensus import correct as jcorrect
from necat_tpu.consensus import tags as jtags
from necat_tpu.consensus.options import CnsOptions as JaxCnsOptions
from necat_tpu.overlap.candidates import Candidates as JaxCandidates
from necat_tpu.utils import logging as jlogging
from necat_tpu_torch.align import banded
from necat_tpu_torch.consensus import correct, tags
from necat_tpu_torch.consensus.correct import correct_reads
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.overlap.candidates import Candidates
from necat_tpu_torch.overlap.overlapper import find_all_candidates
from necat_tpu_torch.utils import logging as tlogging
from torch_port_helpers import (SMALL_MAP_OPTIONS, _force_static_band, as_jax,
                                extension_batch, small_store)

T = torch.from_numpy
CNS = CnsOptions(templates_per_batch=4, pairs_per_chunk=32)
LEGACY = dataclasses.replace(CNS, fused=False)
LANES = ("ext.lanes", "ext.real_lanes", "ext.cell_Mlanes")
# the port-only names (logging.PORT_ONLY) of the legacy flow: it has no
# fused tag scatter
LEGACY_PORT_ONLY = {"cns.padded_batch", "cns.compact_packed", "cns.emit_records",
                    "ext.live_Mcols", "cns.download_MB"}


def same_records(recs_a, recs_b):
    """(tid, left, right, corrected) and seq equal, record for record."""
    assert len(recs_a) == len(recs_b)
    for a, b in zip(recs_a, recs_b):
        assert (a.tid, a.left, a.right, a.corrected) == \
            (b.tid, b.left, b.right, b.corrected)
        np.testing.assert_array_equal(a.seq, b.seq)


def candidates_of(rs):
    """The port's role-expanded candidates of rs, and the same rows as the
    JAX package's Candidates."""
    ct = find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise=True, device="cpu")
    cj = JaxCandidates(*[getattr(ct, f.name) for f in dataclasses.fields(Candidates)])
    return (Candidates.concat([ct, ct.swap_roles()]),
            JaxCandidates.concat([cj, cj.swap_roles()]))


@pytest.mark.parametrize("D", [8, 22])
@pytest.mark.parametrize("reversed_part", [False, True])
def test_scatter_pass_cols_matches_jax(reversed_part, D):
    """One pass of extension_batch's pairs (one dropped, one past the
    template end) into float64 tensors: coverage exactly, weights within
    1e-5 of the JAX package's float32 sums."""
    P, L, W = 8, 1024, 64
    TB, Lt = 3, 1200
    q, ql, t, tl, aq, at = extension_batch(5, P, L)
    ext = banded.extend_batch(*[T(x) for x in (q, ql, t, tl, aq, at)], W=W,
                              insb_words=correct._insb_words(CnsOptions(max_delta=D)))
    rng = np.random.default_rng(2)
    pair_row = np.array([0, 1, 2, 0, 1, TB, 2, 0], np.int32)
    pair_w = (rng.random(P) * 0.5 + 0.5).astype(np.float32)
    tsize = np.minimum(tl + rng.integers(0, 50, P), Lt).astype(np.int32)
    tsize[4] = at[4] + 100
    at_abs = (at + rng.integers(0, 100, P)).astype(np.int32)
    side = "left" if reversed_part else "right"
    per_pair = (q, aq, at_abs, pair_row, pair_w, tsize)
    w_j, c_j = jtags.scatter_pass_cols(
        jnp.zeros((TB + 1, D, 5, Lt), jnp.float32), jnp.zeros((TB + 1, Lt), jnp.int32),
        *[jnp.asarray(ext[f"{side}_{k}"].numpy()) for k in ("cols", "lead", "jc")],
        *[jnp.asarray(x) for x in per_pair], reversed_part=reversed_part)
    w = torch.zeros((TB + 1, D, 5, Lt), dtype=torch.float64)
    c = torch.zeros((TB + 1, Lt), dtype=torch.int32)
    tags.scatter_pass_cols(w, c, *[ext[f"{side}_{k}"] for k in ("cols", "lead", "jc")],
                           *[T(x) for x in per_pair], reversed_part=reversed_part)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=1e-5)
    assert c.numpy()[TB].sum() == 0 and w.numpy()[TB].sum() == 0
    assert c.numpy()[:TB].sum() > 0 and w.numpy()[:TB, 1:].sum() > 0


def test_splice_rescue_matches_jax():
    """Two chunks of 3 and 2 pairs, then a rescue chunk of 4 of them whose
    rung aligns more, as many (a tie goes to the wider band) and fewer
    columns: the same stats, lanes, live lanes and count as the JAX
    package's splice_rescue."""
    from necat_tpu.align import engine as jengine
    from necat_tpu_torch.align import engine
    rng = np.random.default_rng(7)

    def chunk(mod, sel, st, PB=8):
        return mod.ExtChunk(out={}, sel=np.array(sel), n_real=len(sel), L=1024, W=128,
                            aq=np.zeros(PB, np.int32), at=np.zeros(PB, np.int32),
                            ws=np.arange(len(sel)) * 10, live=np.ones(PB, bool),
                            _stats=st)

    st = [rng.integers(1, 900, (6, 8)).astype(np.int32) for _ in range(3)]
    st[0][4, :3] = [500, 600, 700]
    st[1][4, :2] = [400, 300]
    st[2][4, :4] = [501, 600, 699, 300]             # pairs 0, 1, 2, 4: more, tie, fewer, tie
    st[2][5, :4] = st[2][4, :4] - 5
    out = []
    for mod in (engine, jengine):
        chunks = [chunk(mod, [0, 1, 2], st[0]), chunk(mod, [3, 4], st[1])]
        stats = mod.new_stats(5)
        mod.collect_stats(chunks, stats)
        n = mod.splice_rescue(chunks, [chunk(mod, [0, 1, 2, 4], st[2])], stats)
        out.append((n, stats, [c.live for c in chunks]))
    (n, stats, live), (jn, jstats, jlive) = out
    assert n == jn == 3
    assert stats["lane"] == jstats["lane"]
    for k in ("qoff", "qend", "toff", "tend", "n_cols", "ident"):
        np.testing.assert_array_equal(stats[k], jstats[k])
    for a, b in zip(live, jlive):
        np.testing.assert_array_equal(a, b)
    assert not live[0][1] and not live[2][2]          # the tie and the fewer columns


@pytest.mark.parametrize("Lt", [5, 8, 12])
def test_pad_cols_to_matches_jax(Lt):
    x = np.random.default_rng(3).integers(0, 99, (3, 8)).astype(np.int32)
    np.testing.assert_array_equal(tags.pad_cols_to(T(x), Lt, 3).numpy(),
                                  np.asarray(jtags.pad_cols_to(jnp.asarray(x), Lt, 3)))


@pytest.mark.parametrize("n", [3, 6, 15])
def test_estimate_ident_cutoff_matches_jax(n):
    """n < 5 gives 0, 5 <= n < 8 all idents, n >= 8 the top 70 %."""
    idents = 80.0 + 20.0 * np.random.default_rng(n).random(n)
    got = correct.estimate_ident_cutoff(idents)
    assert abs(got - jcorrect.estimate_ident_cutoff(idents)) <= 1e-9
    assert (got == 0.0) == (n < 5)


@pytest.mark.parametrize("fused", [None, True, False])
@pytest.mark.parametrize("env", [None, "0", "false", "1", "False"])
def test_fused_mode_precedence_matches_jax(monkeypatch, env, fused):
    """NECAT_TPU_FUSED first ("0" and "false" select the legacy flow), then
    the option, then the fused default."""
    if env is None:
        monkeypatch.delenv("NECAT_TPU_FUSED", raising=False)
    else:
        monkeypatch.setenv("NECAT_TPU_FUSED", env)
    got = correct.fused_mode(CnsOptions(fused=fused))
    assert got == jcorrect.fused_mode(JaxCnsOptions(fused=fused))
    assert got == (env not in ("0", "false") if env is not None
                   else fused is not False)


def _timed(fn, jax_too=False):
    """(fn's result, the timing report of the port, or with jax_too of the
    JAX package); both packages' timers are cleared first (the JAX
    package's lane counters count with timing off too)."""
    tlogging.reset_timers()
    jlogging._TIMERS.clear()
    jlogging._COUNTS.clear()
    out = fn()
    return out, (jlogging.timing_report() if jax_too else tlogging.timing_report())


@pytest.fixture(scope="module")
def slice_runs():
    """small_store ("on") through the port's and the JAX package's legacy
    flows, the JAX package on its static band, with the timing scopes on,
    and through the port's fused flow; a 6 kb set ("sync") through both
    legacy flows with NECAT_TPU_SYNC_DISPATCH too, and through the port's
    on the device list ["cpu", "cpu"] ("list", timing off)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        static = _force_static_band(mp, pallas_enc=False)
        next(static)
        for mode, (jrs, rs) in (("on", small_store()),
                                ("sync", small_store(G=6000, gseed=77, rseed=78,
                                                     coverage=5))):
            call, jcall = candidates_of(rs)
            mp.setattr(tlogging, "TIMING_ON", True)
            mp.setattr(jlogging, "TIMING_ON", True)
            if mode == "sync":
                mp.setenv("NECAT_TPU_SYNC_DISPATCH", "1")
            out[mode] = {
                "port": _timed(lambda: correct_reads(rs, call, LEGACY, device="cpu")),
                "jax": _timed(lambda: jcorrect.correct_reads(jrs, jcall, as_jax(LEGACY)),
                              jax_too=True)}
            mp.setattr(tlogging, "TIMING_ON", False)
            mp.setattr(jlogging, "TIMING_ON", False)
            mp.delenv("NECAT_TPU_SYNC_DISPATCH", raising=False)
            if mode == "on":
                out["fused"] = correct_reads(rs, call, CNS, device="cpu")
            else:
                out["list"] = correct_reads(rs, call, LEGACY, device=["cpu", "cpu"])
        next(static, None)
    tlogging.reset_timers()
    yield out


def test_legacy_slice_matches_jax_and_fused(slice_runs):
    """find_all_candidates -> swap_roles -> correct_reads(fused=False):
    records identical to the JAX package's legacy flow and to the port's
    fused flow (tid, left, right, corrected, seq)."""
    recs, _ = slice_runs["on"]["port"]
    recs_j, _ = slice_runs["on"]["jax"]
    assert sum(r.corrected for r in recs_j) >= 10
    same_records(recs, recs_j)
    same_records(recs, slice_runs["fused"])


def test_legacy_on_a_device_list_runs_one_device(slice_runs):
    """fused=False on ["cpu", "cpu"]: the legacy flow runs on the first
    device, and the records are the one-device run's (and the JAX
    package's)."""
    recs, _ = slice_runs["sync"]["port"]
    assert sum(r.corrected for r in recs) >= 5
    same_records(slice_runs["list"], recs)
    same_records(recs, slice_runs["sync"]["jax"][0])


@pytest.mark.parametrize("mode", ["on", "sync"])
def test_legacy_scope_names_and_calls_match_jax(slice_runs, mode):
    """In the legacy flow the port times the JAX package's scopes, less
    NO_COUNTERPART, as many times each, and counts the same lanes; besides
    them it records its own names of this path (logging.PORT_ONLY), and
    nothing else; with NECAT_TPU_SYNC_DISPATCH the scatter waits in
    cns.scatter_exec."""
    port_rep = slice_runs[mode]["port"][1]
    jax_rep = slice_runs[mode]["jax"][1]
    want = set(jax_rep) - set(tlogging.NO_COUNTERPART)
    assert LEGACY_PORT_ONLY <= set(tlogging.PORT_ONLY)
    assert set(port_rep) == want | LEGACY_PORT_ONLY
    legacy = {"cns.scatter_round_total", "cns.scatter", "cns.accept", "cns.wave_build",
              "cns.extend_pairs_total", "ext.dispatch", "ext.stats_sync"}
    assert legacy <= want and not any(k.startswith("cns.fused") for k in want)
    assert ("cns.scatter_exec" in want) == (mode == "sync")
    for k in want:
        assert port_rep[k][1] == jax_rep[k][1], k
    for k in LANES:
        assert port_rep[k] == jax_rep[k], k
