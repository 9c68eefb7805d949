"""The port's legacy two-program correction (fused=False) against the JAX
package's in its other modes: the long-indel rescue ladder (splice_rescue),
the fixed identity cutoff, and the adaptive band (NECAT_TPU_NO_PALLAS, the
JAX package as it runs on the CPU). In each, the records also equal the
port's fused flow's."""

import dataclasses

import pytest

from necat_tpu.consensus import correct as jcorrect
from necat_tpu_torch.consensus import correct
from necat_tpu_torch.consensus.correct import correct_reads
from necat_tpu_torch.consensus.options import CnsOptions
from test_torch_adaptive import adaptive_band  # noqa: F401
from test_torch_legacy import candidates_of, same_records
from torch_port_helpers import (as_jax, cap_max_band, indel_store,  # noqa: F401
                                jax_static_band_wide, small_store)


def _legacy_against_jax_and_fused(stores, co, min_corrected):
    """correct_reads(fused=False) of the port against the JAX package's and
    against the port's fused flow with the same options."""
    jrs, rs = stores
    call, jcall = candidates_of(rs)
    legacy = dataclasses.replace(co, fused=False)
    recs = correct_reads(rs, call, legacy, device="cpu")
    recs_j = jcorrect.correct_reads(jrs, jcall, as_jax(legacy))
    assert sum(r.corrected for r in recs_j) >= min_corrected
    same_records(recs, recs_j)
    same_records(recs, correct_reads(rs, call, co, device="cpu"))


@pytest.mark.parametrize("case", ["rescue", "fixed_cutoff"])
def test_legacy_modes_match_jax_and_fused(jax_static_band_wide, monkeypatch, case):
    """rescue: indel_store's planted insertions with rescue_long_indels
    (rescue_band_max_scale 8, shapes.MAX_BAND capped at 512 in both
    packages: W0 128, rung 512), where splice_rescue must keep the wider
    band's result for some pair. fixed_cutoff: use_fixed_ident_cutoff at
    error 0.3 (no round 0). The JAX package on its static band."""
    if case == "rescue":
        cap_max_band(monkeypatch, 512)
        spliced = []
        splice = correct.splice_rescue
        monkeypatch.setattr(correct, "splice_rescue",
                            lambda *a: spliced.append(splice(*a)) or spliced[-1])
        _legacy_against_jax_and_fused(
            indel_store(6000, 33, 34),
            CnsOptions(templates_per_batch=16, pairs_per_chunk=64,
                       rescue_long_indels=True, rescue_band_max_scale=8), 5)
        assert sum(spliced) > 0
    else:
        _legacy_against_jax_and_fused(
            small_store(G=6000, gseed=77, rseed=78, coverage=5),
            CnsOptions(templates_per_batch=4, pairs_per_chunk=32,
                       use_fixed_ident_cutoff=True, error=0.3), 5)


def test_legacy_adaptive_matches_jax_default_and_fused(adaptive_band):
    """NECAT_TPU_NO_PALLAS: the port's legacy flow on K1a -> K3a (their
    plain versions) against the JAX package's legacy flow as it runs on the
    CPU, and against the port's fused flow in the same mode."""
    _legacy_against_jax_and_fused(small_store(G=6000, gseed=77, rseed=78, coverage=5),
                                  CnsOptions(templates_per_batch=4, pairs_per_chunk=32), 5)
