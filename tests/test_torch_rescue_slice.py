"""The correction slice with rescue_long_indels against the JAX package
forced onto its static band (a file of its own so that test runners that
spread files over workers run it beside test_torch_rescue.py)."""

import dataclasses

import numpy as np
import pytest

from necat_tpu.consensus import correct as jcorrect
from necat_tpu.overlap.candidates import Candidates as JaxCandidates
from necat_tpu_torch.consensus import fused
from necat_tpu_torch.consensus.correct import correct_reads
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.overlap import overlapper
from necat_tpu_torch.overlap.candidates import Candidates
from torch_port_helpers import (SMALL_MAP_OPTIONS, as_jax, cap_max_band,  # noqa: F401
                                indel_store, jax_static_band_wide)


@pytest.mark.parametrize("case", ["estimating", "fixed_cutoff"])
def test_correction_slice_rescue_matches_jax(jax_static_band_wide, monkeypatch, case):
    """correct_reads with rescue_long_indels: records identical to the JAX
    package's. Estimating the cutoffs runs the round-0 ladder (W0 128, rung
    512); a fixed cutoff runs the deferral ladder of the later rounds (W0 64,
    rungs 256 and 512, then the replay at the best band). shapes.MAX_BAND is
    capped at 512 for both packages."""
    cap_max_band(monkeypatch, 512)
    widths = []
    dispatch = fused.dispatch_wave
    monkeypatch.setattr(fused, "dispatch_wave",
                        lambda *a, **k: (widths.append(k["W"]), dispatch(*a, **k))[1])
    if case == "estimating":
        jrs, rs = indel_store(6000, 33, 34)
        co = CnsOptions(templates_per_batch=16, pairs_per_chunk=64,
                        rescue_long_indels=True)
        rungs = {512}
    else:
        jrs, rs = indel_store(6000, 77, 78)
        co = CnsOptions(templates_per_batch=16, pairs_per_chunk=64,
                        rescue_long_indels=True, use_fixed_ident_cutoff=True,
                        error=0.3, band_width=64)
        rungs = {256, 512}
    ct = overlapper.find_all_candidates(rs, rs, SMALL_MAP_OPTIONS, pairwise=True,
                                        device="cpu")
    recs_t = correct_reads(rs, Candidates.concat([ct, ct.swap_roles()]), co, device="cpu")
    cj = JaxCandidates(*[getattr(ct, f.name) for f in dataclasses.fields(Candidates)])
    recs_j = jcorrect.correct_reads(jrs, JaxCandidates.concat([cj, cj.swap_roles()]),
                                    as_jax(co))
    assert rungs <= set(widths)
    assert sum(r.corrected for r in recs_j) >= 5
    assert len(recs_t) == len(recs_j)
    for a, b in zip(recs_t, recs_j):
        assert (a.tid, a.left, a.right, a.corrected) == \
            (b.tid, b.left, b.right, b.corrected)
        np.testing.assert_array_equal(a.seq, b.seq)
