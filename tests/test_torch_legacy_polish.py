"""The polish stage through the legacy two-program correction
(NECAT_TPU_FUSED=0 in both packages): its wide-delta mode (max_delta 22)
keeps each accepted alignment for the host link-DP repair, which must get
the same alignments as the JAX package's."""

import numpy as np

from necat_tpu.consensus import correct as jcorrect
from necat_tpu.io.readstore import ReadStore as JaxReadStore
from necat_tpu.polish import polish as jpolish
from necat_tpu_torch.consensus import correct
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.polish import polish
from test_torch_polish import collapsed_repeat_case
from torch_port_helpers import cap_max_band, jax_static_band_wide  # noqa: F401


def test_legacy_polish_matches_jax(jax_static_band_wide, monkeypatch):
    """polish_contigs on the collapsed repeat with NECAT_TPU_FUSED=0, the
    JAX package on its static band, the ladder capped at 1024: the same
    polished contig, the same accepted alignments handed to the hotspot
    repair, and the same non-empty overrides."""
    cap_max_band(monkeypatch, 1024)
    monkeypatch.setenv("NECAT_TPU_FUSED", "0")
    seen = {"torch": [], "jax": []}
    for mod, key in ((correct, "torch"), (jcorrect, "jax")):
        def spy(store, b, tpls, *a, _fn=mod._bucket_hot_overrides, _key=key):
            out = _fn(store, b, tpls, *a)
            seen[_key].append((out, sorted(x for t in tpls for x in t.accepted)))
            return out
        monkeypatch.setattr(mod, "_bucket_hot_overrides", spy)
    draft, reads = collapsed_repeat_case()
    po = dict(segment_size=16384, min_ident=75.0, templates_per_batch=2)
    got = polish.polish_contigs(ReadStore.from_seqs([draft], ["ctg0"]),
                                ReadStore.from_seqs(reads), device="cpu",
                                opts=polish.PolishOptions(**po))
    want = jpolish.polish_contigs(JaxReadStore.from_seqs([draft], ["ctg0"]),
                                  JaxReadStore.from_seqs(reads),
                                  opts=jpolish.PolishOptions(**po))
    np.testing.assert_array_equal(got.get(0), want.get(0))
    assert any(ovr for ovr, _ in seen["torch"])
    assert len(seen["torch"]) == len(seen["jax"])
    for (ovr, acc), (jovr, jacc) in zip(seen["torch"], seen["jax"]):
        assert acc == jacc and len(acc) > 0
        assert ovr.keys() == jovr.keys()
        for row in ovr:
            assert ovr[row].keys() == jovr[row].keys()
            for t in ovr[row]:
                np.testing.assert_array_equal(ovr[row][t], jovr[row][t])
