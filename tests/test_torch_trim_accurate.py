"""TRIM_METHOD=accurate of the port (trim_reads_accurate: cover ranges, then
a fixed-cutoff re-consensus of each read over its range) against the JAX
package's, from the same overlaps (the JAX package forced onto its static
band), exact equality."""

import dataclasses

import numpy as np
import pytest

from necat_tpu.overlap.m4 import M4Records as JaxM4Records
from necat_tpu.trim import accurate as jaccurate
from necat_tpu_torch.overlap.m4 import M4Records
from necat_tpu_torch.overlap.overlapper import overlap_all_vs_all
from necat_tpu_torch.trim import accurate
from torch_port_helpers import SMALL_MAP_OPTIONS, jax_static_band, small_store  # noqa: F401


@pytest.mark.parametrize("min_ident, cns_overrides", [(91.0, None), (70.0, {"error": 0.3})])
def test_trim_reads_accurate_matches_jax(jax_static_band, min_ident, cns_overrides):
    """small_store's reads (12 kb genome, 6x), their all-vs-all overlaps from
    the port, trimmed in both packages: identical trimmed reads, kept ids
    and ranges. The defaults (overlaps and alignments of >= 91 and 90 %
    identity, for corrected reads) keep none of these raw reads; cuts of 70
    % keep most."""
    jstore, store = small_store()
    m4 = overlap_all_vs_all(store, SMALL_MAP_OPTIONS, device="cpu")
    jm4 = JaxM4Records(**{f.name: getattr(m4, f.name) for f in dataclasses.fields(m4)})
    opts = accurate.TrimAccurateOptions(min_ident=min_ident)
    trimmed, kept, ranges = accurate.trim_reads_accurate(store, m4, opts, cns_overrides,
                                                         device="cpu")
    jtrimmed, jkept, jranges = jaccurate.trim_reads_accurate(
        jstore, jm4, jaccurate.TrimAccurateOptions(**dataclasses.asdict(opts)), cns_overrides)
    np.testing.assert_array_equal(kept, jkept)
    np.testing.assert_array_equal(ranges, jranges)
    assert trimmed.names == jtrimmed.names
    np.testing.assert_array_equal(trimmed.offsets, jtrimmed.offsets)
    np.testing.assert_array_equal(trimmed.bases, jtrimmed.bases)
    if cns_overrides:
        assert len(kept) >= store.n_reads // 2


def test_trim_reads_accurate_without_overlaps():
    _, store = small_store()
    trimmed, kept, ranges = accurate.trim_reads_accurate(store, M4Records.empty(),
                                                         device="cpu")
    assert trimmed.n_reads == 0 and kept.shape == (0,) and ranges.shape == (0, 2)
