"""Port DeviceReadStore row gather against the JAX package's, exact."""

import numpy as np
import pytest
import torch

from necat_tpu.io.devstore import DeviceReadStore as JaxDeviceReadStore
from necat_tpu_torch.io.devstore import DeviceReadStore
from necat_tpu_torch.io.readstore import ReadStore
from torch_port_helpers import both_stores


@pytest.mark.parametrize("rc", [False, True])
def test_gather_rows_matches_jax(rc):
    rng = np.random.default_rng(21)
    reads = [rng.integers(0, 4, int(n)).astype(np.uint8)
             for n in rng.integers(50, 2000, 40)]
    jstore, store = both_stores(reads)
    jdev = JaxDeviceReadStore(jstore)
    tdev = DeviceReadStore(store, "cpu")
    L = 2048
    ids = rng.integers(0, store.n_reads, 24)
    # whole reads, and windows starting at arbitrary (non word-aligned) bases
    gstart = store.offsets[ids] + rng.integers(0, 40, len(ids))
    glen = np.minimum(store.offsets[ids + 1] - gstart, rng.integers(1, L, len(ids)))
    rcs = np.full(len(ids), rc)
    ref = np.asarray(jdev.gather(gstart, glen, rcs, L))
    np.testing.assert_array_equal(tdev.gather(gstart, glen, rcs, L).numpy(), ref)
    ref_rows = np.asarray(jdev.read_rows(ids, rcs, L))
    np.testing.assert_array_equal(tdev.read_rows(ids, rcs, L).numpy(), ref_rows)
    for k, i in enumerate(ids[:4]):
        np.testing.assert_array_equal(ref_rows[k, :len(reads[i])],
                                      store.get(int(i), rc=rc))


def test_devstore_on_cuda_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the refusal is for machines without it")
    store = ReadStore.from_seqs([np.zeros(10, np.uint8)])
    with pytest.raises(RuntimeError):
        DeviceReadStore(store, "cuda")
