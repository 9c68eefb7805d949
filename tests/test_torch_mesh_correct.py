"""correct_reads on a list of devices (buckets round-robin over them, one
read store and engine per device) against one device: the correction half
of __graft_entry__.py's dry run, which holds the JAX package's records on n
devices to its one-device records."""

import dataclasses

import numpy as np
import pytest

from necat_tpu_torch.consensus.correct import correct_reads
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.io import simulate
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.overlap.candidates import Candidates
from necat_tpu_torch.overlap.options import MapOptions
from necat_tpu_torch.overlap.overlapper import find_all_candidates

import torch_port_helpers  # noqa: F401  (one torch thread per test process)

# __graft_entry__.py's dry-run options
PINNED = CnsOptions(templates_per_batch=4, pairs_per_chunk=32, buckets_per_supergroup=2,
                    band_width=64)


def _key(r):
    return (r.tid, r.left, r.right, r.corrected, r.seq.tobytes())


@pytest.fixture(scope="module")
def dry_run():
    """The dry run's read set, its role-expanded candidates and the one-device
    records with buckets pinned at 2 a supergroup."""
    genome = simulate.random_genome(16000, seed=9)
    reads, *_ = simulate.simulate_reads(genome, coverage=6, mean_len=3500, min_len=2500,
                                        max_len=5000, seed=10)
    rs = ReadStore.from_seqs(reads)
    mopts = MapOptions(kmer_size=13, max_hits=1 << 16, max_pairs=2048,
                       chain_min_score=20, align_size_cutoff=300)
    cands = find_all_candidates(rs, rs, mopts, pairwise=True, device="cpu")
    call = Candidates.concat([cands, cands.swap_roles()])
    return rs, call, correct_reads(rs, call, PINNED, device="cpu")


@pytest.mark.parametrize("small_memory", [False, True])
def test_correct_reads_on_devices_pinned(dry_run, small_memory):
    """buckets_per_supergroup pinned: the records of two devices equal one
    device's in order (SMALL_MEMORY: a supergroup store on each device)."""
    rs, call, want = dry_run
    got = correct_reads(rs, call, dataclasses.replace(PINNED, small_memory=small_memory),
                        device=["cpu", "cpu"])
    assert sum(r.corrected for r in want) >= 10
    assert [_key(r) for r in got] == [_key(r) for r in want]


def test_correct_reads_on_devices_unpinned(dry_run):
    """Unpinned, a supergroup holds a bucket per device: three devices give
    one device's records as a mapping from template id to its records."""
    rs, call, _ = dry_run
    opts = CnsOptions(templates_per_batch=4, pairs_per_chunk=32, band_width=64)
    by_tid = lambda recs: {t: sorted(_key(r) for r in recs if r.tid == t)
                           for t in {r.tid for r in recs}}
    one = correct_reads(rs, call, opts, device="cpu")
    assert by_tid(correct_reads(rs, call, opts, device="cpu,cpu,cpu")) == by_tid(one)
    assert np.any([r.corrected for r in one])
