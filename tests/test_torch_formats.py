"""The port's public host helpers against the JAX package's on the same numpy
inputs: the packed read-store container, the host consensus compaction,
the k-mer index's size statistics and the bench FASTA writer."""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from necat_tpu.consensus import backbone as jbackbone
from necat_tpu.index.kmer_index import KmerIndex as JaxKmerIndex
from necat_tpu.io import readstore as jreadstore
from necat_tpu.utils import benchdata as jbenchdata
from necat_tpu_torch.consensus import backbone
from necat_tpu_torch.index.kmer_index import KmerIndex
from necat_tpu_torch.io import readstore
from necat_tpu_torch.utils import benchdata
from torch_port_helpers import SMALL_MAP_OPTIONS, small_store


def _stores(case):
    """(JAX store, port store) of one container case."""
    rng = np.random.default_rng(5)
    if case == "zero_reads":
        seqs, names = [], []
    else:
        lens = rng.integers(50, 3000, 20)
        if case == "total_not_multiple_of_16" and lens.sum() % 16 == 0:
            lens[-1] += 7
        seqs = [rng.integers(0, 4, int(n)).astype(np.uint8) for n in lens]
        names = [""] * 20 if case == "empty_names" else [f"read{i} x=1" for i in range(20)]
    return (jreadstore.ReadStore.from_seqs(seqs, names),
            readstore.ReadStore.from_seqs(seqs, names))


def _same_store(a, b):
    assert a.names == b.names
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.bases, b.bases)
    assert a.bases.dtype == b.bases.dtype == np.uint8


@pytest.mark.parametrize("case", ["named", "empty_names", "total_not_multiple_of_16",
                                  "zero_reads"])
def test_packed_container_matches_jax(tmp_path, case):
    """A store dumped by either package loads in the other, array for array,
    and the two files are the same bytes."""
    jstore, store = _stores(case)
    if case == "total_not_multiple_of_16":
        assert store.total_bases % 16
    readstore.dump_packed(store, tmp_path / "port.ntpc")
    jreadstore.dump_packed(jstore, tmp_path / "jax.ntpc")
    assert (tmp_path / "port.ntpc").read_bytes() == (tmp_path / "jax.ntpc").read_bytes()
    _same_store(readstore.load_packed(tmp_path / "jax.ntpc"), jstore)
    _same_store(jreadstore.load_packed(tmp_path / "port.ntpc"), store)
    back = readstore.load_packed(tmp_path / "port.ntpc")
    assert isinstance(back, readstore.ReadStore)
    _same_store(back, store)


def test_packed_container_refuses_other_files(tmp_path):
    """A bad magic and an unknown version raise ValueError in both packages."""
    _, store = _stores("named")
    good = tmp_path / "good.ntpc"
    readstore.dump_packed(store, good)
    data = good.read_bytes()
    (tmp_path / "magic.ntpc").write_bytes(b"XXXX" + data[4:])
    (tmp_path / "version.ntpc").write_bytes(
        data[:4] + np.array([2], np.uint64).tobytes() + data[12:])
    for bad, msg in (("magic.ntpc", "not a packed read store"),
                     ("version.ntpc", "unsupported version 2")):
        for load in (readstore.load_packed, jreadstore.load_packed):
            with pytest.raises(ValueError, match=msg):
                load(tmp_path / bad)


def test_unpack_2bit_matches_jax():
    rng = np.random.default_rng(8)
    bases = rng.integers(0, 4, 1000).astype(np.uint8)
    words = readstore.pack_2bit(bases)
    for n in (0, 1, 15, 16, 17, 999, 1000):
        got = readstore.unpack_2bit(words, n)
        np.testing.assert_array_equal(got, jreadstore.unpack_2bit(words, n))
        np.testing.assert_array_equal(got, bases[:n])


def test_compact_consensus_intervals():
    """tests/test_consensus.py::test_compact_consensus_intervals on the port's
    compaction, and the JAX package's on the same arrays."""
    TB, L, D = 1, 3000, 2
    emit = np.zeros((TB, L, D), bool)
    base = np.zeros((TB, L, D), np.uint8)
    cov = np.zeros((TB, L), np.int32)
    cov[0, 100:800] = 5      # 700 >= min_size
    cov[0, 2500:2900] = 5    # 400 < min_size -> dropped
    emit[0, :, 0] = True
    base[0, :, 0] = 2
    tmpl = np.ones((TB, L), np.uint8)
    args = (emit, base, cov, np.array([3000]), tmpl)
    kw = dict(min_cov=4, min_size=500, raw_min_gap=1000)
    out = backbone.compact_consensus(*args, **kw)
    cns, raw = out[0]
    assert len(cns) == 1
    s, e, seq = cns[0]
    assert (s, e) == (100, 800)
    assert len(seq) == 700 and np.all(seq == 2)
    # raw: [0,100) too small; [800,3000) >= 1000 -> raw passthrough
    assert len(raw) == 1 and raw[0][:2] == (800, 3000)
    assert np.all(raw[0][2] == 1)
    _same_pieces(out, jbackbone.compact_consensus(*args, **kw))


def _same_pieces(a, b):
    assert len(a) == len(b)
    for (ac, ar), (bc, br) in zip(a, b):
        assert [p[:2] for p in ac] == [p[:2] for p in bc]
        assert [p[:2] for p in ar] == [p[:2] for p in br]
        for (_, _, x), (_, _, y) in zip(ac + ar, bc + br):
            assert x.dtype == y.dtype == np.uint8
            np.testing.assert_array_equal(x, y)


# min_run as -f 1 runs it: 0.85 * min_size (consensus/correct.py)
FULL_RUN = int(0.85 * 20)


def _run_shaped_case(rng, TB, L, D):
    """Tag tensors whose covered runs are 10-30 columns long, many of them
    between FULL_RUN and min_size (20), with insertions strong enough that
    such a run still emits min_size bases."""
    w = rng.random((TB, D, 5, L)).astype(np.float32) * 3
    w[:, 1, 0, ::2] = 9.0               # an insertion every other column
    cov = np.zeros((TB, L), np.int32)
    for b in range(TB):
        t = int(rng.integers(0, 5))
        while t < L:
            n = int(rng.integers(10, 31))
            cov[b, t:t + n] = rng.integers(4, 12, len(cov[b, t:t + n]))
            t += n + int(rng.integers(1, 6))
    return w, cov


@pytest.mark.parametrize("seed,cov_lo,min_run", [
    pytest.param(11, 0, None, id="11-0"),
    pytest.param(9, 0, None, id="9-0"),
    pytest.param(5, 3, None, id="5-3"),
    pytest.param(11, 0, FULL_RUN, id="11-0-full_consensus"),
    pytest.param(5, 3, FULL_RUN, id="5-3-full_consensus"),
    pytest.param(7, "runs", None, id="runs-min_size"),
    pytest.param(7, "runs", FULL_RUN, id="runs-full_consensus"),
])
def test_compact_consensus_is_the_oracle_of_packed_and_stream(seed, cov_lo, min_run):
    """The port's compact_from_packed and compact_from_stream give its
    compact_consensus' pieces on random tag tensors (the cases of
    tests/test_consensus.py:232-262, whose coverage from 0 leaves raw pieces
    only, and one with coverage from 3, which gives corrected pieces too),
    and compact_consensus gives the JAX package's on the same arrays. With a
    min_run below min_size (-f 1's), and on covered runs shaped about both
    thresholds ("runs"), compact_from_stream equals compact_from_packed
    piece for piece."""
    rng = np.random.default_rng(seed)
    TB, L, D = 4, 256, 8
    if cov_lo == "runs":
        w, cov = _run_shaped_case(rng, TB, L, D)
    else:
        w = rng.random((TB, D, 5, L)).astype(np.float32) * 3
        cov = rng.integers(cov_lo, 12, (TB, L)).astype(np.int32)
    tlens = np.array([256, 200, 128, 0], np.int32)
    templates = rng.integers(0, 4, (TB, L)).astype(np.uint8)
    wt, ct = torch.from_numpy(w), torch.from_numpy(cov)
    packed = backbone.consensus_packed(wt, ct, 4, 0.3, 1.0).numpy()
    stream, cum_t, _, cov8 = (x.numpy() for x in backbone.consensus_stream(wt, ct, 4, 0.3, 1.0))
    from_stream = backbone.compact_from_stream(stream, cum_t, cov8, tlens, templates, 4, 20, 50,
                                               min_run=min_run)
    _same_pieces(from_stream, backbone.compact_from_packed(packed, tlens, templates, 20, 50,
                                                           max_delta=D, min_run=min_run))
    if cov_lo == "runs":
        # the two thresholds differ on this coverage: -f 1 keeps more pieces
        n_at = [sum(len(c) for c, _ in backbone.compact_from_stream(
            stream, cum_t, cov8, tlens, templates, 4, 20, 50, min_run=m)) for m in (None,
                                                                                   FULL_RUN)]
        assert 0 < n_at[0] < n_at[1]
    if min_run is not None:
        return
    emit, base = backbone.call_consensus(wt, ct, 4, 0.3, 1.0)
    dense = backbone.compact_consensus(emit.numpy(), base.numpy(), cov, tlens, templates,
                                       4, 20, 50)
    if cov_lo != "runs":
        assert (sum(len(c) for c, _ in dense) > 0) == (cov_lo > 0)
    jemit, jbase = jbackbone.call_consensus(jnp.asarray(w), jnp.asarray(cov), 4, 0.3, 1.0)
    np.testing.assert_array_equal(emit.numpy(), np.asarray(jemit))
    np.testing.assert_array_equal(base.numpy(), np.asarray(jbase))
    _same_pieces(dense, jbackbone.compact_consensus(np.asarray(jemit), np.asarray(jbase),
                                                    cov, tlens, templates, 4, 20, 50))
    _same_pieces(from_stream, dense)


@pytest.mark.parametrize("min_run", [None, FULL_RUN], ids=["min_size", "full_consensus"])
def test_compact_from_stream_reads_template_rows_in_place(min_run):
    """Templates given as one view of the read store a row (padding rows
    included, their tlens 0) give the pieces of the dense padded_batch copy,
    raw passthrough included; the raw pieces are copies, not views."""
    rng = np.random.default_rng(13)
    TB, L, D = 4, 256, 8
    w = rng.random((TB, D, 5, L)).astype(np.float32) * 3
    cov = rng.integers(3, 12, (TB, L)).astype(np.int32)
    cov[:, 100:160] = 0                 # a gap the raw passthrough fills
    store = readstore.ReadStore.from_seqs(
        [rng.integers(0, 4, int(n)).astype(np.uint8) for n in (256, 200, 128)])
    ids = np.array([0, 1, 2, 2])
    tlens = store.lengths[ids].copy()
    tlens[3] = 0
    dense, _ = store.padded_batch(ids, pad_to=L, multiple=1)
    rows = [store.get(int(i)) for i in ids]
    wt, ct = torch.from_numpy(w), torch.from_numpy(cov)
    stream, cum_t, _, cov8 = (x.numpy() for x in backbone.consensus_stream(wt, ct, 4, 0.3, 1.0))
    args = (stream, cum_t, cov8, tlens)
    got = backbone.compact_from_stream(*args, rows, 4, 20, 50, min_run=min_run)
    _same_pieces(got, backbone.compact_from_stream(*args, dense, 4, 20, 50, min_run=min_run))
    raw = [p for _, r in got for p in r]
    assert raw and sum(len(c) for c, _ in got) > 0
    for _, _, seq in raw:
        assert not np.shares_memory(seq, store.bases)


def test_kmer_index_statistics_match_jax():
    """n_kmers and avg_multiplicity of the candidate tests' read set (both
    builds unpadded) and of an empty volume."""
    jrs, rs = small_store()
    k, occ = SMALL_MAP_OPTIONS.kmer_size, SMALL_MAP_OPTIONS.occ_cutoff
    idx = KmerIndex.build(rs.bases, rs.offsets, device="cpu", k=k, occ_cutoff=occ)
    jidx = JaxKmerIndex.build(jrs.bases, jrs.offsets, k=k, occ_cutoff=occ)
    assert idx.n_kmers == jidx.n_kmers == int(sum(max(n - k + 1, 0) for n in rs.lengths))
    assert idx.avg_multiplicity == pytest.approx(jidx.avg_multiplicity, rel=1e-12)
    empty = np.zeros(0, np.uint8), np.zeros(1, np.int64)
    idx0 = KmerIndex.build(*empty, device="cpu", k=k, occ_cutoff=occ)
    jidx0 = JaxKmerIndex.build(*empty, k=k, occ_cutoff=occ)
    assert (idx0.n_kmers, idx0.avg_multiplicity) == (jidx0.n_kmers, jidx0.avg_multiplicity)


@pytest.mark.parametrize("name", ["bench.fa", "bench.fa.gz"])
def test_write_benchmark_fasta_matches_jax(tmp_path, name):
    """The same reads from the same seed, written to the same bytes (the
    gzip members' contents: their headers carry the time)."""
    args = dict(genome_size=30_000, coverage=4.0, seed=21)
    n = benchdata.write_benchmark_fasta(tmp_path / f"port_{name}", **args)
    nj = jbenchdata.write_benchmark_fasta(tmp_path / f"jax_{name}", **args)
    assert n == nj > 0
    port, jax_ = ((tmp_path / f"{p}_{name}").read_bytes() for p in ("port", "jax"))
    if name.endswith(".gz"):
        port, jax_ = gzip.decompress(port), gzip.decompress(jax_)
    assert port == jax_
    assert port.count(b">") == n
