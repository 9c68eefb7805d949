"""The port's own copies of the host modules against the JAX package's
originals, on the same inputs: read store, FASTA parsing and 2-bit packing,
the native k-mer index, M4 records, the config template, the options,
the shape tiers and the simulators."""

import dataclasses
import gzip

import numpy as np
import pytest

from necat_tpu import native as jnative
from necat_tpu.consensus.options import CnsOptions as JaxCnsOptions
from necat_tpu.io import readstore as jreadstore
from necat_tpu.io import seqio as jseqio
from necat_tpu.io import simulate as jsimulate
from necat_tpu.overlap import options as joptions
from necat_tpu.overlap.m4 import M4Records as JaxM4Records
from necat_tpu.pipeline import config as jconfig
from necat_tpu.utils import benchdata as jbenchdata
from necat_tpu.utils import shapes as jshapes
from necat_tpu_torch import native
from necat_tpu_torch.consensus.options import CnsOptions
from necat_tpu_torch.index.kmer_index import _build_numpy
from necat_tpu_torch.io import readstore, seqio, simulate
from necat_tpu_torch.overlap import options
from necat_tpu_torch.overlap.m4 import M4Records
from necat_tpu_torch.pipeline import config
from necat_tpu_torch.utils import benchdata, shapes
from necat_tpu_torch.utils.build import BUILD_DIR, CSRC


def _reads(seed=3, n=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, int(k)).astype(np.uint8) for k in rng.integers(1, 3000, n)]


def _assert_same_store(a, b):
    assert list(a.names) == list(b.names)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.bases, b.bases)


def test_readstore_from_seqs_and_pack_2bit_match_jax():
    reads = _reads()
    t, j = readstore.ReadStore.from_seqs(reads), jreadstore.ReadStore.from_seqs(reads)
    _assert_same_store(t, j)
    np.testing.assert_array_equal(readstore.pack_2bit(t.bases), jreadstore.pack_2bit(j.bases))
    idx = np.array([5, 0, 17, 17, 39])
    _assert_same_store(t.subset(idx), j.subset(idx))
    _assert_same_store(readstore.ReadStore.concat([t, t.subset(idx)]),
                       jreadstore.ReadStore.concat([j, j.subset(idx)]))
    assert t.n50() == j.n50()
    np.testing.assert_array_equal(t.longest_to_coverage(5000, 3.0),
                                  j.longest_to_coverage(5000, 3.0))
    for rc in (False, True):
        for x, y in zip(t.padded_batch(idx, rc=rc), j.padded_batch(idx, rc=rc)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(t.get(7, rc=True), j.get(7, rc=True))


@pytest.mark.parametrize("name", ["reads.fasta", "reads.fa.gz", "reads.fastq"])
def test_readstore_from_fasta_matches_jax(tmp_path, name):
    """The port's native parser reads what the JAX package's reads: names,
    bases (non-ACGT as 0) and offsets; min_length filters alike."""
    rng = np.random.default_rng(8)
    seqs = ["".join(rng.choice(list("ACGTNacgt"), int(n))) for n in rng.integers(1, 900, 25)]
    path = tmp_path / name
    if "fastq" in name:
        text = "".join(f"@r{i} x\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(seqs))
    else:
        text = "".join(f">r{i} desc\n{s[:300]}\n{s[300:]}\n" for i, s in enumerate(seqs))
    (gzip.open if name.endswith(".gz") else open)(path, "wt").write(text)
    for min_length in (0, 400):
        _assert_same_store(readstore.ReadStore.from_fasta(path, min_length),
                           jreadstore.ReadStore.from_fasta(path, min_length))
    names, bases, offsets = native.read_seq_file(path)
    jnames, jbases, joffsets = jnative.read_seq_file(str(path))
    assert names == jnames
    np.testing.assert_array_equal(bases, jbases)
    np.testing.assert_array_equal(offsets, joffsets)
    t = readstore.ReadStore.from_fasta(path)
    out = tmp_path / "out.fa"
    t.to_fasta(out)
    _assert_same_store(readstore.ReadStore.from_fasta(out), jreadstore.ReadStore.from_fasta(out))
    assert seqio.read_fasta(out)[0] == jseqio.read_fasta(out)[0]


def test_native_library_builds_into_build_dir():
    """The native library is built from the port's sources into build/, and
    nothing is written beside the sources."""
    lib = native.build_library()
    assert lib.parent == BUILD_DIR and lib.exists()
    assert not [p for p in CSRC.iterdir() if p.suffix not in (".cu", ".cpp", ".h", ".cuh")]


@pytest.mark.parametrize("k,bucket_bits", [(13, 22), (15, 22), (11, 16)])
def test_native_kmer_index_matches_jax_and_numpy(k, bucket_bits):
    """Hashes, positions and bucket starts of the port's radix sort equal the
    JAX package's native build and the plain NumPy build."""
    store = readstore.ReadStore.from_seqs(_reads(seed=k, n=30))
    bits = min(bucket_bits, 2 * k)
    got = native.build_kmer_index(store.bases, store.offsets, k, bits)
    for want in (jnative.build_kmer_index(store.bases, store.offsets, k, bits),
                 _build_numpy(store.bases, store.offsets, k, bits)):
        for x, y in zip(got, want, strict=True):
            np.testing.assert_array_equal(x, np.asarray(y).astype(x.dtype))
    assert len(got[0]) > 1000


def test_m4_write_read_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    n = 17
    i32 = lambda lo, hi: rng.integers(lo, hi, n).astype(np.int32)
    f = dict(qid=i32(0, 50), sid=i32(0, 50),
             ident=(rng.random(n) * 30 + 70).astype(np.float32), vscore=i32(0, 900),
             qdir=rng.integers(0, 2, n).astype(np.int8), qoff=i32(0, 100),
             qend=i32(1000, 2000), qsize=i32(2000, 3000),
             sdir=np.zeros(n, np.int8), soff=i32(0, 100), send=i32(1000, 2000),
             ssize=i32(2000, 3000))
    for name in ("a.m4", "b.m4.gz"):
        M4Records(**f).save(tmp_path / name)
        JaxM4Records(**f).save(tmp_path / ("j" + name))
        assert (gzip.open if name.endswith(".gz") else open)(tmp_path / name, "rb").read() == \
            (gzip.open if name.endswith(".gz") else open)(tmp_path / ("j" + name), "rb").read()
        t, j = M4Records.load(tmp_path / name), JaxM4Records.load(tmp_path / name)
        for fld in dataclasses.fields(JaxM4Records):
            np.testing.assert_array_equal(getattr(t, fld.name), getattr(j, fld.name))
    assert len(M4Records.empty()) == 0


def test_config_template_parsed_as_jax(tmp_path):
    assert config.CONFIG_TEMPLATE == jconfig.CONFIG_TEMPLATE
    config.write_template(tmp_path / "t.cfg")
    with open(tmp_path / "t.cfg", "a") as f:
        f.write("PROJECT=/x/p\nGENOME_SIZE=4.6m\n# comment\nVOL_SIZE=3\n")
    t, j = config.load_config(tmp_path / "t.cfg"), jconfig.load_config(tmp_path / "t.cfg")
    assert t.raw == j.raw
    for prop in ("project", "read_list", "genome_size", "min_read_length",
                 "prep_output_coverage", "cns_output_coverage", "num_iter", "polish"):
        assert getattr(t, prop) == getattr(j, prop), prop


def test_options_match_jax():
    """Defaults as asdict, the option strings of the config template, and the
    module's presets."""
    assert dataclasses.asdict(options.MapOptions()) == dataclasses.asdict(joptions.MapOptions())
    assert dataclasses.asdict(CnsOptions()) == dataclasses.asdict(JaxCnsOptions())
    cfg = jconfig.CONFIG_TEMPLATE
    for line in cfg.splitlines():
        key, _, val = line.partition("=")
        if key.startswith(("OVLP", "TRIM", "ASM")):
            assert dataclasses.asdict(options.MapOptions.from_string(val)) == \
                dataclasses.asdict(joptions.MapOptions.from_string(val))
        if key.startswith("CNS") and "OPTIONS" in key:
            for r in (" -r 0", " -r 1"):
                assert dataclasses.asdict(CnsOptions.from_string(val + r)) == \
                    dataclasses.asdict(JaxCnsOptions.from_string(val + r))
    for name in ("CORRECTION_MAP_OPTIONS", "ASSEMBLY_MAP_OPTIONS", "REFMAP_OPTIONS"):
        assert dataclasses.asdict(getattr(options, name)) == \
            dataclasses.asdict(getattr(joptions, name))


def test_shapes_match_jax():
    for name in ("LENGTH_TIERS", "EXTENSION_BYTES", "BAND_W_DEFAULT", "MAX_BAND"):
        assert getattr(shapes, name) == getattr(jshapes, name), name
    for x in list(range(1, 300_000, 997)) + list(jshapes.LENGTH_TIERS) + [600_000]:
        assert shapes.length_tier(x) == jshapes.length_tier(x)
    for L in jshapes.LENGTH_TIERS + (3000,):
        assert shapes.tier_below(L) == jshapes.tier_below(L)
        for W in (64, 128, 512, 1024, 2048, 4096):
            assert shapes.pairs_per_chunk(L, W) == jshapes.pairs_per_chunk(L, W)
            assert shapes.pairs_per_chunk(L, W, cap=64) == jshapes.pairs_per_chunk(L, W, cap=64)


def test_simulate_and_benchdata_match_jax():
    g_t, g_j = simulate.random_genome(20000, seed=5), jsimulate.random_genome(20000, seed=5)
    np.testing.assert_array_equal(g_t, g_j)
    em_t, em_j = simulate.ErrorModel(0.04, 0.05, 0.06), jsimulate.ErrorModel(0.04, 0.05, 0.06)
    t = simulate.simulate_reads(g_t, coverage=3, mean_len=4000, min_len=1000, em=em_t, seed=9)
    j = jsimulate.simulate_reads(g_j, coverage=3, mean_len=4000, min_len=1000, em=em_j, seed=9)
    assert len(t[0]) == len(j[0]) > 5
    for x, y in zip(t[0], j[0]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(t[1:], j[1:]):
        np.testing.assert_array_equal(x, y)
    assert simulate.identity_to_genome(t[0][0], g_t, t[1][0], t[2][0], t[3][0]) == \
        jsimulate.identity_to_genome(j[0][0], g_j, j[1][0], j[2][0], j[3][0])
    gt, st, (s1, d1, l1) = benchdata.gen_benchmark_reads(30000, 4.0, seed=7)
    gj, sj, (s2, d2, l2) = jbenchdata.gen_benchmark_reads(30000, 4.0, seed=7)
    np.testing.assert_array_equal(gt, gj)
    _assert_same_store(st, sj)
    for x, y in ((s1, s2), (d1, d2), (l1, l2)):
        np.testing.assert_array_equal(x, y)
