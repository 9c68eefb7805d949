"""Package-level checks of necat_tpu_torch, and the CUDA kernels against
their plain versions.

This file imports neither JAX nor necat_tpu, so that its CUDA tests run on a
machine without them:
    python -m pytest tests/test_torch_package.py --noconftest -m cuda
Tests marked `cuda` skip where torch sees no CUDA device.
"""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import necat_tpu_torch
from necat_tpu_torch.io import simulate
from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = sorted(m.name for m in pkgutil.walk_packages(necat_tpu_torch.__path__,
                                                            "necat_tpu_torch."))


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke as a module (its
    main does not run), loads no jax* and no necat_tpu module."""
    assert len(PORT_MODULES) >= 30 and "necat_tpu_torch.parallel.mesh" in PORT_MODULES
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES + ['chip_smoke']!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'necat_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_references_well_formed():
    """chip_smoke's references of the JAX package's CPU runs that phases 20
    and 21 hold the port to: hex sha256 digests with record counts, one per
    stage file that phase 21 compares; every tie they allow has its entry in
    ROADMAP.md's queue 3."""
    import re
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    def sha(x):
        return isinstance(x, str) and re.fullmatch("[0-9a-f]{64}", x) is not None

    files = cs.JAX_CPU_PIPELINE_REFERENCE["files"]
    assert set(files) == set(cs.pipeline_paths("prj", "polished.fasta"))
    for key, entry in [*files.items(), ("bench_bridged", cs.JAX_CPU_BRIDGE_DIGEST)]:
        tied = key in cs.PIPELINE_TIES
        assert set(entry) == {"sha256", "records"} | ({"sha256_without_ties"} if tied else set())
        assert sha(entry["sha256"]) and (not tied or sha(entry["sha256_without_ties"]))
        assert isinstance(entry["records"], int) and entry["records"] >= 1
    assert all(sha(cs.JAX_CPU_LADDER_REFERENCE[k]) for k in ("m4", "records"))
    assert sha(cs.JAX_CPU_MAIN_REFERENCE["digest"])
    assert sha(cs.JAX_CPU_MAIN_REFERENCE["digest_without_tie_flips"])
    assert set(cs.JAX_CPU_MAIN_REFERENCE["tie_flips"]) == {str(t) for t in cs.MAIN_TIE_FLIPS}
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    queue3 = roadmap[roadmap.index("### Queue 3"):]
    queue3 = queue3[:queue3.find("\n## ") if "\n## " in queue3 else None]
    for tid in cs.MAIN_TIE_FLIPS:
        assert f"template {tid}" in queue3
    for key, ties in cs.PIPELINE_TIES.items():
        assert key in files and ties
        for port, ref in ties.items():
            assert len(port.split()) == len(ref.split()) == 3
            assert f"`{port.split()[0]}`" in queue3 and f"`{ref.split()[0]}`" in queue3


def test_chip_smoke_run_pipeline(tmp_path):
    """chip_smoke.run_pipeline, which phase 21 and both pipeline reference
    scripts drive: assemble then bridge with --device, the assemble
    command's polished contigs kept before bridge overwrites them, a
    cns_final stand-in that correct returns, and a finished project only
    read."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    class Project:
        def run_correct(self, *, device="cuda"):
            raise AssertionError("correct must not run")

    class Cli:
        calls = []

        @classmethod
        def main(cls, argv):
            cls.calls.append(argv)
            cns = Project().run_correct()
            assert open(cns).read() == ">r\nACGT\n"
            (prj / "polished_contigs.fasta").write_text(f">{argv[0]}\nACGT\n")
            if argv[0] == "bridge":
                done = prj / cs.STAGE_DIRS["bridge"] / "bridge.done.json"
                done.parent.mkdir()
                done.write_text('{"wall_s": 1.5}')
            return 0

    Cli.Project = Project
    prj = tmp_path / "project"
    prj.mkdir()
    other = tmp_path / "other_cns.fasta"
    other.write_text(">r\nACGT\n")
    after = str(tmp_path / "after.fasta")
    paths, walls, stages = cs.run_pipeline(Cli, "run.cfg", str(prj), after, device="cpu",
                                           cns_final=str(other))
    assert Cli.calls == [["assemble", "run.cfg", "--device", "cpu"],
                         ["bridge", "run.cfg", "--device", "cpu"]]
    assert set(walls) == set(stages) == {"assemble", "bridge"}
    assert stages["bridge"] == {"bridge": 1.5}
    assert open(paths["polished_assemble"]).read() == ">assemble\nACGT\n"
    assert open(paths["polished_bridge"]).read() == ">bridge\nACGT\n"
    assert open(paths["cns_final"]).read() == ">r\nACGT\n"
    assert cs.run_pipeline(Cli, "run.cfg", str(prj), after)[1:] == ({}, {})
    assert len(Cli.calls) == 2


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.overlap.candidates import Candidates
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    store = ReadStore.from_seqs([np.zeros(100, np.uint8)] * 4)
    with pytest.raises(RuntimeError):
        correct_reads(store, Candidates.concat([]), device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _pairs(seed, PB, L, W):
    rng = np.random.default_rng(seed)
    em = simulate.ErrorModel(sub=0.05, ins=0.06, dele=0.05)
    a = np.zeros((PB, L), np.uint8)
    b = np.zeros((PB, L), np.uint8)
    la = np.zeros(PB, np.int32)
    lb = np.zeros(PB, np.int32)
    for i in range(PB):
        t = rng.integers(0, 4, int(rng.integers(L // 2, L - 16))).astype(np.uint8)
        q = simulate.mutate(t, em, rng)[:L]
        a[i, :len(q)], b[i, :len(t)] = q, t
        la[i], lb[i] = min(len(q), len(t) + W // 4), min(len(t), len(q) + W // 4)
    return [torch.from_numpy(x) for x in (a, b, la, lb)]


def _check_kernels(cpu, dev, W, words, max_cols=None):
    """K2, the fused K1 and K3 on the card equal their plain versions on the
    CPU, byte for byte; returns the plain cols."""
    from necat_tpu_torch.align import banded_kernels as bk
    MC = cpu[1].shape[1] if max_cols is None else max_cols
    before = dict(bk.launches_by_width)
    assert torch.equal(bk.diag_sub_matrix(*dev, W, MC).cpu(),
                       bk.diag_sub_matrix(*cpu, W, MC))
    dirs_c, cost_c = bk.banded_forward(*cpu, W, max_cols)
    dirs_d, cost_d = bk.banded_forward(*dev, W, max_cols)
    assert torch.equal(dirs_d.cpu(), dirs_c) and torch.equal(cost_d.cpu(), cost_c)
    out_c = bk.banded_backtrack_cols(dirs_c, cpu[2], cpu[3], W, words)
    out_d = bk.banded_backtrack_cols(dirs_d, dev[2], dev[3], W, words)
    torch.cuda.synchronize()
    assert torch.equal(out_d[0].cpu(), out_c[0])
    assert all(torch.equal(x.cpu(), y) for x, y in zip(out_d[1], out_c[1], strict=True))
    assert torch.equal(out_d[2].cpu(), out_c[2])
    for name in ("diag_sub_matrix", "banded_forward", "banded_backtrack_cols"):
        assert bk.launches_by_width[(name, W)] == before.get((name, W), 0) + 1
    return out_c[0]


@pytest.mark.cuda
@pytest.mark.parametrize("W,words", [(64, 1), (128, 1), (128, 3), (256, 2), (256, 3),
                                     (512, 2), (1024, 1), (1024, 3)])
def test_cuda_kernels_match_plain(cuda_device, W, words):
    PB, L = 37, 1024          # PB not a multiple of the warps per block
    cpu = _pairs(W + words, PB, L, W)
    _check_kernels(cpu, [x.to(cuda_device) for x in cpu], W, words)


@pytest.mark.cuda
@pytest.mark.parametrize("W,words", [(2048, 1), (2048, 2), (4096, 1), (4096, 3)])
def test_cuda_wide_kernels_match_plain(cuda_device, W, words):
    """The rescue ladder's widths, a block per pair in K1 and K3."""
    PB, L = 5, 3000
    cpu = _pairs(W + words, PB, L, W)
    cpu[2][1] = cpu[3][1] // 2 + 1                 # a query far shorter than its target
    cols = _check_kernels(cpu, [x.to(cuda_device) for x in cpu], W, words)
    assert (cols >> 5).max() > 0                   # insertion runs were exercised


@pytest.mark.cuda
@pytest.mark.parametrize("W", [64, 128, 256, 512, 1024, 2048, 4096])
def test_cuda_forward_reads_rows_as_k2(cuda_device, W):
    """The fused K1 reads the rows as K2 does: bases past la and lb are read
    as they are (not as padding), target columns past b's width as
    PAD_TARGET (max_cols > Lb), query indices outside the row as PAD_BASE."""
    PB, L = 9, 1500
    a, b, la, lb = _pairs(W + 7, PB, L, W)
    rng = np.random.default_rng(W)
    for i in range(PB):                            # junk past la and lb
        a[i, int(la[i]):] = torch.from_numpy(rng.integers(0, 4, L - int(la[i])).astype(np.uint8))
        b[i, int(lb[i]):] = torch.from_numpy(rng.integers(0, 4, L - int(lb[i])).astype(np.uint8))
    b = b[:, :L - 200].contiguous()
    lb = torch.minimum(lb, torch.tensor(L - 100, dtype=torch.int32))
    cpu = [a, b, la, lb]
    _check_kernels(cpu, [x.to(cuda_device) for x in cpu], W, 2, max_cols=L)


def _diag_pairs(seed, PB, L, Lb, W):
    """K2 inputs: random bytes (bases and a few other values), rows of L and
    Lb bytes (not multiples of 4, so rows start unaligned), lengths with
    |la - lb| <= W/4 and mostly odd differences: some pairs pad the query on
    the left (la < lb), some on the right (la near L)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 6, (PB, L)).astype(np.uint8)
    b = rng.integers(0, 6, (PB, Lb)).astype(np.uint8)
    la = rng.integers(0, L + 1, PB)
    la[: PB // 3] = rng.integers(L - 8, L + 1, PB // 3)
    lb = np.clip(la + 2 * rng.integers(-(W // 8), W // 8 + 1, PB) + 1, 0, Lb)
    return [torch.from_numpy(x) for x in (a, b, la.astype(np.int32), lb.astype(np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("W", [64, 128, 256, 512, 1024, 2048, 4096, 100, 4100])
def test_cuda_diag_sub_matrix_matches_plain(cuda_device, W):
    """K2 at every width of KERNEL_WIDTHS, and at W = 100 and 4100 (the
    run-time-W kernel; 4100 lanes take two lane tiles) equals its plain
    version byte for byte: 37 pairs, MC two column tiles and a few columns
    more (not a multiple of the tile nor of 4), the last 3 columns past b's
    width."""
    from necat_tpu_torch.align import banded_kernels as bk
    MC = 2 * (1 << 17) // W + 6
    cpu = _diag_pairs(W, 37, MC + 5, MC - 3, W)
    before = bk.launches_by_width[("diag_sub_matrix", W)]
    got = bk.diag_sub_matrix(*[x.to(cuda_device) for x in cpu], W, MC)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), bk.diag_sub_matrix_ref(*cpu, W, MC))
    assert bk.launches_by_width[("diag_sub_matrix", W)] == before + 1


@pytest.mark.cuda
def test_cuda_diag_sub_matrix_many_pairs(cuda_device):
    """K2 takes pairs on the grid's x dimension: 65 537 pairs (past 65 535)
    of 16 columns at W = 64 equal the plain version; no pairs gives an empty
    ENC."""
    from necat_tpu_torch.align import banded_kernels as bk
    PB, MC, W = 65_537, 16, 64
    cpu = _diag_pairs(5, PB, 37, 13, W)
    got = bk.diag_sub_matrix(*[x.to(cuda_device) for x in cpu], W, MC)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), bk.diag_sub_matrix_ref(*cpu, W, MC))
    none = bk.diag_sub_matrix(*[x[:0].to(cuda_device) for x in cpu], W, MC)
    assert none.shape == (0, MC, W)


@pytest.mark.cuda
def test_cuda_kernels_refuse_bad_inputs(cuda_device):
    from necat_tpu_torch.align import banded_kernels as bk
    enc = torch.zeros((4, 64, 96), dtype=torch.uint8, device=cuda_device)
    a = torch.zeros((4, 64), dtype=torch.uint8, device=cuda_device)
    la = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        bk.banded_forward(a, a, la, la, 96)                # no kernel for W=96
    with pytest.raises(TypeError):
        bk.banded_forward(a, a, la.long(), la, 64)
    with pytest.raises(ValueError):
        bk.banded_forward(a[:, ::2], a, la, la, 64)        # not contiguous
    with pytest.raises(ValueError):
        bk.banded_backtrack_cols(enc[:, :, :64], la, la, 64)   # not contiguous


@pytest.mark.cuda
def test_cuda_correction_matches_cpu(cuda_device):
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.consensus.options import CnsOptions
    from necat_tpu_torch.overlap.candidates import Candidates
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.overlap.overlapper import find_all_candidates
    genome = simulate.random_genome(12000, seed=33)
    reads, *_ = simulate.simulate_reads(genome, coverage=6, mean_len=4000,
                                        min_len=3000, max_len=5500, seed=34)
    rs = ReadStore.from_seqs(reads)
    mo = MapOptions(kmer_size=13)
    co = CnsOptions(templates_per_batch=4, pairs_per_chunk=32)
    recs = []
    for dev in ("cpu", cuda_device):
        c = find_all_candidates(rs, rs, mo, pairwise=True, device=dev)
        recs.append(correct_reads(rs, Candidates.concat([c, c.swap_roles()]), co,
                                  device=dev))
    assert len(recs[0]) == len(recs[1]) and any(r.corrected for r in recs[0])
    for a, b in zip(*recs):
        assert (a.tid, a.left, a.right, a.corrected) == (b.tid, b.left, b.right,
                                                         b.corrected)
        np.testing.assert_array_equal(a.seq, b.seq)


@pytest.mark.cuda
def test_cuda_index_build_and_device_lists(cuda_device, monkeypatch):
    """On the card: build_on_device equals the host build array for array;
    find_all_candidates builds on the card up to DEVICE_INDEX_MAX_BASES and
    on the host past it, with the same candidates; two shards on one card
    (or one on each of two) give those candidates and the one-device
    records in order."""
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.consensus.options import CnsOptions
    from necat_tpu_torch.index import kmer_index
    from necat_tpu_torch.overlap.candidates import Candidates
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.overlap.overlapper import find_all_candidates
    from necat_tpu_torch.utils import shapes
    genome = simulate.random_genome(12000, seed=33)
    reads, *_ = simulate.simulate_reads(genome, coverage=6, mean_len=4000,
                                        min_len=3000, max_len=5500, seed=34)
    rs = ReadStore.from_seqs(reads)
    dev_idx = kmer_index.KmerIndex.build_on_device(rs, device=cuda_device, k=13)
    host_idx = kmer_index.KmerIndex.build(rs.bases, rs.offsets, device=cuda_device, k=13)
    for f in ("sorted_hashes", "sorted_positions", "bucket_starts", "run_end"):
        assert torch.equal(getattr(dev_idx, f), getattr(host_idx, f)), f
    assert dev_idx.n_search_steps == host_idx.n_search_steps
    mo = MapOptions(kmer_size=13)
    calls = []
    monkeypatch.setattr(kmer_index.KmerIndex, "build_on_device",
                        lambda *a, **kw: calls.append(1) or dev_idx)
    on_card = find_all_candidates(rs, rs, mo, pairwise=True, device=cuda_device)
    monkeypatch.setattr(shapes, "DEVICE_INDEX_MAX_BASES", rs.total_bases - 1)
    on_host = find_all_candidates(rs, rs, mo, pairwise=True, device=cuda_device)
    monkeypatch.undo()
    assert calls == [1]
    n = max(torch.cuda.device_count(), 2)
    devs = [torch.device("cuda", i % torch.cuda.device_count()) for i in range(n)]
    sharded = find_all_candidates(rs, rs, mo, pairwise=True, device=devs)
    for c in (on_host, sharded):
        for f in ("qid", "sid", "qdir", "score", "qbeg", "qend", "sbeg", "send"):
            np.testing.assert_array_equal(getattr(c, f), getattr(on_card, f))
    co = CnsOptions(templates_per_batch=4, pairs_per_chunk=32, buckets_per_supergroup=2)
    call = Candidates.concat([on_card, on_card.swap_roles()])
    one = correct_reads(rs, call, co, device=cuda_device)
    two = correct_reads(rs, call, co, device=devs)
    assert [(r.tid, r.left, r.right, r.corrected, r.seq.tobytes()) for r in one] == \
        [(r.tid, r.left, r.right, r.corrected, r.seq.tobytes()) for r in two]


# ------------------------------------------- adaptive band (K1a, K3a) on the card

def random_walk_inputs(seed, PB=16, MC=96, L=128, W=64):
    """K3a inputs with random dirs bytes (every op, OP_PAD among them, high
    bits set) and nondecreasing offs: walks that leave the band, clip their
    slot, and stop on an OP_PAD before the origin. numpy arrays."""
    rng = np.random.default_rng(seed)
    dirs = rng.integers(0, 256, (PB, MC, W)).astype(np.uint8)
    dirs[rng.random((PB, MC, W)) < 0.97] &= 0xFC         # mostly DIAG, few PAD
    dirs |= (rng.random((PB, MC, W)) < 0.3).astype(np.uint8) * 2   # INS runs
    offs = np.cumsum(rng.integers(0, 3, (PB, MC + 1)), axis=1).astype(np.int32)
    offs[:, 0] = 0
    la = rng.integers(0, L, PB).astype(np.int32)
    lb = rng.integers(0, MC + 1, PB).astype(np.int32)
    la[0], lb[1] = 0, 0
    a = rng.integers(0, 4, (PB, L)).astype(np.uint8)
    b = rng.integers(0, 4, (PB, MC)).astype(np.uint8)
    return dirs, offs, a, b, la, lb


# band_edge_pairs: per width, the G insertion (start p, length g) that moves
# the band's minimum into its last third, the row r of the extra G that puts
# a first-minimum tie at lanes 2W//3 and 2W//3 + 1, and the column of that
# tie (found with the plain version; the tests assert that the ties occur)
EDGE_INSERTIONS = {64: (20, 27, 125, 133), 128: (30, 50, 444, 446),
                   512: (40, 160, 388, 230), 1024: (40, 250, None, None)}


def band_edge_pairs(W, L=512):
    """K1a/K3a inputs for the cases the band decision treats apart (numpy,
    PB 3, 2 at W=1024; query and target bases 0..3, L=512):
    0: target A^n, query A^k C A^(n-k) with k = W//3: at column W//3 + 1 the
       first minimum of S is at lane W//3 and ties with lane W//3 + 1;
    1: target random over {A, C, T}; query = target with G^g inserted at p:
       once the insertion path is the cheaper one the band's minimum jumps g
       lanes into the last third, so the band shifts by 2 for a run of
       columns (and past a warp boundary with a block per pair), and the path
       holds an insertion run of g > 21 bases;
    2: pair 1 with one more G at row r (where the band's minimum sits at lane
       2W//3): a first-minimum tie at lanes 2W//3 and 2W//3 + 1 (not at 1024,
       whose band never moves that far in 512 rows).
    Returns a, b, la, lb and {pair: (column, lane)} of the ties."""
    A, C, G = 0, 1, 2
    p, g, r, j_tie = EDGE_INSERTIONS[W]
    PB = 2 if r is None else 3
    a = np.zeros((PB, L), np.uint8)
    b = np.zeros((PB, L), np.uint8)
    k = W // 3
    n0 = min(L - 1, k + 160)
    a[0, k] = C
    la, lb = [n0 + 1], [n0]
    rng = np.random.default_rng(W)
    n = L - g - 1
    t = rng.choice(np.array([A, C, 3], np.uint8), n)
    q = np.concatenate([t[:p], np.full(g, G, np.uint8), t[p:]])
    a[1, :len(q)], b[1, :n] = q, t
    la.append(len(q))
    lb.append(n)
    ties = {0: (k + 1, k)}
    if r is not None:
        q2 = np.insert(q, r, G)
        a[2, :len(q2)], b[2, :n] = q2, t
        la.append(len(q2))
        lb.append(n)
        ties[2] = (j_tie, (2 * W) // 3)
    return a, b, np.array(la, np.int32), np.array(lb, np.int32), ties


def long_run_walk_inputs(seed, W, PB=8, MC=128, L=256):
    """random_walk_inputs with insertion runs of 15-40 lanes in every column,
    so that runs longer than 3 insb words (21 bases) reach cols, and OP_PAD
    bytes that stop some walks short of the origin. numpy arrays."""
    dirs, offs, a, b, la, lb = random_walk_inputs(seed, PB, MC, L, W)
    rng = np.random.default_rng(seed + 1)
    dirs[(dirs & 3) == 2] &= 0xFC                      # no INS but in the runs
    start = rng.integers(0, min(W, L), (PB, MC, 1))          # where the walk reads
    lanes = np.arange(W)[None, None, :]
    run = (lanes >= start) & (lanes < start + rng.integers(15, 41, (PB, MC, 1)))
    dirs[run & ((dirs & 3) != 3)] = 2 | (dirs[run & ((dirs & 3) != 3)] & 0xFC)
    la = np.maximum(la, L // 2).astype(np.int32)
    lb = np.maximum(lb, MC // 2).astype(np.int32)
    return dirs, offs, a, b, la, lb


def _check_adaptive(cpu, dev, W, words):
    """K1a and K3a on the card equal their plain versions on the CPU, every
    output byte for byte, one launch each; returns the plain cols."""
    from necat_tpu_torch.align import banded_kernels as bk
    before = dict(bk.launches_by_width)
    fwd_c = bk.banded_forward_adaptive(*cpu, W)
    fwd_d = bk.banded_forward_adaptive(*dev, W)
    torch.cuda.synchronize()
    for x, y in zip(fwd_d, fwd_c, strict=True):
        assert torch.equal(x.cpu(), y)
    out_c = bk.adaptive_backtrack_cols(*fwd_c[:2], *cpu, W, words)
    out_d = bk.adaptive_backtrack_cols(*fwd_d[:2], *dev, W, words)
    torch.cuda.synchronize()
    assert torch.equal(out_d[0].cpu(), out_c[0])
    assert all(torch.equal(x.cpu(), y) for x, y in zip(out_d[1], out_c[1], strict=True))
    assert torch.equal(out_d[2].cpu(), out_c[2])
    for name in ("banded_forward_adaptive", "adaptive_backtrack_cols"):
        assert bk.launches_by_width[(name, W)] == before.get((name, W), 0) + 1
    return out_c[0]


@pytest.mark.cuda
@pytest.mark.parametrize("W,words", [(64, 1), (128, 1), (128, 3), (256, 3), (512, 1),
                                     (1024, 3), (2048, 1), (4096, 1)])
def test_cuda_adaptive_kernels_match_plain(cuda_device, W, words):
    """K1a and K3a at every width of KERNEL_WIDTHS (a warp per pair below
    512 in K1a and 1024 in K3a, a block from there), PB 37 (not a multiple
    of the pairs per block); pair 0 with la = 0, pair 1 with a query far
    shorter than its target (its end outside the band)."""
    PB, L = 37, 1024
    cpu = _pairs(W + words + 1, PB, L, W)
    cpu[2][0] = 0
    cpu[2][1] = cpu[3][1] // 2 + 1
    cols = _check_adaptive(cpu, [x.to(cuda_device) for x in cpu], W, words)
    assert (cols >> 5).max() > 0                   # insertion runs were exercised


@pytest.mark.cuda
def test_cuda_adaptive_kernels_no_pairs(cuda_device):
    """PB = 0: empty outputs, no launch."""
    from necat_tpu_torch.align import banded_kernels as bk
    z = torch.zeros((0, 256), dtype=torch.uint8, device=cuda_device)
    n = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    before = dict(bk.launches_by_width)
    dirs, offs, s_fin, cost = bk.banded_forward_adaptive(z, z, n, n, 64)
    assert dirs.shape == (0, 256, 64) and offs.shape == (0, 257) and cost.shape == (0,)
    cols, insb, lead = bk.adaptive_backtrack_cols(dirs, offs, z, z, n, n, 64, 3)
    assert cols.shape == (0, 256) and len(insb) == 3 and lead.shape == (0,)
    assert dict(bk.launches_by_width) == before


@pytest.mark.cuda
@pytest.mark.parametrize("W,words", [(64, 1), (64, 3), (1024, 3)])
def test_cuda_adaptive_backtrack_random_walks(cuda_device, W, words):
    """K3a on random dirs and offs (walks stopped on OP_PAD, slots clipped at
    both band edges) equals its plain version."""
    from necat_tpu_torch.align import banded_kernels as bk
    arrs = [torch.from_numpy(x) for x in random_walk_inputs(W + words, W=W)]
    out_c = bk.adaptive_backtrack_cols(*arrs, W, words)
    out_d = bk.adaptive_backtrack_cols(*[x.to(cuda_device) for x in arrs], W, words)
    torch.cuda.synchronize()
    assert torch.equal(out_d[0].cpu(), out_c[0])
    assert all(torch.equal(x.cpu(), y) for x, y in zip(out_d[1], out_c[1], strict=True))
    assert torch.equal(out_d[2].cpu(), out_c[2])


@pytest.mark.cuda
@pytest.mark.parametrize("W", [64, 128, 512, 1024])
def test_cuda_adaptive_band_edges(cuda_device, W):
    """K1a and K3a (1 and 3 insb words) on band_edge_pairs: first-minimum
    ties at the thirds' boundaries, runs of shifts by 2 (across a warp
    boundary with a block per pair: K1a from 512, K3a from 1024) and
    insertion runs longer than 21 bases; equal to their plain versions."""
    a, b, la, lb, _ = band_edge_pairs(W)
    cpu = [torch.from_numpy(x) for x in (a, b, la, lb)]
    for words in (1, 3):
        cols = _check_adaptive(cpu, [x.to(cuda_device) for x in cpu], W, words)
        assert (cols >> 5).max() > 3 * 7                 # a run past 3 insb words


@pytest.mark.cuda
@pytest.mark.parametrize("W", [64, 1024])
def test_cuda_adaptive_backtrack_long_runs(cuda_device, W):
    """K3a on long_run_walk_inputs (runs past 7 * words bases, walks stopped
    on OP_PAD, so the second walk) equals its plain version at 1 and 3 insb
    words."""
    from necat_tpu_torch.align import banded_kernels as bk
    arrs = [torch.from_numpy(x) for x in long_run_walk_inputs(W, W)]
    for words in (1, 3):
        out_c = bk.adaptive_backtrack_cols(*arrs, W, words)
        out_d = bk.adaptive_backtrack_cols(*[x.to(cuda_device) for x in arrs], W, words)
        torch.cuda.synchronize()
        assert torch.equal(out_d[0].cpu(), out_c[0])
        assert all(torch.equal(x.cpu(), y) for x, y in zip(out_d[1], out_c[1], strict=True))
        assert torch.equal(out_d[2].cpu(), out_c[2])
