"""The tag scatter's CUDA kernel (csrc/tag_scatter.cu, run by
consensus/tags.py:scatter_chunk on CUDA tensors) against the plain
scatter_chunk on the CPU: weights and coverage bitwise equal, no host sync,
bad inputs refused; CPU tensors never load the kernel library.

This file imports neither JAX nor necat_tpu, so that its CUDA tests run on a
machine without them:
    python -m pytest tests/test_torch_tag_scatter_kernel.py --noconftest -m cuda
Tests marked `cuda` skip where torch sees no CUDA device.
"""

import numpy as np
import pytest
import torch

from necat_tpu_torch.align import banded
from necat_tpu_torch.align.banded_kernels import N_INSB, OP_PAD
from necat_tpu_torch.consensus import tags
from necat_tpu_torch.io import simulate

SIDES = ("left", "right")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _synthetic_chunk(seed, P, MC, TB, Lt, words):
    """Per-column buffers of both passes and the per-pair vectors, drawn so
    that every mask of _scatter_pass fires: dropped pairs (row TB and -1), t
    below 0, at or above tsize and at or above Lt (tsize past Lt on some
    pairs), jc of 0 and past MC, leading runs, OP_PAD runs and interior PAD
    columns, every op, and insertion runs k longer than the planes."""
    rng = np.random.default_rng(seed)
    i32 = lambda x: torch.from_numpy(np.asarray(x, dtype=np.int32))
    chunk = {}
    for side in SIDES:
        op = rng.integers(0, 4, (P, MC))
        k = np.where(rng.random((P, MC)) < 0.3, rng.integers(1, 3 * N_INSB + 6, (P, MC)), 0)
        cols = op | rng.integers(0, 2, (P, MC)) << 2 | rng.integers(0, 4, (P, MC)) << 3 | k << 5
        stop = rng.integers(MC // 2, MC + 1, P)           # an OP_PAD run to the end
        cols = np.where(np.arange(MC)[None, :] >= stop[:, None], OP_PAD, cols)
        chunk[f"{side}_cols"] = i32(cols)
        chunk[f"{side}_insb"] = tuple(i32(rng.integers(0, 1 << 31, (P, MC)))
                                      for _ in range(words))
        chunk[f"{side}_lead"] = i32(np.where(rng.random(P) < 0.5,
                                             rng.integers(1, 3 * N_INSB + 4, P), 0))
        chunk[f"{side}_leadb"] = torch.from_numpy(
            rng.integers(0, 4, (P, N_INSB * words)).astype(np.uint8))
        jc = rng.integers(0, MC + 1, P)
        jc[:4] = (0, MC + 7, MC, 1)
        chunk[f"{side}_jc"] = i32(jc)
    row = rng.integers(0, TB, P)
    row[rng.random(P) < 0.25] = TB
    row[rng.random(P) < 0.1] = -1
    at = rng.integers(-20, Lt + 20, P)
    tsize = np.minimum(rng.integers(0, Lt + 1, P), np.maximum(at + rng.integers(-30, 300, P), 0))
    past = rng.random(P) < 0.2                             # tsize past Lt; the lead's t stays below
    tsize[past] = Lt + 50
    at[past] = np.minimum(at[past], Lt)
    chunk.update(at=i32(at), pair_row=i32(row), tsize=i32(tsize),
                 pair_w=torch.from_numpy((rng.random(P) * 0.67 + 0.33).astype(np.float32)))
    return chunk


def _extension_pairs(seed, P, L):
    """Extension pairs as the correction makes them: a noisy query of each
    target with a planted insertion of 8-24 bases on either side of the
    anchor of every other pair (runs past one insb word), junk on one end."""
    rng = np.random.default_rng(seed)
    em = simulate.ErrorModel(sub=0.05, ins=0.05, dele=0.05)
    q = np.zeros((P, L), np.uint8)
    t = np.zeros((P, L), np.uint8)
    ql, tl, aq, at = (np.zeros(P, np.int32) for _ in range(4))
    for i in range(P):
        tt = rng.integers(0, 4, int(rng.integers(L // 2, L - 300))).astype(np.uint8)
        qq = simulate.mutate(tt, em, rng)
        mid = len(qq) // 2
        if i % 2:
            at_ins = mid + int(rng.integers(-200, 200))
            qq = np.concatenate([qq[:at_ins], rng.integers(0, 4, int(rng.integers(8, 25))
                                                           ).astype(np.uint8), qq[at_ins:]])
        junk = rng.integers(0, 4, int(rng.integers(0, 100))).astype(np.uint8)
        qq = np.concatenate([junk, qq] if i % 3 == 0 else [qq, junk])[:L]
        q[i, :len(qq)], t[i, :len(tt)] = qq, tt
        ql[i], tl[i] = len(qq), len(tt)
        at[i] = len(tt) // 2
        aq[i] = at[i] + (len(junk) if i % 3 == 0 else 0)
    return [torch.from_numpy(x) for x in (q, ql, t, tl, aq, at)]


def _extension_chunk(dev, seed, P, L, W, TB, Lt, words):
    """One chunk of extend_batch's buffers (extended on `dev`) with the
    per-pair vectors of a correction chunk: rows with dropped pairs, window
    anchors, template sizes up to Lt."""
    q, ql, t, tl, aq, at = _extension_pairs(seed, P, L)
    ext = banded.extend_batch(*[x.to(dev) for x in (q, ql, t, tl, aq, at)], W=W,
                              insb_words=words)
    rng = np.random.default_rng(seed + 1)
    chunk = {}
    for side in SIDES:
        for key in ("cols", "lead", "leadb", "jc"):
            chunk[f"{side}_{key}"] = ext[f"{side}_{key}"].cpu()
        chunk[f"{side}_insb"] = tuple(
            ext[f"{side}_insb{'' if w == 1 else w}"].cpu() for w in range(1, words + 1))
    row = rng.integers(0, TB, P).astype(np.int32)
    row[rng.random(P) < 0.3] = TB
    row[0] = -1
    shift = rng.integers(0, 200, P)
    tsize = np.minimum(tl.numpy() + shift + rng.integers(0, 100, P), Lt)
    chunk.update(at=(at + torch.from_numpy(shift)).to(torch.int32), pair_row=torch.from_numpy(row),
                 tsize=torch.from_numpy(tsize.astype(np.int32)),
                 pair_w=torch.from_numpy((rng.random(P) * 0.5 + 0.5).astype(np.float32)))
    return chunk


def _args(chunk, conv=lambda x: x):
    out = []
    for side in SIDES:
        out += [conv(chunk[f"{side}_cols"]), tuple(conv(x) for x in chunk[f"{side}_insb"]),
                *(conv(chunk[f"{side}_{k}"]) for k in ("lead", "leadb", "jc"))]
    return out + [conv(chunk[k]) for k in ("at", "pair_row", "pair_w", "tsize")]


def _scatter_both(chunks, dev, TB, D, Lt):
    """The chunks scattered one after the other into fresh float64 weights
    and int32 coverage, on the CPU (the plain version) and on `dev` (the
    kernel); returns both (weights, coverage) on the CPU."""
    out = []
    for where in ("cpu", dev):
        w = torch.zeros((TB + 1, D, 5, Lt), dtype=torch.float64, device=where)
        c = torch.zeros((TB + 1, Lt), dtype=torch.int32, device=where)
        for ch in chunks:
            tags.scatter_chunk(w, c, *_args(ch, lambda x: x.to(where)))
        out.append((w.cpu(), c.cpu()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("D,words", [(8, 1), (8, 2), (12, 2), (22, 3), (16, 3)])
def test_kernel_equals_plain_on_synthetic_chunks(cuda_device, D, words):
    """Two synthetic chunks accumulated into the same tensors: weights and
    coverage bitwise equal to the plain version's, tags landed in every
    insertion plane the words reach."""
    TB, Lt, P, MC = 5, 400, 96, 300
    chunks = [_synthetic_chunk(100 * D + words + s, P, MC, TB, Lt, words) for s in (0, 1)]
    (w_c, c_c), (w_d, c_d) = _scatter_both(chunks, cuda_device, TB, D, Lt)
    assert torch.equal(c_d, c_c)
    assert torch.equal(w_d, w_c)
    nd = min(D - 1, N_INSB * words)
    assert c_c[:TB].sum() > 0 and (w_c[:TB, 1:nd + 1].sum(dim=(0, 2, 3)) > 0).all()
    assert w_c[TB].abs().sum() == 0 and c_c[TB].sum() == 0    # dropped pairs add nothing


@pytest.mark.cuda
@pytest.mark.parametrize("W,D,words", [(128, 8, 1), (128, 15, 2), (128, 22, 3),
                                       (512, 8, 1), (512, 22, 3)])
def test_kernel_equals_plain_on_extension_chunks(cuda_device, W, D, words):
    """extend_batch's buffers of real extensions at W = 128 and 512, D = 8
    with one insb word and wide D with two and three: bitwise equal."""
    TB, L, P = 6, 2048, 48
    Lt = L + 400
    chunks = [_extension_chunk(cuda_device, 7 * W + D + s, P, L, W, TB, Lt, words)
              for s in (0, 1)]
    (w_c, c_c), (w_d, c_d) = _scatter_both(chunks, cuda_device, TB, D, Lt)
    assert torch.equal(c_d, c_c)
    assert torch.equal(w_d, w_c)
    assert c_c[:TB].sum() > 0 and w_c[:TB, 1:].sum() > 0
    if words > 1:
        assert w_c[:TB, N_INSB + 1:].sum() > 0      # runs reached the second word


@pytest.mark.cuda
def test_kernel_makes_no_host_sync(cuda_device):
    """With the sync debug mode set to "error", scatter_chunk on the card
    runs (it makes no host sync), while the plain version's listings on the
    same tensors raise."""
    TB, D, Lt = 5, 8, 400
    chunk = _synthetic_chunk(3, 64, 300, TB, Lt, 1)
    args = _args(chunk, lambda x: x.to(cuda_device))
    w = torch.zeros((TB + 1, D, 5, Lt), dtype=torch.float64, device=cuda_device)
    c = torch.zeros((TB + 1, Lt), dtype=torch.int32, device=cuda_device)
    tags.scatter_chunk(w, c, *args)              # loads the library outside the check
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        tags.scatter_chunk(w, c, *args)
        with pytest.raises(RuntimeError):
            tags._scatter_pass(w, c, *args[:5], *args[10:], reversed_part=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    (w_c, c_c), _ = _scatter_both([chunk, chunk], "cpu", TB, D, Lt)
    assert torch.equal(w.cpu(), w_c) and torch.equal(c.cpu(), c_c)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    """float32 weights, a tensor on the CPU among CUDA ones, a non-contiguous
    per-pair vector and four insb words raise, on the card, before any
    launch."""
    TB, D, Lt = 3, 8, 200
    chunk = _synthetic_chunk(5, 16, 100, TB, Lt, 1)
    args = _args(chunk, lambda x: x.to(cuda_device))
    w = torch.zeros((TB + 1, D, 5, Lt), dtype=torch.float64, device=cuda_device)
    c = torch.zeros((TB + 1, Lt), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        tags.scatter_chunk(w.float(), c, *args)
    with pytest.raises(TypeError):
        tags.scatter_chunk(w, c.long(), *args)
    with pytest.raises(ValueError):
        tags.scatter_chunk(w, c, *args[:-1], chunk["tsize"])
    strided = torch.stack([args[-1], args[-1]], dim=1)[:, 0]
    with pytest.raises(ValueError):
        tags.scatter_chunk(w, c, *args[:-1], strided)
    with pytest.raises(ValueError):
        tags.scatter_chunk(w, c, args[0], args[1] * 4, *args[2:])
    torch.cuda.synchronize()
    assert w.abs().sum() == 0 and c.sum() == 0


@pytest.mark.cuda
def test_card_scatter_counts_kernel_chunks(cuda_device, monkeypatch):
    """correct_reads on the card with timing on: cns.scatter_sync is never
    entered, cns.scatter_kernel_chunks equals cns.tag_scatter's calls, and
    every call ran on the card with two launches of the kernel."""
    from necat_tpu_torch.consensus.correct import correct_reads
    from necat_tpu_torch.consensus.options import CnsOptions
    from necat_tpu_torch.io.readstore import ReadStore
    from necat_tpu_torch.overlap.candidates import Candidates
    from necat_tpu_torch.overlap.options import MapOptions
    from necat_tpu_torch.overlap.overlapper import find_all_candidates
    from necat_tpu_torch.utils import logging as tlogging
    genome = simulate.random_genome(12000, seed=33)
    reads, *_ = simulate.simulate_reads(genome, coverage=6, mean_len=4000, min_len=3000,
                                        max_len=5500, seed=34)
    rs = ReadStore.from_seqs(reads)
    monkeypatch.setattr(tlogging, "TIMING_ON", True)
    tlogging.reset_timers()
    tags.reset_launches()
    try:
        c = find_all_candidates(rs, rs, MapOptions(kmer_size=13, max_hits=1 << 18,
                                                   max_pairs=4096),
                                pairwise=True, device="cuda")
        recs = correct_reads(rs, Candidates.concat([c, c.swap_roles()]),
                             CnsOptions(templates_per_batch=4, pairs_per_chunk=32),
                             device="cuda")
        rep = tlogging.timing_report()
    finally:
        tlogging.reset_timers()
    assert sum(r.corrected for r in recs) >= 10
    assert "cns.scatter_sync" not in rep
    assert rep["cns.tag_scatter"][1] > 0
    assert rep["cns.scatter_kernel_chunks"] == (rep["cns.tag_scatter"][1], 0)
    assert tags.chunks_by_device == {"cuda": rep["cns.tag_scatter"][1]}
    assert tags.launches_by_shape == {(8, 1): 2 * rep["cns.tag_scatter"][1]}


def test_cpu_scatter_never_loads_the_kernels(monkeypatch):
    """CPU tensors run the plain version: the kernel library is not loaded
    (load_kernels raises here), the counter adds 0, and the call is counted
    on the CPU with no launch."""
    from necat_tpu_torch.utils import build, logging as tlogging

    def refuse():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(build, "load_kernels", refuse)
    monkeypatch.setattr(tlogging, "TIMING_ON", True)
    tlogging.reset_timers()
    tags.reset_launches()
    TB, D, Lt = 5, 12, 400
    try:
        (w, c), _ = _scatter_both([_synthetic_chunk(9, 64, 300, TB, Lt, 2)], "cpu", TB, D, Lt)
        rep = tlogging.timing_report()
    finally:
        tlogging.reset_timers()
    assert c[:TB].sum() > 0 and w[:TB, N_INSB + 1:].sum() > 0
    assert rep["cns.scatter_kernel_chunks"] == (0, 0)
    assert rep["cns.scatter_sync"][1] == 2 * 8
    assert tags.chunks_by_device == {"cpu": 2} and not tags.launches_by_shape
