"""The chain DP's floor(log2 dd) (necat_tpu_torch/overlap/chain.py
floor_log2): integer ops, exact at, just below and just above every power
of two up to 2^30; the port's chain_pairs equal to the JAX package's on
chains whose last link spans such a dd, as far as a score shows it; and the
card equal to the CPU path on the same dd and chains."""

import numpy as np
import pytest
import torch

from necat_tpu_torch.overlap.chain import chain_pairs, floor_log2

DD = sorted({d for k in range(1, 31) for d in (2**k - 1, 2**k, 2**k + 1)})
K, STEP, SEEDS = 15, 20, 256


def _exact(dd):
    return [d.bit_length() - 1 for d in dd]


def _crossing_links(dds):
    """One pair per dd: SEEDS // 2 seeds on a diagonal STEP apart, then
    SEEDS // 2 more on the diagonal dd further along the subject. Each
    diagonal link scores K; the chain across the shift, whose link scores K
    - trunc(0.01 K dd) - floor(log2 dd) / 2, beats the second half alone
    while dd < ~50 SEEDS, so the chain's score shows floor(log2 dd)."""
    P, h = len(dds), SEEDS // 2
    q = np.tile(np.arange(SEEDS, dtype=np.int32) * STEP, (P, 1))
    s = q.copy()
    s[:, h:] += np.asarray(dds, np.int32)[:, None]
    return q, s, np.ones((P, SEEDS), bool)


# dd that the chain scores show with SEEDS seeds
SHOWN = [d for d in DD if d <= 2**13 + 1]


def test_floor_log2_exact_on_cpu():
    x = torch.tensor(DD, dtype=torch.int32)
    assert floor_log2(x).tolist() == _exact(DD)
    assert floor_log2(torch.ones(3, dtype=torch.int32)).tolist() == [0, 0, 0]


def test_chain_scores_match_jax_at_powers_of_two():
    import jax.numpy as jnp

    from necat_tpu.overlap.chain import chain_pairs as jchain_pairs
    q, s, m = _crossing_links(SHOWN)
    kw = dict(max_dist=1 << 20, bw=1 << 20)
    port = chain_pairs(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(m), K, **kw)
    ref = jchain_pairs(jnp.asarray(q), jnp.asarray(s), jnp.asarray(m), K, **kw)
    for k, v in port.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)
    # the chain crosses the shift: the diagonal's score less the link's
    # penalties, with the exact floor(log2)
    want = [K * SEEDS - int(np.float32(d) * np.float32(0.01 * K)) - ((d.bit_length() - 1) >> 1)
            for d in SHOWN]
    assert port["score"].tolist() == want
    assert port["n_seeds"].tolist() == [SEEDS] * len(SHOWN)


@pytest.mark.cuda
def test_card_floor_log2_and_chains_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    x = torch.tensor(DD, dtype=torch.int32)
    assert floor_log2(x.cuda()).cpu().tolist() == floor_log2(x).tolist() == _exact(DD)
    q, s, m = _crossing_links(SHOWN)
    args = [torch.from_numpy(a) for a in (q, s, m)]
    cpu = chain_pairs(*args, K, max_dist=1 << 20, bw=1 << 20)
    card = chain_pairs(*[a.cuda() for a in args], K, max_dist=1 << 20, bw=1 << 20)
    for k, v in cpu.items():
        assert torch.equal(card[k].cpu(), v), k
