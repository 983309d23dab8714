"""The torch port's counter-keyed sampler against the JAX package.

Greedy tokens and every reported logprob equal JAX's `sample_tokens_keyed`
on the same logits; the candidate window's top-k/top-p mask equals JAX's;
a row's draw depends on its key and logits only (not on the batch shape);
and sampled frequencies pass a chi-square test against the masked
distribution.  Sampled tokens are not compared with JAX: the noise bits
differ by design (threefry keys against the port's integer hash).
"""

import numpy as np
import pytest
import torch
from scipy import stats

from areal_tpu_torch.gen import sampling as ps

# logprobs: one f32 logsumexp over <= 300 logits on each side -> 1e-5
ATOL = 1e-5


def _logits(S, V, seed=0):
    return np.random.default_rng(seed).standard_normal((S, V)).astype(np.float32) * 3


def _jax_sample(logits, temperature, top_k, top_p, seed=0):
    import jax
    import jax.numpy as jnp

    from areal_tpu.gen.sampling import sample_tokens_keyed

    keys = jax.random.split(jax.random.PRNGKey(seed), logits.shape[0])
    tok, logp = sample_tokens_keyed(jnp.asarray(logits), keys, jnp.asarray(temperature),
                                    jnp.asarray(top_k), jnp.asarray(top_p))
    return np.asarray(tok), np.asarray(logp)


def _port_sample(logits, temperature, top_k, top_p, streams=None, positions=None):
    S = logits.shape[0]
    root = ps.root_key(0)
    keys = ps.stream_keys(root, torch.as_tensor(np.arange(1, S + 1) if streams is None else streams),
                          torch.as_tensor(np.zeros(S, np.int64) if positions is None else positions))
    tok, logp = ps.sample_tokens_keyed(torch.from_numpy(logits), keys,
                                       torch.from_numpy(temperature), torch.from_numpy(top_k),
                                       torch.from_numpy(top_p))
    return tok.numpy(), logp.numpy()


@pytest.mark.parametrize("V", [97, 300])
def test_greedy_tokens_and_logprobs_match_jax(V):
    S = 8
    logits = _logits(S, V, seed=V)
    temperature = np.zeros(S, np.float32)
    top_k = np.array([0, 5, 0, 1, 0, 64, 3, 0], np.int32)
    top_p = np.array([1.0, 1.0, 0.5, 1.0, 0.9, 1.0, 0.2, 0.0], np.float32)
    jt, jl = _jax_sample(logits, temperature, top_k, top_p)
    tt, tl = _port_sample(logits, temperature, top_k, top_p)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)


def test_logprob_of_any_token_matches_jax():
    """The reported logprob is under the temperature-scaled, unmasked
    distribution: equal to JAX's for the same token."""
    import jax.numpy as jnp

    from areal_tpu.gen.sampling import _masked_window, _token_logprob

    S, V = 6, 97
    logits = _logits(S, V, seed=5)
    temperature = np.array([0.0, 0.5, 1.0, 1.7, 1.0, 0.3], np.float32)
    tokens = np.random.default_rng(2).integers(0, V, S)
    jscaled = _masked_window(jnp.asarray(logits), jnp.asarray(temperature),
                             jnp.zeros(S, jnp.int32), jnp.ones(S))[0]
    want = _token_logprob(jscaled, jnp.asarray(tokens))
    tscaled = ps._masked_window(torch.from_numpy(logits), torch.from_numpy(temperature),
                                torch.zeros(S, dtype=torch.int32), torch.ones(S))[0]
    got = ps.token_logprob(tscaled, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_topk_topp_window_matches_jax():
    import jax.numpy as jnp

    from areal_tpu.gen.sampling import NEG_INF, _masked_window

    S, V = 8, 300
    logits = _logits(S, V, seed=9)
    temperature = np.array([1.0, 0.7, 1.3, 1.0, 1.0, 2.0, 0.5, 1.0], np.float32)
    top_k = np.array([0, 5, 10, 64, 1, 0, 20, 3], np.int32)
    top_p = np.array([0.9, 1.0, 0.8, 0.5, 1.0, 0.95, 0.0, 0.7], np.float32)
    _, jm, jidx, _ = _masked_window(jnp.asarray(logits), jnp.asarray(temperature),
                                    jnp.asarray(top_k), jnp.asarray(top_p))
    _, tm, tidx, _ = ps._masked_window(torch.from_numpy(logits), torch.from_numpy(temperature),
                                       torch.from_numpy(top_k), torch.from_numpy(top_p))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tm.numpy() > NEG_INF / 2, np.asarray(jm) > NEG_INF / 2)
    keep = tm.numpy() > NEG_INF / 2
    np.testing.assert_allclose(tm.numpy()[keep], np.asarray(jm)[keep], atol=1e-6)


def test_draw_does_not_depend_on_batch_shape():
    S, V = 8, 97
    logits = _logits(S, V, seed=4)
    temperature = np.ones(S, np.float32)
    top_k = np.array([0, 0, 5, 0, 10, 0, 0, 3], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.7, 1.0, 1.0, 0.5, 1.0], np.float32)
    streams = np.arange(10, 10 + S)
    positions = np.arange(S) * 7
    full, full_lp = _port_sample(logits, temperature, top_k, top_p, streams, positions)
    order = np.random.default_rng(0).permutation(S)
    perm, perm_lp = _port_sample(logits[order], temperature[order], top_k[order],
                                 top_p[order], streams[order], positions[order])
    np.testing.assert_array_equal(perm, full[order])
    np.testing.assert_array_equal(perm_lp, full_lp[order])
    for i in range(S):
        one, _ = _port_sample(logits[i:i + 1], temperature[i:i + 1], top_k[i:i + 1],
                              top_p[i:i + 1], streams[i:i + 1], positions[i:i + 1])
        assert one[0] == full[i]
    # a different position of the same stream is a fresh draw
    other, _ = _port_sample(logits, temperature, top_k, top_p, streams, positions + 1)
    assert (other != full).any()


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.8), (10, 0.9)])
def test_frequencies_match_masked_distribution(top_k, top_p):
    """N draws of one row (keys over N positions) against the top-k/top-p
    masked distribution (the full softmax when unrestricted); chi-square
    p-value above 1e-3 (deterministic keys: the test cannot flake)."""
    V, N = 24, 20000
    row = np.random.default_rng(7).standard_normal(V).astype(np.float32)
    logits = np.repeat(row[None], N, axis=0)
    ones = np.ones(N, np.float32)
    tokens, _ = _port_sample(logits, ones, np.full(N, top_k, np.int32),
                             np.full(N, top_p, np.float32), np.full(N, 3), np.arange(N))
    p = np.exp(row.astype(np.float64) - row.max())
    p /= p.sum()
    order = np.argsort(-row)
    keep = np.zeros(V, bool)
    ranks = np.arange(V)
    cum = np.cumsum(p[order])
    kept = ((ranks < (top_k if top_k > 0 else V)) & ((cum - p[order]) < top_p)) | (ranks == 0)
    keep[order[kept]] = True
    q = np.where(keep, p, 0.0)
    q /= q.sum()
    counts = np.bincount(tokens, minlength=V)
    assert counts[~keep].sum() == 0
    res = stats.chisquare(counts[keep], q[keep] * N)
    assert res.pvalue > 1e-3, (counts[keep], q[keep] * N)
