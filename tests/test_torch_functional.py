"""The torch port's loss and advantage ops (`areal_tpu_torch/ops/functional.py`,
`areal_tpu_torch/ops/gae.py`) against `areal_tpu/ops/functional.py` and
`areal_tpu/ops/gae.py`: values, stats and gradients (against `jax.grad`)
of the decoupled-PPO actor loss and the packed GRPO loss, GAE with holes in
the loss mask, masked whitening and the KL estimators, in f32 on the CPU
from the same numpy inputs."""

import numpy as np
import pytest
import torch

from areal_tpu_torch.ops import functional as F
from areal_tpu_torch.ops.gae import gae_padded

# f32 elementwise math and masked sums over <= 400 elements in another
# order -> 1e-5 absolute on losses and stats, 1e-5 relative on gradients.
ATOL = 1e-5


def _ppo_inputs(seed, T=64):
    rng = np.random.default_rng(seed)
    logp = rng.normal(-1.0, 0.3, T).astype(np.float32)
    old = (logp + rng.normal(0, 0.3, T)).astype(np.float32)
    prox = (logp + rng.normal(0, 0.2, T)).astype(np.float32)
    adv = rng.standard_normal(T).astype(np.float32)
    mask = (rng.random(T) > 0.2).astype(np.float32)
    return logp, old, prox, adv, mask


@pytest.mark.parametrize("kw", [
    dict(),
    dict(decoupled=True),
    dict(decoupled=True, c_clip=3.0, behav_imp_weight_cap=1.3),
    dict(decoupled=True, eps_clip_higher=0.28),
], ids=["plain", "decoupled", "dual-clip-cap", "clip-higher"])
def test_ppo_actor_loss_matches_jax(kw):
    import jax
    import jax.numpy as jnp

    from areal_tpu.ops.functional import ppo_actor_loss_fn as jax_loss

    logp, old, prox, adv, mask = _ppo_inputs(1)
    kw = dict(kw)
    decoupled = kw.pop("decoupled", False)

    def jf(lp):
        return jax_loss(lp, jnp.asarray(old), jnp.asarray(adv), 0.2, jnp.asarray(mask),
                        proximal_logprobs=jnp.asarray(prox) if decoupled else None, **kw)

    (jl, jst), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(logp))
    tl = torch.tensor(logp, requires_grad=True)
    loss, st = F.ppo_actor_loss_fn(
        tl, torch.from_numpy(old), torch.from_numpy(adv), 0.2, torch.from_numpy(mask),
        proximal_logprobs=torch.from_numpy(prox) if decoupled else None, **kw)
    loss.backward()
    assert abs(loss.item() - float(jl)) < ATOL
    assert set(st) == set(jst)
    for k in st:
        assert abs(st[k].item() - float(jst[k])) < ATOL, k
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("decoupled,entropy_coef", [(True, 0.0), (False, 0.01)])
def test_grpo_loss_matches_jax(decoupled, entropy_coef):
    """Packed [rows, T] batch over materialised logits: loss, stats and the
    gradient with respect to the logits."""
    import jax
    import jax.numpy as jnp

    from areal_tpu.ops.functional import grpo_loss_fn as jax_grpo

    rng = np.random.default_rng(2)
    R, T, V = 2, 24, 50
    logits = rng.standard_normal((R, T, V)).astype(np.float32)
    batch = {
        "input_ids": rng.integers(0, V, (R, T)).astype(np.int32),
        "loss_mask": (rng.random((R, T)) > 0.3).astype(np.float32),
        "logprobs": rng.normal(-3.5, 0.3, (R, T)).astype(np.float32),
        "prox_logp": rng.normal(-3.5, 0.3, (R, T)).astype(np.float32),
        "advantages": rng.standard_normal((R, T)).astype(np.float32),
    }
    kw = dict(eps_clip=0.2, c_clip=3.0, temperature=0.9, use_decoupled_loss=decoupled,
              entropy_coef=entropy_coef)

    def jf(lg):
        return jax_grpo(lg, {k: jnp.asarray(v) for k, v in batch.items()}, **kw)

    (jl, jst), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(logits))
    tl = torch.tensor(logits, requires_grad=True)
    loss, st = F.grpo_loss_fn(tl, {k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
    loss.backward()
    assert abs(loss.item() - float(jl)) < 1e-4  # sums over 48 tokens of O(1) terms
    for k in st:
        assert abs(st[k].item() - float(jst[k])) < 1e-4, k
    jg = np.asarray(jg)
    assert np.abs(tl.grad.numpy() - jg).max() / np.abs(jg).max() < 1e-5


def test_gae_with_holes_matches_jax():
    from areal_tpu.ops.gae import gae_padded as jax_gae

    rng = np.random.default_rng(3)
    B, L = 4, 20
    rewards = rng.standard_normal((B, L)).astype(np.float32)
    values = rng.standard_normal((B, L)).astype(np.float32)
    mask = np.ones((B, L), np.float32)
    mask[0, 12:] = 0  # trailing padding
    mask[1, 4:7] = 0  # an interior hole (a multi-turn user span)
    mask[2, :3] = 0
    mask[2, 9:11] = 0
    for gamma, lam in ((1.0, 1.0), (0.99, 0.95)):
        ja, jr = jax_gae(rewards, values, mask, gamma, lam)
        ta, tr = gae_padded(torch.from_numpy(rewards), torch.from_numpy(values),
                            torch.from_numpy(mask), gamma, lam)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL, rtol=0)


def test_masked_normalize_mean_and_kl_match_jax():
    from areal_tpu.ops import functional as J

    rng = np.random.default_rng(4)
    x = rng.normal(2.0, 3.0, (6, 10)).astype(np.float32)
    mask = (rng.random((6, 10)) > 0.4).astype(np.float32)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    for unbiased in (False, True):
        np.testing.assert_allclose(F.masked_normalize(tx, tm, unbiased=unbiased).numpy(),
                                   np.asarray(J.masked_normalize(x, mask, unbiased=unbiased)),
                                   atol=ATOL, rtol=0)
    assert abs(F.masked_mean(tx, tm).item() - float(J.masked_mean(x, mask))) < ATOL
    ref = (x * 0.1 - 1.0).astype(np.float32)
    for kind in ("k1", "k2", "k3"):
        np.testing.assert_allclose(
            F.kl_estimate(tx * 0.1, torch.from_numpy(ref), kind).numpy(),
            np.asarray(J.kl_estimate(x * 0.1, ref, kind)), atol=ATOL, rtol=1e-5)
