"""The losses of the algorithms beyond GRPO in the port
(`areal_tpu_torch/ops/functional.py`, `areal_tpu_torch/ops/gae.py`)
against `areal_tpu/ops/functional.py` and `areal_tpu/ops/gae.py`, in f32
on the CPU from the same numpy inputs: the clipped value loss, the SFT
loss on materialised logits and on the fused head, the Bradley-Terry loss
with a filler pair, DPO's loss, the clamped entropy (values and gradients
against `jax.grad`, directly and through both LM heads) and GAE over a
packed buffer with segment boundaries, loss-mask holes and filler."""

import numpy as np
import pytest
import torch

from areal_tpu_torch.models.transformer import LMOutput
from areal_tpu_torch.ops import functional as F
from areal_tpu_torch.ops.gae import gae_segments
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# f32 elementwise math and sums over <= a few hundred elements in another
# order: 1e-5 on losses, stats, entropies and gradients; GAE is the same
# recurrence step for step: 1e-6.
ATOL = 1e-5
GAE_ATOL = 1e-6


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(t, j, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(t), _np(j), atol=atol, rtol=atol, err_msg=what)


@pytest.mark.parametrize("clip", [None, 0.2], ids=["unclipped", "clipped"])
def test_critic_loss_matches_jax(clip):
    import jax
    import jax.numpy as jnp

    from areal_tpu.ops.functional import ppo_critic_loss_fn as jax_loss

    rng = np.random.default_rng(0)
    v, old, ret = (rng.standard_normal(96).astype(np.float32) for _ in range(3))
    mask = (rng.random(96) > 0.3).astype(np.float32)
    (jl, jst), jg = jax.value_and_grad(
        lambda x: jax_loss(x, jnp.asarray(old), jnp.asarray(ret), jnp.asarray(mask), clip),
        has_aux=True)(jnp.asarray(v))
    tv = torch.tensor(v, requires_grad=True)
    loss, st = F.ppo_critic_loss_fn(tv, torch.from_numpy(old), torch.from_numpy(ret),
                                    torch.from_numpy(mask), clip)
    loss.backward()
    _close(loss, jl)
    assert set(st) == set(jst)
    for k in st:
        _close(st[k], jst[k], what=k)
    _close(tv.grad, jg)
    if clip is not None:
        assert st["value_clip_ratio"].item() > 0


def _sft_batch(rng, B=3, T=20, V=96):
    ids = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.4).astype(np.float32)
    return ids, mask


@pytest.mark.parametrize("head", ["logits", "fused"])
def test_sft_loss_matches_jax(head):
    import jax
    import jax.numpy as jnp

    from areal_tpu.models.transformer import LMOutput as JaxLMOutput
    from areal_tpu.ops.functional import sft_loss_fn as jax_sft

    rng = np.random.default_rng(1)
    B, T, D, V = 3, 20, 16, 96
    ids, mask = _sft_batch(rng, B, T, V)
    hidden = rng.standard_normal((B, T, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) / 4).astype(np.float32)
    jb = {"input_ids": jnp.asarray(ids), "loss_mask": jnp.asarray(mask)}
    tb = {"input_ids": torch.from_numpy(ids), "loss_mask": torch.from_numpy(mask)}

    def jf(h):
        out = h @ jnp.asarray(w) if head == "logits" else JaxLMOutput(hidden=h, head=jnp.asarray(w))
        return jax_sft(out, jb)

    (jl, jst), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(hidden))
    th = torch.tensor(hidden, requires_grad=True)
    tw = torch.from_numpy(w)
    out = th @ tw if head == "logits" else LMOutput(hidden=th, head=tw)
    loss, st = F.sft_loss_fn(out, tb, vocab_chunk=32)
    loss.backward()
    _close(loss, jl)
    assert set(st) == set(jst)
    for k in st:
        _close(st[k], jst[k], what=k)
    _close(th.grad, jg)


def test_pairwise_reward_loss_with_filler_pair_matches_jax():
    import jax
    import jax.numpy as jnp

    from areal_tpu.ops.functional import pairwise_reward_loss_fn as jax_loss

    rng = np.random.default_rng(2)
    c, r = (rng.standard_normal(5).astype(np.float32) for _ in range(2))
    pm = np.array([1, 1, 0, 1, 1], bool)  # pair 2 is filler
    (jl, jst), jg = jax.value_and_grad(
        lambda x: jax_loss(x, jnp.asarray(r), jnp.asarray(pm)), has_aux=True)(jnp.asarray(c))
    tc = torch.tensor(c, requires_grad=True)
    loss, st = F.pairwise_reward_loss_fn(tc, torch.from_numpy(r), torch.from_numpy(pm))
    loss.backward()
    _close(loss, jl)
    for k in st:
        _close(st[k], jst[k], what=k)
    _close(tc.grad, jg)
    assert tc.grad[2].item() == 0.0 and st["n_pairs"].item() == 4
    # without a mask every pair counts
    _close(F.pairwise_reward_loss_fn(tc, torch.from_numpy(r))[0],
           jax_loss(jnp.asarray(c), jnp.asarray(r))[0])


def test_dpo_loss_matches_jax():
    import jax.numpy as jnp

    from areal_tpu.ops.functional import dpo_loss_fn as jax_loss

    rng = np.random.default_rng(3)
    xs = [rng.normal(-20, 5, 6).astype(np.float32) for _ in range(4)]
    jl, jst = jax_loss(*map(jnp.asarray, xs), beta=0.2)
    loss, st = F.dpo_loss_fn(*map(torch.from_numpy, xs), beta=0.2)
    _close(loss, jl)
    for k in st:
        _close(st[k], jst[k], what=k)


@pytest.mark.parametrize("clamp", [0.0, 0.2, 0.9])
def test_clamped_entropy_matches_jax(clamp):
    import jax
    import jax.numpy as jnp

    from areal_tpu.ops.functional import _clamped_entropy as jax_clamped

    rng = np.random.default_rng(4)
    logits = (2 * rng.standard_normal((7, 53))).astype(np.float32)
    wts = rng.standard_normal(7).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda x: jnp.sum(jax_clamped(x, clamp) * wts))(
        jnp.asarray(logits))
    tl = torch.tensor(logits, requires_grad=True)
    ent = F._clamped_entropy(tl, clamp)
    (ent * torch.from_numpy(wts)).sum().backward()
    _close(ent, jax_clamped(jnp.asarray(logits), clamp))
    _close(tl.grad, jg)
    if clamp == 0.0:  # the plain entropy
        _close(ent, F.gather_logprobs_entropy(tl, torch.zeros(7, dtype=torch.long))[1])


@pytest.mark.parametrize("clamp", [0.2, 0.9])
@pytest.mark.parametrize("head", ["logits", "chunked"])
def test_clamped_entropy_through_the_head_matches_jax(clamp, head):
    """`lm_logprobs_entropy` routes a clamp through the token-chunked head
    (the port's and JAX's); on logits it clamps the materialised rows."""
    import jax
    import jax.numpy as jnp

    from areal_tpu.models.transformer import LMOutput as JaxLMOutput
    from areal_tpu.ops.functional import lm_logprobs_entropy as jax_lm

    rng = np.random.default_rng(5)
    N, D, V = 24, 16, 80
    hidden = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) / 2).astype(np.float32)
    labels = rng.integers(0, V, N)
    wts = rng.standard_normal(N).astype(np.float32)

    def jf(h, hw):
        out = h @ hw if head == "logits" else JaxLMOutput(hidden=h, head=hw)
        lp, ent, _ = jax_lm(out, jnp.asarray(labels), temperature=0.7, chunk=8,
                            entropy_clamp=clamp, impl="chunked")
        return jnp.sum((ent + 0.5 * lp) * wts), (lp, ent)

    (_, (jlp, jent)), (jgh, jgw) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(w))
    th = torch.tensor(hidden, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    out = th @ tw if head == "logits" else LMOutput(hidden=th, head=tw)
    lp, ent, _ = F.lm_logprobs_entropy(out, torch.from_numpy(labels), temperature=0.7,
                                       chunk=8, entropy_clamp=clamp)
    ((ent + 0.5 * lp) * torch.from_numpy(wts)).sum().backward()
    _close(lp, jlp, what="logprobs")
    _close(ent, jent, what="entropy")
    _close(th.grad, jgh, what="d hidden")
    _close(tw.grad, jgw, what="d head")


def _segments(rng, T=120):
    """Random segment ids with a filler tail and a filler gap."""
    seg = np.full(T, -1, np.int32)
    pos, s = 0, 0
    while pos < T - 20:
        n = int(rng.integers(3, 17))
        seg[pos:pos + n] = s
        pos += n + (4 if s == 2 else 0)  # a filler gap after segment 2
        s += 1
    return seg


@pytest.mark.parametrize("holes", [False, True], ids=["dense", "holes"])
def test_gae_segments_matches_jax(holes):
    import jax.numpy as jnp

    from areal_tpu.ops.gae import gae_segments as jax_gae

    rng = np.random.default_rng(6)
    seg = _segments(rng)
    T = seg.shape[0]
    r = rng.standard_normal(T).astype(np.float32)
    v = rng.standard_normal(T).astype(np.float32)
    lm = (rng.random(T) > 0.25).astype(np.float32) if holes else None
    ja, jr = jax_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(seg), 0.97, 0.9,
                     None if lm is None else jnp.asarray(lm))
    ta, tr = gae_segments(torch.from_numpy(r), torch.from_numpy(v), torch.from_numpy(seg),
                          0.97, 0.9, None if lm is None else torch.from_numpy(lm))
    _close(ta, ja, GAE_ATOL, "advantages")
    _close(tr, jr, GAE_ATOL, "returns")
    assert (ta.numpy()[seg < 0] == 0).all()
