"""The port's AEnt recipe (`areal_tpu_torch/recipes/aent.py`): the JAX
package's behaviours (`tests/test_aent.py`) torch against torch, the
clamped entropy's math, the adaptive coefficient rising below the band,
falling above it and staying in its box, and one update against
`JaxAEntPPOActor` on the same parameters and batch (f32 on the CPU)."""

import numpy as np
import pytest
import torch

from areal_tpu_torch.api.config import OptimizerConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.model_config import tiny_config
from areal_tpu_torch.ops.functional import _clamped_entropy
from areal_tpu_torch.recipes import AEntConfig, AEntPPOActorConfig, TorchAEntPPOActor
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODEL = dict(vocab_size=64, qkv_bias=True, hf_architecture="Qwen2ForCausalLM")
# f32 on both sides: stats are sums over the batch in another order, the
# parameters after one Adam step at lr 1e-3 differ by what their inputs do
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tiny models need no more, and the test
    workers beside this one keep their cores (with every core each, a
    small op's threads wait on each other across the workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_clamped_entropy_math():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(5, 32)).astype(np.float32))
    full = _clamped_entropy(logits, 0.0)
    p = torch.softmax(logits, -1)
    np.testing.assert_allclose(full.numpy(), -(p * p.log()).sum(-1).numpy(), rtol=1e-5)
    # clamping lowers the entropy (the mass renormalised over fewer tokens)
    assert (_clamped_entropy(logits, 0.5) <= full + 1e-6).all()
    # an extreme clamp: nearly deterministic over the one kept token
    assert (_clamped_entropy(logits, 1.0 - 1.0 / 32) < 0.7).all()


def _kw(m, aent_cls, aent, group_size=4):
    return dict(init_from_scratch=True, dtype="float32", gradient_checkpointing=False,
                mb_spec=m.MicroBatchSpec(n_mbs=1), pack_length_quantum=16,
                optimizer=m.OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0,
                                            weight_decay=0.0),
                group_size=group_size, ppo_n_minibatches=1,
                adv_norm=m.NormConfig(mean_level="group", std_level="group",
                                      group_size=group_size),
                aent=aent_cls(**aent))


def _actor(aent, lr=5e-3):
    import areal_tpu_torch.api.config as tc

    kw = _kw(tc, AEntConfig, aent)
    kw["optimizer"] = OptimizerConfig(lr=lr, warmup_steps_proportion=0.0, weight_decay=0.0)
    actor = TorchAEntPPOActor(AEntPPOActorConfig(**kw), model_config=tiny_config(**MODEL),
                              device="cpu")
    actor.initialize(ft_spec=FinetuneSpec(1, 64, 8))
    return actor


def _batch(rng, B=8, L=16, prompt_len=4):
    ids = rng.integers(0, 64, (B, L)).astype(np.int32)
    loss_mask = np.zeros((B, L), np.float32)
    loss_mask[:, prompt_len:] = 1.0
    return {"input_ids": ids, "attention_mask": np.ones((B, L), bool), "loss_mask": loss_mask,
            "logprobs": rng.normal(-1.0, 0.1, (B, L)).astype(np.float32) * loss_mask,
            "rewards": (ids[:, prompt_len] % 2 == 0).astype(np.float32)}


def test_aent_update_and_adaptive_coeff():
    aent = dict(entropy_coeff=5e-3, entropy_clamp=0.25, adaptive=True, entropy_low=100.0,
                entropy_high=200.0, coeff_lr=1e-3, coeff_box_high=1.0, warmup_steps=0)
    actor = _actor(aent)
    batch = _batch(np.random.default_rng(1))
    batch["prox_logp"] = actor.compute_logp(batch)
    actor.compute_advantages(batch)
    c0 = actor.actor.entropy_coeff
    stats = actor.ppo_update(batch)
    assert np.isfinite(stats[-1]["loss"]) and stats[-1]["entropy"] > 0
    # the entropy (a few nats) is far below entropy_low = 100: the coefficient rises
    assert actor.actor.entropy_coeff > c0
    assert stats[-1]["entropy_coeff"] == actor.actor.entropy_coeff
    for _ in range(2):
        actor.compute_advantages(batch)
        actor.ppo_update(batch)
    assert 0.0 <= actor.actor.entropy_coeff <= aent["coeff_box_high"]


def test_aent_coeff_decreases_above_band():
    aent = dict(entropy_coeff=5e-3, adaptive=True, entropy_low=0.0, entropy_high=1e-6,
                coeff_lr=1e-4, warmup_steps=0)
    actor = _actor(aent)
    batch = _batch(np.random.default_rng(2))
    batch["prox_logp"] = actor.compute_logp(batch)
    actor.compute_advantages(batch)
    c0 = actor.actor.entropy_coeff
    actor.ppo_update(batch)
    assert actor.actor.entropy_coeff < c0


def test_aent_update_matches_jax():
    """One update with the clamp on (the token-chunked head) from the JAX
    actor's parameters: stats, the adapted coefficient and the parameters."""
    import jax

    import areal_tpu_torch.api.config as tc
    from areal_tpu.api import config as jc
    from areal_tpu.api.io_struct import FinetuneSpec as JaxSpec
    from areal_tpu.models.model_config import tiny_config as jax_tiny
    from areal_tpu.recipes import AEntConfig as JaxAEnt
    from areal_tpu.recipes import AEntPPOActorConfig as JaxAEntCfg
    from areal_tpu.recipes import JaxAEntPPOActor

    aent = dict(entropy_coeff=2e-2, entropy_clamp=0.2, adaptive=True, entropy_low=100.0,
                entropy_high=200.0, coeff_lr=1e-3, coeff_box_high=1.0)
    ja = JaxAEntPPOActor(JaxAEntCfg(**_kw(jc, JaxAEnt, aent), experiment_name="t",
                                    trial_name="t"), model_config=jax_tiny(**MODEL))
    ja.initialize(ft_spec=JaxSpec(1, 64, 8))
    ta = TorchAEntPPOActor(AEntPPOActorConfig(**_kw(tc, AEntConfig, aent)),
                           model_config=tiny_config(**MODEL), device="cpu")
    ta.initialize(ft_spec=FinetuneSpec(1, 64, 8))

    def bridged():
        tree = jax.tree_util.tree_map(np.asarray, ja.params)
        return dict(params_from_jax(tree, ta.model_config, device="cpu",
                                    param_dtype="float32").named_parameters())

    with torch.no_grad():
        src = bridged()
        for n, p in ta.model.named_parameters():
            p.copy_(src[n])
    bj, bt = _batch(np.random.default_rng(3)), _batch(np.random.default_rng(3))
    bj["prox_logp"], bt["prox_logp"] = ja.compute_logp(bj), ta.compute_logp(bt)
    ja.compute_advantages(bj)
    ta.compute_advantages(bt)
    (sj,), (st,) = ja.ppo_update(bj), ta.ppo_update(bt)
    for k in ("loss", "grad_norm", "entropy", "importance_weight", "new_logp"):
        assert abs(st[k] - sj[k]) <= ATOL * max(1.0, abs(sj[k])), (k, st[k], sj[k])
    assert abs(ta.actor.entropy_coeff - ja.actor.entropy_coeff) <= ATOL
    ref = bridged()
    for n, p in ta.model.named_parameters():
        assert (p - ref[n]).abs().max().item() < ATOL, n


def _clamped_entropy_by_sort(logits, clamp):
    """The clamp's threshold from a full descending sort (what JAX's
    `top_k` computes), the entropy by the same formula."""
    V = logits.shape[-1]
    keep = max(1, V - int(V * clamp))
    kth = logits.sort(dim=-1, descending=True).values[..., keep - 1:keep]
    mask = logits >= kth
    clamped = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    p = torch.softmax(clamped, dim=-1)
    return torch.logsumexp(clamped, dim=-1) - torch.where(mask, p * logits, 0.0).sum(dim=-1)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_clamped_entropy_kthvalue_matches_sort_at_full_vocab(device):
    """`_clamped_entropy`'s kthvalue threshold against a full sort at
    Qwen2.5's vocab (151,936) and clamp 0.2, f32: the same entropies and
    gradients within 1e-3 (the card's check) on rows with ties at the
    threshold (logits rounded to bf16)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device=device).manual_seed(0)
    logits = (3 * torch.randn(8, 151936, generator=gen, device=device)).bfloat16().float()
    a = logits.clone().requires_grad_(True)
    b = logits.clone().requires_grad_(True)
    ea, eb = _clamped_entropy(a, 0.2), _clamped_entropy_by_sort(b, 0.2)
    w = torch.linspace(-1, 1, 8, device=device)
    (ea * w).sum().backward()
    (eb * w).sum().backward()
    assert (ea - eb).abs().max().item() <= 1e-3
    assert (a.grad - b.grad).abs().max().item() <= 1e-3
    assert (ea < _clamped_entropy(logits, 0.0)).all()
