"""The port's critic, SFT and reward-model engines
(`areal_tpu_torch/engine/ppo/critic.py`, `engine/sft/lm_engine.py`,
`engine/rw/rw_engine.py`) against `JaxPPOCritic`, `JaxLMEngine` and
`JaxRewardModelEngine` on the same parameters (the JAX engine's, carried
across by `models/convert.py`, the critic's value head with them), in f32
on the CPU: values, loss stats and the parameters after one update, on a
batch of an odd pair count and on one padded far wider than its longest
sequence; then the JAX package's behaviours, torch against torch: the
critic learns its returns, SFT's perplexity drops, the reward model
separates its pairs, and GAE takes the values unshifted."""

import numpy as np
import pytest
import torch

from areal_tpu_torch.api import config as tc
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.engine.ppo import TorchPPOActor, TorchPPOCritic
from areal_tpu_torch.engine.rw import TorchRewardModelEngine
from areal_tpu_torch.engine.sft import TorchLMEngine
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.model_config import tiny_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# f32 on both sides: values and losses are sums of two layers of products
# in another order; the parameters after one Adam step at lr 1e-3 move by
# about lr on each element, so 1e-5 bounds a difference of their inputs.
ATOL = 1e-5
MODEL = dict(vocab_size=64, qkv_bias=True, hf_architecture="Qwen2ForCausalLM")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tiny models need no more, and the test
    workers beside this one keep their cores (with every core each, a
    small op's threads wait on each other across the workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kw(m, n_mbs=1, lr=1e-3, wd=0.01, eps=1e-8):
    return dict(init_from_scratch=True, dtype="float32", gradient_checkpointing=False,
                mb_spec=m.MicroBatchSpec(n_mbs=n_mbs), pack_length_quantum=16,
                optimizer=m.OptimizerConfig(lr=lr, warmup_steps_proportion=0.0,
                                            weight_decay=wd, eps=eps))


def _jax_tree(engine):
    import jax

    return jax.tree_util.tree_map(np.asarray, engine.params)


def _port_params(tree, cfg):
    return dict(params_from_jax(tree, cfg, device="cpu", param_dtype="float32")
                .named_parameters())


@torch.no_grad()
def _copy_from_jax(port, jax_engine):
    src = _port_params(_jax_tree(jax_engine), port.model_config)
    for n, p in port.model.named_parameters():
        p.copy_(src[n])


def _assert_params_match(port, jax_engine):
    ref = _port_params(_jax_tree(jax_engine), port.model_config)
    assert set(ref) == {n for n, _ in port.model.named_parameters()}
    for n, p in port.model.named_parameters():
        assert (p - ref[n]).abs().max().item() < ATOL, n


def _assert_stats_match(st, sj, keys):
    for k in keys:
        assert abs(st[k] - sj[k]) <= ATOL * max(1.0, abs(sj[k])), (k, st[k], sj[k])


def _pair(cls, jcls, jcfg, tcfg):
    from areal_tpu.api.io_struct import FinetuneSpec as JaxSpec
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    j = jcls(jcfg, model_config=jax_tiny(**MODEL))
    j.initialize(ft_spec=JaxSpec(1, 64, 8))
    t = cls(tcfg, model_config=tiny_config(**MODEL), device="cpu")
    t.initialize(ft_spec=FinetuneSpec(1, 64, 8))
    return j, t


def _critic_batch(rng, B=8, L=12):
    mask = np.arange(L)[None, :] < rng.integers(6, L + 1, B)[:, None]
    loss_mask = (mask & (np.arange(L)[None, :] >= 3)).astype(np.float32)
    return {"input_ids": rng.integers(0, 64, (B, L)).astype(np.int32) * mask,
            "attention_mask": mask, "loss_mask": loss_mask,
            "returns": rng.standard_normal((B, L)).astype(np.float32) * loss_mask}


def test_critic_matches_jax():
    import jax.numpy as jnp

    from areal_tpu.api import config as jc
    from areal_tpu.engine.ppo import JaxPPOCritic

    j, t = _pair(TorchPPOCritic, JaxPPOCritic,
                 jc.PPOCriticConfig(**_kw(jc, n_mbs=2), experiment_name="t", trial_name="t",
                                    ppo_n_minibatches=2, value_eps_clip=0.2),
                 tc.PPOCriticConfig(**_kw(tc, n_mbs=2), ppo_n_minibatches=2, value_eps_clip=0.2))
    # a nonzero head, so the first update reaches the backbone
    j.params["value_head"] = jnp.asarray(
        np.random.default_rng(9).standard_normal(j.model_config.hidden_size) / 8, jnp.float32)
    _copy_from_jax(t, j)
    assert t.model.lm_head is None and t.model.value_head.shape == (64,)
    bj, bt = _critic_batch(np.random.default_rng(0)), _critic_batch(np.random.default_rng(0))
    bj["values"], bt["values"] = j.compute_values(bj), t.compute_values(bt)
    np.testing.assert_allclose(bt["values"], bj["values"], atol=ATOL, rtol=0)
    assert np.abs(bt["values"]).max() > 0.1
    sj, st = j.ppo_update(bj), t.ppo_update(bt)
    assert len(sj) == len(st) == 2
    for a, b in zip(sj, st):
        _assert_stats_match(b, a, ("loss", "grad_norm", "value_clip_ratio", "n_valid_tokens"))
    _assert_params_match(t, j)


def _sft_batch(rng, B=6, L=14):
    mask = np.arange(L)[None, :] < rng.integers(8, L + 1, B)[:, None]
    return {"input_ids": rng.integers(0, 64, (B, L)).astype(np.int32) * mask,
            "attention_mask": mask,
            "loss_mask": (mask & (np.arange(L)[None, :] >= 4)).astype(np.float32)}


def test_sft_engine_matches_jax():
    from areal_tpu.api import config as jc
    from areal_tpu.engine.sft import JaxLMEngine

    j, t = _pair(TorchLMEngine, JaxLMEngine,
                 jc.TrainEngineConfig(**_kw(jc, n_mbs=2), experiment_name="t", trial_name="t"),
                 tc.TrainEngineConfig(**_kw(tc, n_mbs=2)))
    _copy_from_jax(t, j)
    bj, bt = _sft_batch(np.random.default_rng(1)), _sft_batch(np.random.default_rng(1))
    ej, et = j.evaluate_lm(bj), t.evaluate_lm(bt)
    _assert_stats_match(et, ej, ("loss", "ppl", "loss_sum", "n_valid_tokens", "correct_tokens"))
    sj, st = j.train_lm(bj), t.train_lm(bt)
    _assert_stats_match(st, sj, ("loss", "grad_norm", "ppl", "token_acc", "n_valid_tokens"))
    _assert_params_match(t, j)


def _rw_batch(rng, pairs=3, L=12, width=None):
    B = 2 * pairs
    lens = rng.integers(5, L + 1, B)
    mask = np.arange(width or L)[None, :] < lens[:, None]
    return {"input_ids": rng.integers(3, 64, mask.shape).astype(np.int32) * mask,
            "attention_mask": mask}


@pytest.mark.parametrize("case", ["odd_pairs", "wide_padding"])
def test_reward_model_matches_jax(case):
    """Three pairs over two micro-batches: the rows round up to 8, the last
    pair filler from end to end; and a batch padded to 64 columns whose
    rows bucket to 16."""
    from areal_tpu.api import config as jc
    from areal_tpu.engine.rw import JaxRewardModelEngine

    # Adam's first step moves an element by lr * g / (|g| + eps): where |g|
    # is near eps, f32 noise in g decides the step.  The loss of 3 pairs
    # leaves elements of the gated MLP at |g| ~ 1e-8 (with a grad norm of
    # 18), so this comparison takes eps 1e-6: such an element then moves
    # by lr * g / eps, and every one with |g| >> 1e-6 by about lr
    opt = dict(n_mbs=2, eps=1e-6)
    j, t = _pair(TorchRewardModelEngine, JaxRewardModelEngine,
                 jc.PPOCriticConfig(**_kw(jc, **opt), experiment_name="t", trial_name="t"),
                 tc.PPOCriticConfig(**_kw(tc, **opt)))
    # the heads start at zero, where every score ties: seed one in both
    import jax.numpy as jnp

    j.params["value_head"] = jnp.asarray(
        np.random.default_rng(8).standard_normal(j.model_config.hidden_size) / 8, jnp.float32)
    _copy_from_jax(t, j)
    kw = dict(pairs=3) if case == "odd_pairs" else dict(pairs=2, L=10, width=64)
    bj, bt = (_rw_batch(np.random.default_rng(2), **kw) for _ in range(2))
    rp, data, _ = t._prepare_rows(bt, 2)
    filler = ~np.any(data["segment_ids"] >= 0, axis=-1)
    assert filler.sum() == (2 if case == "odd_pairs" else 0)
    ej, et = j.evaluate_rw(bj), t.evaluate_rw(bt)
    _assert_stats_match(et, ej, ("loss", "acc", "margin", "n_pairs"))
    sj, st = j.train_rw(bj), t.train_rw(bt)
    _assert_stats_match(st, sj, ("loss", "grad_norm", "acc", "margin", "n_pairs"))
    assert st["n_pairs"] == kw["pairs"] and np.isfinite(st["loss"])
    _assert_params_match(t, j)


# ---------------------------------------------------------------------------
# the JAX package's behaviours (tests/test_algo_engines.py), torch against torch
# ---------------------------------------------------------------------------


def _engine(cls, cfg):
    e = cls(cfg, model_config=tiny_config(**MODEL), device="cpu")
    e.initialize(ft_spec=FinetuneSpec(1, 64, 8))
    return e


def test_critic_trains_and_predicts_returns():
    rng = np.random.default_rng(3)
    critic = _engine(TorchPPOCritic, tc.PPOCriticConfig(**_kw(tc, lr=1e-2, wd=0.0),
                                                        ppo_n_minibatches=2))
    B, L = 8, 12
    batch = {"input_ids": rng.integers(0, 64, (B, L)).astype(np.int32),
             "attention_mask": np.ones((B, L), bool), "loss_mask": np.ones((B, L), np.float32),
             "returns": np.tile((np.arange(B) % 2).astype(np.float32)[:, None], (1, L))}
    batch["values"] = critic.compute_values(batch)
    assert batch["values"].shape == (B, L) and not batch["values"].any()  # a zero head
    first = np.abs(batch["values"] - batch["returns"]).mean()
    for _ in range(30):
        batch["values"] = critic.compute_values(batch)
        critic.ppo_update(batch)
    last = np.abs(critic.compute_values(batch) - batch["returns"]).mean()
    assert last < first * 0.5, (first, last)


def test_sft_engine_ppl_drops():
    rng = np.random.default_rng(4)
    eng = _engine(TorchLMEngine, tc.TrainEngineConfig(**_kw(tc, lr=1e-2, wd=0.0)))
    B, L = 8, 12
    batch = {"input_ids": rng.integers(0, 64, (B, L)).astype(np.int32),
             "attention_mask": np.ones((B, L), bool), "loss_mask": np.ones((B, L), np.float32)}
    ppls = [eng.train_lm(batch)["ppl"] for _ in range(6)]
    assert ppls[-1] < ppls[0] * 0.5, ppls
    assert eng.evaluate_lm(batch)["ppl"] < ppls[0]


def test_reward_model_separates_pairs():
    rng = np.random.default_rng(5)
    rw = _engine(TorchRewardModelEngine, tc.PPOCriticConfig(**_kw(tc, lr=1e-2, wd=0.0)))
    B, L = 8, 10
    ids = rng.integers(3, 64, (B, L)).astype(np.int32)
    ids[0::2, 0], ids[1::2, 0] = 1, 2  # chosen rows start with token 1, rejected with 2
    accs = [rw.train_rw({"input_ids": ids, "attention_mask": np.ones((B, L), bool)})["acc"]
            for _ in range(25)]
    assert accs[-1] == 1.0, accs


def test_critic_values_not_shifted_by_advantage_pipeline():
    """values enter compute_advantages un-rolled: the value head's output
    at position t is already V(state before token t + 1)."""
    actor = _engine(TorchPPOActor, tc.PPOActorConfig(**_kw(tc), group_size=1, adv_norm=None))
    values = np.array([[0.1, 0.2, 0.3, 0.4, 0.5, 0.6]], np.float32)
    batch = {"input_ids": np.arange(6, dtype=np.int32)[None],
             "attention_mask": np.ones((1, 6), bool),
             "loss_mask": np.array([[0, 0, 1, 1, 1, 1]], np.float32),
             "logprobs": np.zeros((1, 6), np.float32), "rewards": np.array([1.0], np.float32),
             "values": values.copy()}
    actor.compute_advantages(batch)
    np.testing.assert_array_equal(batch["loss_mask"][0], [0, 1, 1, 1, 1, 0])
    np.testing.assert_allclose(batch["advantages"][0][1:5], 1.0 - values[0][1:5], atol=1e-6)
    np.testing.assert_allclose(batch["returns"][0][1:5], 1.0, atol=1e-6)
