"""The colocated GRPO loop as a whole: the port's
`areal_tpu_torch/scripts/bench_e2e_grpo.py` against the JAX bench's
colocated transport (`scripts/bench_e2e_grpo.py`).

- Two sync steps on the bench's tiny config (f32,
  `tiny_config(vocab_size=512, qkv_bias=True)`), from the same weights, in
  both packages: greedy rollouts through `rollout_batch`, the parity reward,
  `_train_consume` (logprob recompute, batch-normalised advantages,
  decoupled-PPO update) inside `train_phase()`, and the in-memory publish.
  Greedy streams must be equal, logprobs agree to 1e-4 (f32 forwards in
  another op order), advantages to 1e-4 and params to 1e-5 after each
  update (two Adam steps at lr 1e-3, as in test_torch_train_engine.py; the
  bench's own lr of 1e-6 would move no parameter by more than the
  tolerance, so the comparison would prove nothing).
- The same two steps with prefix reuse and group fan-out on in both
  engines (the JAX bench's default `--share-prefix on`): a group's prompt
  prefills once and its siblings ride the copied K/V, and streams,
  logprobs and params must match as before.
- Then three async steps, torch against its own invariants: the staleness
  ledger balances, no consumed token comes from a version above the
  trainer's, and the served weights equal the trainer's after the last
  publish.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from areal_tpu_torch.api.config import GenerationHyperparameters
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.scripts import bench_e2e_grpo as bench
from areal_tpu_torch.workflow.rlvr import RLVRWorkflow
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGP_ATOL = 1e-4
ADV_ATOL = 1e-4
PARAM_ATOL = 1e-5
LR = 1e-3
N_SLOTS, MAX_SEQ_LEN, GROUP, BATCH = 8, 256, 2, 4
# per-prompt generation budgets: one-token completions make the parity
# reward a coin flip, so the rewards (and the batch-normalised advantages)
# vary inside a batch of greedy rollouts
BUDGETS = (1, 1, 1, 12)


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_e2e_grpo", os.path.join(REPO, "scripts", "bench_e2e_grpo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_parts(share_prefix=False):
    """The JAX bench's `_make_parts("tiny", ..., batch_norm=True)` at lr
    1e-3, with the serving engine's f32 KV and ragged decode; without
    `share_prefix` also without prefix reuse (the port's admission before
    it had either), with it at the JAX bench's default admission."""
    from areal_tpu.api.config import (
        MeshConfig,
        MicroBatchSpec,
        NormConfig,
        OptimizerConfig,
        PPOActorConfig,
    )
    from areal_tpu.api.io_struct import FinetuneSpec
    from areal_tpu.engine.colocated import ColocatedEngine
    from areal_tpu.engine.ppo import JaxPPOActor
    from areal_tpu.models.model_config import tiny_config

    cfg = tiny_config(vocab_size=512, qkv_bias=True,
                      hf_architecture="Qwen2ForCausalLM").replace(eos_token_id=None)
    actor = JaxPPOActor(PPOActorConfig(
        experiment_name="e2e-bench", trial_name="b", init_from_scratch=True,
        dtype="float32", param_dtype="float32", gradient_checkpointing=True,
        remat_policy="full", mesh=MeshConfig(), mb_spec=MicroBatchSpec(n_mbs=1),
        optimizer=OptimizerConfig(lr=LR, warmup_steps_proportion=0.0),
        pack_length_quantum=256, max_pack_length=MAX_SEQ_LEN, group_size=GROUP,
        ppo_n_minibatches=1, use_decoupled_loss=True, recompute_logprob=True,
        adv_norm=NormConfig(mean_level="batch", std_level="batch"),
    ), model_config=cfg.replace(dtype="float32", param_dtype="float32"))
    actor.initialize(ft_spec=FinetuneSpec(1, 4096, 8))
    serving = ColocatedEngine(
        cfg.replace(dtype="float32", param_dtype="float32", remat=False),
        params=actor.export_device_params(), n_slots=N_SLOTS, max_seq_len=MAX_SEQ_LEN,
        prompt_bucket=128, decode_chunk=8, share_prefix=share_prefix,
        kv_reuse=share_prefix, ragged_attn=True, kv_dtype="float32")
    return actor, serving, cfg


def _dataset(vocab):
    rng = np.random.default_rng(5)
    return [{"input_ids": rng.integers(0, vocab, int(rng.integers(5, 40))).tolist(),
             "query_id": str(i), "max_new_tokens": BUDGETS[i % len(BUDGETS)]}
            for i in range(2 * BATCH)]


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _jax_params(actor):
    import jax

    from areal_tpu_torch.models.model_config import tiny_config

    tree = jax.tree_util.tree_map(np.asarray, actor.params)
    tcfg = tiny_config(vocab_size=512, qkv_bias=True, hf_architecture="Qwen2ForCausalLM")
    return _params(params_from_jax(tree, tcfg, "cpu", param_dtype="float32"))


def _loops(share_prefix):
    from areal_tpu.api.config import GenerationHyperparameters as JaxGen
    from areal_tpu.workflow.rlvr import RLVRWorkflow as JaxRLVR

    jb = _jax_bench()
    ja, jserving, _ = _jax_parts(share_prefix)
    ta, serving, _ = bench._make_parts("tiny", N_SLOTS, MAX_SEQ_LEN, GROUP,
                                         batch_norm=True, device="cpu", lr=LR,
                                         share_prefix=share_prefix)
    src = _jax_params(ja)
    with torch.no_grad():
        for n, p in ta.model.named_parameters():
            p.copy_(src[n])
    # the served copy was exported before the masters were overwritten
    serving.stop_serving()
    serving.engine.swap_weights_live(ta.export_device_params(), version=0)
    # both packages score with the port bench's parity reward: a module the
    # reward pool's spawned workers import cheaply
    jwf = JaxRLVR(reward_fn=bench._reward_any_even,
                  gconfig=JaxGen(n_samples=GROUP, max_new_tokens=16, greedy=True))
    twf = RLVRWorkflow(reward_fn=bench._reward_any_even,
                       gconfig=GenerationHyperparameters(n_samples=GROUP, max_new_tokens=16,
                                                         greedy=True))
    yield jb, (ja, jserving, jwf), (ta, serving, twf), _params(ta.model)
    jserving.destroy()
    serving.destroy()


@pytest.fixture(scope="module")
def loops():
    """The JAX side without prefix reuse or sharing; the port's bench parts
    at their default (sharing on): the streams must not depend on it."""
    yield from _loops(False)


@pytest.fixture(scope="module")
def shared_loops():
    """Both sides at the JAX bench's default admission: prefix reuse and
    group fan-out on."""
    yield from _loops(True)


def test_two_sync_steps_match_jax(loops):
    _two_sync_steps(loops)


def test_two_sync_steps_with_prefix_sharing_match_jax(shared_loops):
    """The same two steps with both engines sharing each group's prompt
    prefill (the JAX bench's default `--share-prefix on`)."""
    _two_sync_steps(shared_loops)
    (_, jserving, _), (_, serving, _) = shared_loops[1], shared_loops[2]
    assert jserving.engine.stats["shared_tokens"] > 0
    assert serving.engine.stats["shared_tokens"] > 0


def _two_sync_steps(loops):
    jb, (ja, jserving, jwf), (ta, serving, twf), initial = loops
    data = _dataset(512)
    for step in range(2):
        items = data[step * BATCH:(step + 1) * BATCH]
        want = jserving.rollout_batch(items, workflow=jwf)
        got = serving.rollout_batch(items, workflow=twf)
        for k in ("input_ids", "loss_mask", "versions", "attention_mask", "rewards"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"step {step} {k}")
        np.testing.assert_allclose(got["logprobs"], want["logprobs"], atol=LOGP_ATOL, rtol=0)
        assert int(got["versions"].max()) == step
        assert np.unique(got["rewards"]).size > 1, "no reward variance in the batch"

        with jserving.train_phase():
            jb._train_consume(ja, want)
        with serving.train_phase():
            _, (gap, n) = bench._train_consume(ta, got)
        np.testing.assert_allclose(got["prox_logp"], want["prox_logp"], atol=LOGP_ATOL, rtol=0)
        assert n > 0 and gap / n < LOGP_ATOL  # trainer against server, same weights
        np.testing.assert_allclose(got["advantages"], want["advantages"], atol=ADV_ATOL, rtol=0)
        assert np.abs(got["advantages"]).max() > 0.1
        ref, mine = _jax_params(ja), _params(ta.model)
        for name, p in mine.items():
            assert (p - ref[name]).abs().max().item() < PARAM_ATOL, (step, name)

        ja.set_version(step + 1)
        jserving.publish_weights(ja.export_device_params(), version=step + 1)
        ta.set_version(step + 1)
        serving.publish_weights(ta.export_device_params(), version=step + 1)
    moved = max((mine[n] - p0).abs().max().item() for n, p0 in initial.items())
    assert moved > 10 * PARAM_ATOL  # the updates moved the params


def test_three_async_steps_keep_the_ledger(loops):
    _, _, (ta, serving, twf), _ = loops
    dataset = bench.make_dataset(16, 512, 24, 8, seed=1)
    v0 = serving.get_version()
    res = bench.run_mode("async", ta, serving, twf, dataset, BATCH, steps=3, warmup=0,
                         max_head_offpolicyness=1)
    led = res["ledger"]
    assert led["submitted"] == led["accepted"] + led["rejected"] + led["running"]
    assert led["accepted"] >= 3 * BATCH
    assert res["max_version_ahead"] <= 0
    assert sum(res["version_lag_hist"].values()) == res["trajectories"] == 3 * BATCH * GROUP
    assert all(0 <= lag <= 1 for lag in res["version_lag_hist"])  # max_head_offpolicyness
    assert res["same_version_tokens"] > 0
    assert res["same_version_logp_gap_mean"] < LOGP_ATOL
    assert res["reward_timeouts"] == res["reward_failures"] == 0
    assert serving.get_version() == ta.get_version() == v0 + 3
    served = dict(serving.engine.model.named_parameters())
    for name, p in ta.model.named_parameters():
        assert torch.equal(served[name], p.detach()), name
        assert served[name].data_ptr() != p.data_ptr()  # a copy, not the masters
