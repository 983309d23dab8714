"""PPO with a learned critic through the port's example
(`areal_tpu_torch/examples/math/gsm8k_ppo.py`) on the CPU, over one real
port server process on the seeded tiny model:

- two sync steps: the StatsLogger lines carry the critic's `critic/`
  stats, the critic's values are the batch's GAE baseline (nonzero once
  it has learned from the parity reward's returns), and each actor save
  writes the critic beside it, `value_head.npy` with the tied backbone;
- that critic checkpoint loads in `areal_tpu`'s `JaxPPOCritic.load` and
  gives the port's values (the checkpoint loaded in `TorchPPOCritic`)
  within 1e-5 on the same batch;
- the run dies after step 1 (its recover generation written); the
  relaunch resumes at step 2 with the critic's weights, value head and
  optimizer state restored (`extra_engines`).
"""

import json
import os

import numpy as np
import pytest
import torch

from areal_tpu_torch.api.config import GenServerConfig, PPOCriticConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec, SaveLoadMeta
from areal_tpu_torch.engine.ppo import TorchPPOCritic
from areal_tpu_torch.examples.math import gsm8k_grpo, gsm8k_ppo
from areal_tpu_torch.launcher.local import LocalLauncher
from areal_tpu_torch.utils.recover import RecoverHandler
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# f32 on both sides: two layers of products in another order
VALUE_ATOL = 1e-5
COMMON = ["--device", "cpu", "--model", "tiny", "total_train_steps=3", "async_training=false",
          "gconfig.max_new_tokens=8", "gconfig.n_samples=2", "actor.group_size=2",
          "train_dataset.batch_size=4", "rollout.consumer_batch_size=4",
          "rollout.request_timeout=60", "actor.ppo_n_minibatches=1", "actor.mb_spec.n_mbs=1",
          "critic.ppo_n_minibatches=1", "critic.mb_spec.n_mbs=1", "critic.optimizer.lr=1e-2",
          "saver.freq_steps=1", "checkpointer.freq_steps=1", "recover.mode=auto"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tiny models need no more, and the test
    workers beside this one keep their cores (with every core each, a
    small op's threads wait on each other across the workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reward_parity(prompt, completions, prompt_ids, completion_ids, **kw):
    """Module-level, so the reward pool's workers can import it."""
    return float((len(prompt_ids) + sum(completion_ids)) % 2)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """One port server on the seeded tiny model the trainer starts from."""
    root = tmp_path_factory.mktemp("ppo_example")
    config, _ = gsm8k_ppo.parse_args(["--device", "cpu", "--model", "tiny",
                                      f"cluster.fileroot={root}"])
    v0 = gsm8k_grpo.write_init_snapshot(config, "tiny", "cpu")
    launcher = LocalLauncher(str(root / "server_logs"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        addr = launcher.start_gen_servers(GenServerConfig(
            model_path=v0, dtype="float32", max_seqs=8, max_context_len=1024), device="cpu",
            timeout=120)[0]
    try:
        yield addr
    finally:
        launcher.stop_all()


class _Crash(RuntimeError):
    """The trainer's death after step 1 (its recover generation written)."""


@pytest.fixture(scope="module")
def two_steps(server, tmp_path_factory):
    """Two sync steps of a three-step run that dies after the second;
    returns (fileroot, [(critic, batch, step line)] of each step)."""
    root = tmp_path_factory.mktemp("ppo_run")
    config, _ = gsm8k_ppo.parse_args(COMMON + [f"cluster.fileroot={root}"])
    seen = []

    def on_step(step, actor, batch, line):
        seen.append((actor.critic, dict(batch), line))
        if step == 1:
            raise _Crash

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AREAL_LLM_SERVER_ADDRS", server)
        with pytest.raises(_Crash):
            gsm8k_grpo.run(config, device="cpu", model="tiny", reward_fn=_reward_parity,
                           on_step=on_step)
    return root, seen


def _lines(root):
    with open(root / "logs" / "gsm8k-ppo" / "trial0" / "stats.jsonl") as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def test_two_sync_steps_train_the_critic(two_steps):
    root, seen = two_steps
    assert [line["global_step"] for _, _, line in seen] == [0, 1]
    lines = _lines(root)
    assert [ln["global_step"] for ln in lines] == [0, 1]
    for ln in lines:
        for k in ("critic/loss", "critic/grad_norm", "critic/value_clip_ratio",
                  "timing/compute_values", "timing/critic_update"):
            assert k in ln and np.isfinite(ln[k]), k
    # the zero head scores 0 at step 0; step 1's batch is scored by a
    # critic that has regressed on step 0's returns
    mask = seen[0][1]["loss_mask"] > 0
    assert not seen[0][1]["values"][mask].any()
    assert np.abs(seen[1][1]["values"][seen[1][1]["loss_mask"] > 0]).max() > 0
    assert lines[0]["critic/loss"] > 0 and seen[1][2]["critic_loss"][0] > 0


def test_critic_checkpoint_loads_in_jax(two_steps):
    from areal_tpu.api import config as jc
    from areal_tpu.engine.ppo import JaxPPOCritic
    from areal_tpu.api.io_struct import SaveLoadMeta as JaxMeta
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    root, seen = two_steps
    ckpt = root / "gsm8k-ppo" / "trial0" / "checkpoints" / "critic" / \
        "epoch0epochstep1globalstep1"
    assert (ckpt / "value_head.npy").exists()
    with open(ckpt / "config.json") as f:
        assert json.load(f)["tie_word_embeddings"] is True
    batch = {k: v for k, v in seen[1][1].items()
             if k in ("input_ids", "attention_mask", "loss_mask")}
    kw = dict(dtype="float32", gradient_checkpointing=False, pack_length_quantum=256,
              max_pack_length=1024, optimizer=None)
    tcrit = TorchPPOCritic(PPOCriticConfig(path=str(ckpt), **kw), device="cpu")
    tcrit.initialize(ft_spec=FinetuneSpec(1, 8, 4))
    np.testing.assert_array_equal(tcrit.model.value_head.detach().numpy(),
                                  np.load(ckpt / "value_head.npy"))
    want = tcrit.compute_values(batch)
    jcrit = JaxPPOCritic(jc.PPOCriticConfig(experiment_name="t", trial_name="t",
                                            init_from_scratch=True, **kw),
                         model_config=jax_tiny(vocab_size=512, qkv_bias=True,
                                               hf_architecture="Qwen2ForCausalLM"))
    jcrit.initialize()
    jcrit.load(JaxMeta(path=str(ckpt)))
    got = jcrit.compute_values(batch)
    valid = batch["attention_mask"].astype(bool)
    assert np.abs(want[valid]).max() > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=VALUE_ATOL, rtol=0)


def test_relaunch_restores_the_critic(two_steps, server, monkeypatch):
    root, seen = two_steps
    restored = {}
    load = RecoverHandler.load

    def spy(self, engine, *args, extra_engines=None, **kw):
        info = load(self, engine, *args, extra_engines=extra_engines, **kw)
        critic = extra_engines["critic"]
        restored["head"] = critic.model.value_head.detach().clone()
        restored["count"] = critic._optimizer.count
        restored["params"] = {n: p.detach().clone() for n, p in critic.model.named_parameters()}
        return info

    monkeypatch.setattr(RecoverHandler, "load", spy)
    monkeypatch.setenv("AREAL_LLM_SERVER_ADDRS", server)
    config, _ = gsm8k_ppo.parse_args(COMMON + [f"cluster.fileroot={root}"])
    stats = gsm8k_grpo.run(config, device="cpu", model="tiny", reward_fn=_reward_parity)
    assert [s["global_step"] for s in stats] == [2]
    gen = root / "gsm8k-ppo" / "trial0" / "recover" / "gen-00000001"
    with open(gen / "manifest.json") as f:
        assert json.load(f)["extra_engines"] == ["critic"]
    dumped = gen / "checkpoint_critic"
    np.testing.assert_array_equal(restored["head"].numpy(), np.load(dumped / "value_head.npy"))
    assert restored["count"] == 2  # one update a step, two steps
    # the weights restored are the ones the first run ended with
    before = seen[1][0]
    for n, p in before.model.named_parameters():
        assert torch.equal(restored["params"][n], p.detach()), n
    assert os.path.isdir(dumped / "optimizer")
    # a generation's critic reloads into a fresh engine bit for bit
    fresh = TorchPPOCritic(config.critic, model_config=gsm8k_grpo.model_config_for("tiny"),
                           device="cpu")
    fresh.initialize(ft_spec=FinetuneSpec(1, 8, 4))
    fresh.load(SaveLoadMeta(path=str(dumped), with_optim=True))
    assert fresh._optimizer.count == 2
    assert torch.equal(fresh.model.value_head, before.model.value_head)
