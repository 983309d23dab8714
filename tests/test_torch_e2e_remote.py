"""The remote GRPO loop as a whole: the port's example
(`areal_tpu_torch/examples/math/gsm8k_grpo.py`) on the CPU, its trainer
in this process and its generation server a process of its own (the
launch helper, one server for the whole file), against the JAX pieces of
`tests/test_e2e_grpo.py` (`JaxPPOActor`, the JAX `GenServer`,
`RemoteJaxEngine`).

- Two sync steps with the disk publish, then, from the same start, two
  with the transfer publish, on gsm8k-synth prompts with the example's
  `WordTokenizer`, greedy, a parity reward and batch-level advantage
  normalisation (so advantages are not 0).  At each step the
  JAX pieces roll out the same prompts on a JAX server that serves the
  port trainer's published weights, and the JAX actor trains on its own
  rollouts.  Tokens, versions and rewards must be equal, behaviour and
  recomputed logprobs and advantages agree to 1e-4, and the params after
  each update to 1e-5 (two Adam steps at lr 1e-3, as in
  test_torch_e2e_grpo.py, with Adam's epsilon at 1e-6, see ADAM_EPS).
- The staged publish splits the push from the commit, as
  `test_staged_weight_sync_splits_push_from_commit` does for the JAX
  trainer: after `stage_weights` the server holds the assembled weights
  but serves the old version; the commit swaps them in; the staged marker
  is single-use; a staged disk snapshot is not written again.
"""

import asyncio
import os
import threading

import numpy as np
import pytest
import torch

from areal_tpu_torch.api.config import GenServerConfig
from areal_tpu_torch.examples.math import gsm8k_grpo
from areal_tpu_torch.launcher.local import LocalLauncher, find_free_port
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.model_config import TransformerConfig
from areal_tpu_torch.utils.http import request_with_retry
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOGP_ATOL = ADV_ATOL = 1e-4
PARAM_ATOL = 1e-5
LR = 1e-3
# Adam's epsilon in both packages.  At the default 1e-8 an element whose
# gradient is itself ~1e-8 (a near-cancelling sum, whose last digits differ
# between the frameworks' reduction orders) moves by lr x O(1) on a 1%
# difference of that gradient: single elements then differ by 1-2e-5 after
# one step while the rest agree to 1e-6
ADAM_EPS = 1e-6
SLOTS, SEQ, PAGE = 8, 128, 16
CHUNK = 8  # decode steps per dispatch: the port server's default
BATCH, GROUP, NEW = 4, 2, 8


def _reward_parity(prompt, completions, prompt_ids, completion_ids, **kw):
    """The parity of the prompt's length plus the completion's ids: on
    greedy rollouts of a random model, which continue every gsm8k-synth
    prompt alike, it still varies inside a step's batch (module-level, so
    the reward pool's workers can import it)."""
    return float((len(prompt_ids) + sum(completion_ids)) % 2)


def _jax_cfg():
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    return jax_tiny(vocab_size=128, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
                    eos_token_id=None)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """An f32 checkpoint written by the JAX package, one port server on it
    (AREAL_LLM_SERVER_ADDRS exported, so the example uses it), the JAX
    server on it, and 8 gsm8k-synth prompts."""
    import jax
    from aiohttp import web

    from areal_tpu.gen.engine import GenEngine as JaxEngine
    from areal_tpu.gen.server import GenServer as JaxServer
    from areal_tpu.models import init_params as jax_init
    from areal_tpu.models.hf import save_hf_checkpoint as jax_save

    from areal_tpu_torch.dataset.gsm8k_synth import WordTokenizer

    root = tmp_path_factory.mktemp("e2e_remote")
    ckpt = str(root / "ckpt")
    jcfg = _jax_cfg()
    # bf16-representable f32 weights: a server that reloads them in bf16
    # (the JAX one does) serves them unchanged
    params = jax.tree_util.tree_map(lambda x: x.astype(jax.numpy.bfloat16).astype(x.dtype),
                                    jax_init(jcfg, jax.random.PRNGKey(0)))
    jax_save(params, jcfg, ckpt, save_dtype="float32")
    launcher = LocalLauncher(str(root / "logs"))
    # one intra-op thread: the tiny server needs no more, and the test
    # workers beside it keep their cores
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        addr = launcher.start_gen_servers(GenServerConfig(
            model_path=ckpt, dtype="float32", max_seqs=SLOTS, max_context_len=SEQ,
            page_size=PAGE, random_seed=0), device="cpu", timeout=180)[0]

    jengine = JaxEngine(jcfg.replace(dtype="float32"), model_path=ckpt, ragged_attn=True,
                        kv_reuse=False, share_prefix=False, decode_chunk=CHUNK, n_slots=SLOTS,
                        max_seq_len=SEQ, prompt_bucket=PAGE, kv_dtype="float32")
    jserver = JaxServer(jengine)
    jserver.start()
    port = find_free_port()
    loop = asyncio.new_event_loop()
    up = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(jserver.app())
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
        up.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    assert up.wait(30)
    data = gsm8k_grpo.synth_dataset(2 * BATCH, 0, WordTokenizer())
    try:
        yield dict(root=root, ckpt=ckpt, addr=addr, jax_addr=f"127.0.0.1:{port}",
                   jengine=jengine, data=data)
    finally:
        jserver.shutdown.set()
        jserver.worker.join(timeout=10)
        loop.call_soon_threadsafe(loop.stop)
        launcher.stop_all()


def _config(ckpt, fileroot, mode):
    config, args = gsm8k_grpo.parse_args([
        "--device", "cpu", "--model", "tiny", "--weight-update-mode", mode,
        "total_train_steps=2", "async_training=false",
        f"actor.path={ckpt}", "actor.init_from_scratch=false", "actor.dtype=float32",
        "gconfig.greedy=true", f"gconfig.n_samples={GROUP}", f"gconfig.max_new_tokens={NEW}",
        f"actor.group_size={GROUP}", f"train_dataset.batch_size={BATCH}",
        "train_dataset.shuffle=false", "actor.ppo_n_minibatches=1", "actor.mb_spec.n_mbs=1",
        f"actor.optimizer.lr={LR}", f"actor.optimizer.eps={ADAM_EPS}", "actor.optimizer.warmup_steps_proportion=0.0",
        "actor.adv_norm.mean_level=batch", "actor.adv_norm.std_level=batch",
        "actor.pack_length_quantum=64", f"actor.max_pack_length={SEQ}",
        f"rollout.consumer_batch_size={BATCH}", "rollout.request_timeout=120",
        f"cluster.fileroot={fileroot}"])
    assert args.device == "cpu" and config.weight_update_mode == mode
    return config


def _jax_actor(ckpt):
    from areal_tpu.api.config import (
        MeshConfig,
        MicroBatchSpec,
        NormConfig,
        OptimizerConfig,
        PPOActorConfig,
    )
    from areal_tpu.api.io_struct import FinetuneSpec
    from areal_tpu.engine.ppo import JaxPPOActor

    actor = JaxPPOActor(PPOActorConfig(
        experiment_name="e2e-remote", trial_name="t", path=ckpt, dtype="float32",
        param_dtype="float32", gradient_checkpointing=True, remat_policy="full",
        mesh=MeshConfig(), mb_spec=MicroBatchSpec(n_mbs=1),
        optimizer=OptimizerConfig(lr=LR, eps=ADAM_EPS, warmup_steps_proportion=0.0, weight_decay=0.01,
                                  gradient_clipping=1.0, lr_scheduler_type="constant"),
        pack_length_quantum=64, max_pack_length=SEQ, group_size=GROUP, ppo_n_minibatches=1,
        eps_clip=0.2, use_decoupled_loss=True, recompute_logprob=True,
        adv_norm=NormConfig(mean_level="batch", std_level="batch"),
    ))
    actor.initialize(ft_spec=FinetuneSpec(1, 2 * BATCH, BATCH))
    return actor


def _align(want, got):
    """Rows of `want` reordered to `got`'s, matched by their tokens and
    per-token versions (-1 on the prompt), since the executor returns
    episodes in completion order."""
    def key(b, r):
        return tuple(b["input_ids"][r]), tuple(b["versions"][r])

    keys = [key(want, r) for r in range(len(want["input_ids"]))]
    order = []
    for r in range(len(got["input_ids"])):
        order.append(next(j for j, k in enumerate(keys) if k == key(got, r) and j not in order))
    return {k: (v[order] if isinstance(v, np.ndarray) and v.shape[:1] == (len(order),) else v)
            for k, v in want.items()}


@pytest.mark.parametrize("mode", ["disk", "transfer"])
def test_two_sync_steps_match_the_jax_pieces(setup, mode, tmp_path):
    import jax

    from areal_tpu.api.config import GenerationHyperparameters as JaxGen
    from areal_tpu.api.config import InferenceEngineConfig as JaxRollout
    from areal_tpu.api.io_struct import WeightUpdateMeta as JaxMeta
    from areal_tpu.engine.jax_remote import RemoteJaxEngine
    from areal_tpu.workflow.rlvr import RLVRWorkflow as JaxRLVR

    from areal_tpu_torch.models.hf import save_hf_checkpoint

    ckpt, data = setup["ckpt"], setup["data"]
    # both servers start from the checkpoint, at version 0
    for addr in (setup["addr"], setup["jax_addr"]):
        request_with_retry(addr, "/update_weights_from_disk", {"path": ckpt, "version": 0})
    ja = _jax_actor(ckpt)
    jclient = RemoteJaxEngine(JaxRollout(consumer_batch_size=BATCH, max_concurrent_rollouts=8,
                                         request_timeout=120))
    jclient.initialize(addr=setup["jax_addr"])
    jwf = JaxRLVR(reward_fn=_reward_parity,
                  gconfig=JaxGen(n_samples=GROUP, max_new_tokens=NEW, greedy=True))
    pcfg = TransformerConfig.from_hf(ckpt)
    initial, final = {}, {}

    def on_step(step, actor, got, stats):
        if step == 0:
            initial.update((n, p.detach().clone()) for n, p in params_from_jax(
                jax.tree_util.tree_map(np.asarray, ja.params), pcfg, "cpu",
                param_dtype="float32").named_parameters())
        want = _align(jclient.rollout_batch(data[step * BATCH:(step + 1) * BATCH],
                                            workflow=jwf), got)
        for k in ("input_ids", "versions", "attention_mask", "rewards"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"step {step} {k}")
        assert int(got["versions"].max()) == step
        want["prox_logp"] = ja.compute_logp(want)
        # both batches are predictor-aligned from here on
        ja.compute_advantages(want)
        np.testing.assert_array_equal(got["loss_mask"], want["loss_mask"])
        np.testing.assert_allclose(got["logprobs"], want["logprobs"], atol=LOGP_ATOL, rtol=0,
                                   err_msg=f"step {step}")
        ja.ppo_update(want)
        np.testing.assert_allclose(got["prox_logp"], want["prox_logp"], atol=LOGP_ATOL, rtol=0)
        np.testing.assert_allclose(got["advantages"], want["advantages"], atol=ADV_ATOL,
                                   rtol=0)
        assert np.unique(got["rewards"]).size > 1, f"step {step}: no reward variance"
        ref = params_from_jax(jax.tree_util.tree_map(np.asarray, ja.params), pcfg, "cpu",
                              param_dtype="float32")
        ref = dict(ref.named_parameters())
        for name, p in actor.model.named_parameters():
            assert (p.detach() - ref[name]).abs().max().item() < PARAM_ATOL, (step, name)
            final[name] = p.detach().clone()
        # the JAX server follows the port trainer's publish (its bf16 cast)
        snap = str(tmp_path / "jax_follow")
        save_hf_checkpoint(actor.model, os.path.join(snap, f"v{step + 1}"),
                           save_dtype="bfloat16")
        jclient.update_weights(JaxMeta(type="disk", path=snap))
        jclient.set_version(step + 1)
        assert setup["jengine"].version == step + 1
        # the port server is at the trainer's version
        assert request_with_retry(setup["addr"], "/metrics", method="GET")["version"] == step + 1

    try:
        stats = gsm8k_grpo.run(_config(ckpt, str(tmp_path), mode), device="cpu", model="tiny",
                               reward_fn=_reward_parity, dataset=data, on_step=on_step)
    finally:
        jclient.destroy()
    assert [s["version"] for s in stats] == [1, 2]
    assert all(s["adv_abs_mean"] > 0 and s["lost_trajectories"] == 0 for s in stats)
    moved = max((p - initial[n]).abs().max().item() for n, p in final.items())
    assert moved > 10 * PARAM_ATOL  # the updates moved the params


def test_staged_publish_splits_push_from_commit(setup, tmp_path):
    import time

    from areal_tpu_torch.api.io_struct import WeightUpdateMeta

    addr = setup["addr"]
    request_with_retry(addr, "/update_weights_from_disk", {"path": setup["ckpt"], "version": 0})
    config = _config(setup["ckpt"], str(tmp_path), "transfer")
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.engine.ppo import TorchPPOActor

    actor = TorchPPOActor(config.actor, device="cpu")
    actor.initialize(ft_spec=FinetuneSpec(1, 8, 4))
    with torch.no_grad():
        for p in actor.model.parameters():
            p.add_(0.01)
    meta = WeightUpdateMeta.from_transfer(chunk_mb=1, live_commit=False)
    actor.set_version(1)
    actor.stage_weights(meta)
    m = request_with_retry(addr, "/metrics", method="GET")
    # staged on the server's device, not swapped, generation not paused
    assert m["staged"] and m["version"] == 0
    assert request_with_retry(addr, "/health", method="GET")["status"] == "ok"
    t0 = time.perf_counter()
    actor.update_weights(meta)  # the commit only
    commit_s = time.perf_counter() - t0
    m = request_with_retry(addr, "/metrics", method="GET")
    assert m["version"] == 1 and not m["staged"]
    assert m["last_pause_s"] <= commit_s
    assert actor.last_weight_update_seconds <= commit_s
    # the staged marker is single-use: the next update pushes again
    actor.set_version(2)
    actor.update_weights(meta)
    assert request_with_retry(addr, "/metrics", method="GET")["version"] == 2
    # the disk path: the staged snapshot is not written again at the commit
    disk = WeightUpdateMeta(type="disk", path=str(tmp_path / "updates"))
    actor.set_version(3)
    actor.stage_weights(disk)
    shard = tmp_path / "updates" / "v3" / "model.safetensors"
    mtime = shard.stat().st_mtime_ns
    actor.update_weights(disk)
    assert shard.stat().st_mtime_ns == mtime
    request_with_retry(addr, "/update_weights_from_disk", {"path": str(tmp_path / "updates")})
    assert request_with_retry(addr, "/metrics", method="GET")["version"] == 3
