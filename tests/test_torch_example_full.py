"""One step of the port's example with the KL term on (`actor.kl_ctl > 0`,
a ref engine) and a held-out evaluation, on the CPU, against the JAX
package: the trainer and the ref engine start from one JAX-written f32
checkpoint, served by one port server.

- The ref engine's `ref_logp` against `areal_tpu`'s `JaxTrainEngine.forward`
  on the same params and batch, within 1e-4 (f32, two layers of products
  in another order).
- `compute_advantages` with the KL penalty against
  `areal_tpu.engine.ppo.actor.PPOActor`'s on the same inputs (the batch
  as the example hands it over: behaviour, proximal and ref logprobs),
  within 1e-5 (numpy on the same inputs).
- The eval reward goes through `Evaluator` into the step's stats and the
  StatsLogger's line.
"""

import copy
import json

import numpy as np
import pytest

from areal_tpu_torch.api.config import GenServerConfig
from areal_tpu_torch.engine.ppo import TorchPPOActor
from areal_tpu_torch.examples.math import gsm8k_grpo
from areal_tpu_torch.launcher.local import LocalLauncher
from areal_tpu_torch.utils.evaluator import Evaluator
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOGP_ATOL = 1e-4
ADV_ATOL = 1e-5
KL_CTL = 0.1
BATCH, GROUP, NEW, SEQ = 4, 2, 8, 128


def _reward_parity(prompt, completions, prompt_ids, completion_ids, **kw):
    """Module-level, so the reward pool's workers can import it."""
    return float((len(prompt_ids) + sum(completion_ids)) % 2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax

    from areal_tpu.models import init_params as jax_init
    from areal_tpu.models.hf import save_hf_checkpoint as jax_save
    from areal_tpu.models.model_config import tiny_config as jax_tiny

    root = tmp_path_factory.mktemp("example_full")
    ckpt = str(root / "ckpt")
    jcfg = jax_tiny(vocab_size=128, qkv_bias=True, hf_architecture="Qwen2ForCausalLM",
                    eos_token_id=None)
    params = jax.tree_util.tree_map(lambda x: x.astype(jax.numpy.bfloat16).astype(x.dtype),
                                    jax_init(jcfg, jax.random.PRNGKey(0)))
    jax_save(params, jcfg, ckpt, save_dtype="float32")
    launcher = LocalLauncher(str(root / "logs"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        addr = launcher.start_gen_servers(GenServerConfig(
            model_path=ckpt, dtype="float32", max_seqs=8, max_context_len=SEQ, page_size=16),
            device="cpu", timeout=180)[0]
    try:
        yield dict(root=root, ckpt=ckpt, addr=addr)
    finally:
        launcher.stop_all()


def test_one_step_with_kl_and_eval_matches_jax(setup, tmp_path, monkeypatch):
    from areal_tpu.api.config import MeshConfig, NormConfig
    from areal_tpu.api.config import PPOActorConfig as JaxActorCfg
    from areal_tpu.api.config import TrainEngineConfig as JaxEngineCfg
    from areal_tpu.engine.jax_train import JaxTrainEngine
    from areal_tpu.engine.ppo.actor import PPOActor as JaxAlgo

    from areal_tpu_torch.dataset.gsm8k_synth import WordTokenizer

    ckpt = setup["ckpt"]
    monkeypatch.setenv("AREAL_LLM_SERVER_ADDRS", setup["addr"])
    config, _ = gsm8k_grpo.parse_args([
        "--device", "cpu", "--model", "tiny", "total_train_steps=1", "async_training=false",
        f"actor.path={ckpt}", "actor.init_from_scratch=false", "actor.dtype=float32",
        f"gconfig.n_samples={GROUP}", f"gconfig.max_new_tokens={NEW}",
        f"actor.group_size={GROUP}", f"train_dataset.batch_size={BATCH}",
        "actor.ppo_n_minibatches=1", "actor.mb_spec.n_mbs=1", "actor.pack_length_quantum=64",
        f"actor.max_pack_length={SEQ}", f"actor.kl_ctl={KL_CTL}", "actor.kl_estimator=k3",
        "ref.dtype=float32", "ref.pack_length_quantum=64", f"ref.max_pack_length={SEQ}",
        "evaluator.freq_secs=0", f"rollout.consumer_batch_size={BATCH}",
        "rollout.request_timeout=120", f"cluster.fileroot={tmp_path}"])
    tok = WordTokenizer()
    data = gsm8k_grpo.synth_dataset(2 * BATCH, 0, tok)
    valid = gsm8k_grpo.synth_dataset(3, 7, tok)
    seen = {}
    advantages = TorchPPOActor.compute_advantages
    evaluate = Evaluator.evaluate

    def spy_advantages(self, batch):
        seen["before"] = copy.deepcopy(batch)
        advantages(self, batch)
        seen["after"] = batch

    def spy_evaluate(self, fn, *args, **kw):
        out = evaluate(self, fn, *args, **kw)
        seen.setdefault("evals", []).append(out)
        return out

    monkeypatch.setattr(TorchPPOActor, "compute_advantages", spy_advantages)
    monkeypatch.setattr(Evaluator, "evaluate", spy_evaluate)
    stats = gsm8k_grpo.run(config, device="cpu", model="tiny", reward_fn=_reward_parity,
                           dataset=data, valid_dataset=valid)
    before, after = seen["before"], seen["after"]
    assert "ref_logp" in before and stats[0]["kl_ref"] != 0

    ref = JaxTrainEngine(JaxEngineCfg(
        experiment_name="ex", trial_name="t", path=ckpt, dtype="float32",
        param_dtype="float32", mesh=MeshConfig(), pack_length_quantum=64,
        max_pack_length=SEQ, optimizer=None))
    ref.initialize()
    want_ref = ref.forward(before)
    valid_tok = before["attention_mask"].astype(bool)
    np.testing.assert_allclose(before["ref_logp"][valid_tok], want_ref[valid_tok],
                               atol=LOGP_ATOL, rtol=0)

    algo = JaxAlgo(JaxActorCfg(
        experiment_name="ex", trial_name="t", group_size=GROUP, kl_ctl=KL_CTL,
        kl_estimator="k3", use_decoupled_loss=True, recompute_logprob=True,
        adv_norm=NormConfig(mean_level="group", std_level="group")), engine=None)
    want = copy.deepcopy(before)
    algo.compute_advantages(want)
    for k in ("advantages", "logprobs", "loss_mask", "returns", "tot_rewards"):
        np.testing.assert_allclose(after[k], want[k], atol=ADV_ATOL, rtol=0, err_msg=k)
    # the KL term moved the advantages: without it they differ
    no_kl = copy.deepcopy(before)
    no_kl.pop("ref_logp")
    algo.compute_advantages(no_kl)
    assert np.abs(no_kl["advantages"] - want["advantages"]).max() > ADV_ATOL

    assert seen["evals"] == [stats[0]["eval"]] and stats[0]["eval"]["eval_n"] == len(valid)
    with open(tmp_path / "logs" / "gsm8k-grpo" / "trial0" / "stats.jsonl") as f:
        (line,) = [json.loads(ln) for ln in f]
    assert line["eval_reward_mean"] == stats[0]["eval"]["eval_reward_mean"]
    assert line["kl_ref"] == stats[0]["kl_ref"] and line["global_step"] == 0
