"""GSM8K-style GRPO over remote generation servers: the port of
`examples/math/gsm8k_grpo.py` (`main`).

    python -m areal_tpu_torch.examples.math.gsm8k_grpo                 # Qwen2.5-1.5B on the card
    python -m areal_tpu_torch.examples.math.gsm8k_grpo --device cpu --model tiny \\
        total_train_steps=2 gconfig.max_new_tokens=16
    python -m areal_tpu_torch.examples.math.gsm8k_grpo --weight-update-mode transfer \\
        total_train_steps=1

The trainer runs in this process; the generation servers are processes of
their own, started through the launch helper (`launcher/local.py`) from
`gen_server.model_path`, or from the trainer's v0 snapshot when that is
empty, unless `AREAL_LLM_SERVER_ADDRS` already names running servers.  On
one card, trainer and servers share it.  Each step:

1. `prepare_batch` (async, under the staleness gate) or `rollout_batch`
   (sync) through `RemoteTorchEngine`;
2. `compute_logp` (the proximal logprobs), `compute_advantages`,
   `ppo_update` on `TorchPPOActor`;
3. the publish of the reference (`:260`-`:281`): `set_version` and
   `stage_weights` while the servers generate, then pause the client
   unless the commit is live, `update_weights` on the trainer and the
   client, the client's `set_version`, resume.  `weight_update_mode` is
   "disk" (a snapshot the servers reload) or "transfer" (chunks streamed
   into the servers, committed live or after an abort).

It prints one JSON line of stats per step.  The config is a `GRPOConfig`
built in code with the values of `examples/math/gsm8k_grpo.yaml`; the
dataset is the in-repo `gsm8k-synth` generator with its `WordTokenizer`
(no download), scored by `gsm8k_reward_fn`, and without a checkpoint
(`actor.path`) the weights are random from a seed.  `key.sub=value`
overrides change any field.

Left out of the reference's example: the ref model, the eval client and
`Evaluator`, `Saver`, recovery, `StatsLogger`, `PreemptionGuard` and the
multi-turn and agent workflows.
"""

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from areal_tpu_torch.api.config import (
    ClusterSpecConfig,
    DatasetConfig,
    GenerationHyperparameters,
    GenServerConfig,
    GRPOConfig,
    InferenceEngineConfig,
    MicroBatchSpec,
    NormConfig,
    OptimizerConfig,
    PPOActorConfig,
)

logger = logging.getLogger("areal_tpu_torch.gsm8k_grpo")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
MODELS = ("qwen2.5-1.5b", "tiny")


def default_config() -> GRPOConfig:
    """`examples/math/gsm8k_grpo.yaml`, with the dataset replaced by
    gsm8k-synth and the weights random (no tokenizer or model path)."""
    return GRPOConfig(
        experiment_name="gsm8k-grpo",
        trial_name="trial0",
        seed=1,
        total_train_epochs=1,
        async_training=True,
        cluster=ClusterSpecConfig(fileroot=""),
        train_dataset=DatasetConfig(path="gsm8k-synth", type="gsm8k-synth", batch_size=8,
                                    shuffle=True, drop_last=True, max_length=1024),
        gconfig=GenerationHyperparameters(n_samples=4, max_new_tokens=512, temperature=1.0,
                                          top_p=1.0),
        rollout=InferenceEngineConfig(max_concurrent_rollouts=64, consumer_batch_size=8,
                                      max_head_offpolicyness=4, request_timeout=3600),
        gen_server=GenServerConfig(model_path="", max_seqs=32, max_context_len=2048),
        actor=PPOActorConfig(
            path="", init_from_scratch=True, dtype="bfloat16", gradient_checkpointing=True,
            group_size=4, ppo_n_minibatches=2, eps_clip=0.2, use_decoupled_loss=True,
            recompute_logprob=True, temperature=1.0, pack_length_quantum=512,
            max_pack_length=2048, adv_norm=NormConfig(mean_level="group", std_level="group"),
            mb_spec=MicroBatchSpec(n_mbs=2),
            optimizer=OptimizerConfig(lr=1e-6, lr_scheduler_type="constant",
                                      warmup_steps_proportion=0.001, weight_decay=0.01,
                                      gradient_clipping=1.0),
        ),
    )


def _parse_value(text: str, current: Any) -> Any:
    if isinstance(current, bool):
        if text.lower() not in ("true", "false", "1", "0"):
            raise ValueError(f"not a bool: {text!r}")
        return text.lower() in ("true", "1")
    if isinstance(current, (int, float, str)):
        return type(current)(text)
    if text.lower() in ("null", "none"):
        return None
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def apply_overrides(config: Any, overrides: List[str]) -> Any:
    """Set `key.sub=value` fields of a dataclass tree in place; the value
    takes the type of the field's current value."""
    for item in overrides:
        key, sep, text = item.partition("=")
        if not sep:
            raise ValueError(f"override {item!r} is not key=value")
        *path, leaf = key.split(".")
        node = config
        for part in path:
            node = getattr(node, part)
        if not dataclasses.is_dataclass(node) or leaf not in {
                f.name for f in dataclasses.fields(node)}:
            raise ValueError(f"unknown config field {key!r}")
        setattr(node, leaf, _parse_value(text, getattr(node, leaf)))
    return config


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu, for trainer and servers")
    p.add_argument("--model", default="qwen2.5-1.5b", choices=MODELS,
                   help="the model shape when actor.path is empty")
    p.add_argument("--weight-update-mode", choices=("disk", "transfer"), default=None)
    p.add_argument("overrides", nargs="*", help="key.sub=value, e.g. total_train_steps=2 "
                   "async_training=false weight_update_live_commit=false")
    args = p.parse_args(argv)
    config = default_config()
    if args.model == "tiny":
        # the f32 CPU shape of the port's bench
        config.actor.dtype = config.gen_server.dtype = "float32"
        config.actor.pack_length_quantum = 256
        config.actor.max_pack_length = 1024
        config.gen_server.max_context_len = 1024
        config.gen_server.max_seqs = 8
    if args.weight_update_mode is not None:
        config.weight_update_mode = args.weight_update_mode
    apply_overrides(config, args.overrides)
    return config, args


def model_config_for(model: str):
    from areal_tpu_torch.models.model_config import qwen25_1p5b, tiny_config

    if model == "qwen2.5-1.5b":
        return qwen25_1p5b()
    return tiny_config(vocab_size=512, qkv_bias=True, hf_architecture="Qwen2ForCausalLM")


def synth_dataset(n: int, seed: int, tokenizer) -> List[Dict[str, Any]]:
    from areal_tpu_torch.dataset.gsm8k_synth import generate_problems

    return [{"input_ids": tokenizer.apply_chat_template(p["messages"],
                                                        add_generation_prompt=True),
             "query_id": p["query_id"], "answer": p["answer"]}
            for p in generate_problems(n, seed=seed)]


def _cycle(dataloader):
    while True:
        yield from dataloader


def run(config: GRPOConfig, device: Optional[str] = None, model: str = "qwen2.5-1.5b",
        reward_fn: Optional[Callable] = None,
        dataset: Optional[List[Dict[str, Any]]] = None,
        on_step: Optional[Callable] = None) -> List[Dict[str, Any]]:
    """The training loop; returns each step's stats.  `reward_fn` and
    `dataset` replace gsm8k_reward_fn and the gsm8k-synth problems, and
    `on_step(step, actor, batch, stats)` runs after each step's publish
    (tests)."""
    from areal_tpu_torch.api.io_struct import FinetuneSpec, WeightUpdateMeta
    from areal_tpu_torch.api.reward import prewarm_reward_pool, shutdown_reward_pool
    from areal_tpu_torch.dataset.gsm8k_synth import WordTokenizer
    from areal_tpu_torch.engine.ppo import TorchPPOActor
    from areal_tpu_torch.engine.torch_remote import RemoteTorchEngine
    from areal_tpu_torch.launcher.local import LocalLauncher
    from areal_tpu_torch.reward import gsm8k_reward_fn
    from areal_tpu_torch.utils.dataloader import StatefulDataLoader
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    if config.train_dataset.type != "gsm8k-synth" and dataset is None:
        raise ValueError(f"dataset type {config.train_dataset.type!r}: the port reads "
                         "gsm8k-synth only")
    tokenizer = WordTokenizer()
    if dataset is None:
        dataset = [d for d in synth_dataset(1024, config.seed, tokenizer)
                   if len(d["input_ids"]) <= (config.train_dataset.max_length or 1 << 30)]
    dataloader = StatefulDataLoader(dataset, batch_size=config.train_dataset.batch_size,
                                    shuffle=config.train_dataset.shuffle,
                                    drop_last=config.train_dataset.drop_last, seed=config.seed)
    ft_spec = FinetuneSpec(total_train_epochs=config.total_train_epochs,
                           dataset_size=len(dataset),
                           train_batch_size=config.train_dataset.batch_size)
    fileroot = config.cluster.fileroot or os.path.join(_REPO, "build", "experiments")
    run_dir = os.path.join(fileroot, config.experiment_name, config.trial_name)

    actor = TorchPPOActor(config.actor, model_config=(
        None if config.actor.path else model_config_for(model)), device=device)
    actor.initialize(ft_spec=ft_spec)
    if config.weight_update_mode == "transfer":
        meta = WeightUpdateMeta.from_transfer(config.experiment_name, config.trial_name,
                                              live_commit=config.weight_update_live_commit)
    elif config.weight_update_mode == "disk":
        meta = WeightUpdateMeta.from_disk(config.experiment_name, config.trial_name, fileroot)
    else:
        raise ValueError(f"weight_update_mode {config.weight_update_mode!r}")

    launcher = LocalLauncher(os.path.join(run_dir, "logs"))
    rollout = None
    stats_out: List[Dict[str, Any]] = []
    try:
        if not os.environ.get("AREAL_LLM_SERVER_ADDRS"):
            server_cfg = dataclasses.replace(config.gen_server)
            if not server_cfg.model_path:
                # the servers start from the trainer's v0 snapshot
                v0 = WeightUpdateMeta.from_disk(config.experiment_name, config.trial_name,
                                                fileroot, name="init")
                actor.set_version(0)
                actor.update_weights(v0)
                server_cfg.model_path = os.path.join(v0.path, "v0")
            t0 = time.perf_counter()
            launcher.start_gen_servers(server_cfg, device=device,
                                       timeout=config.rollout.setup_timeout)
            logger.info("server up in %.1f s", time.perf_counter() - t0)
        rollout = RemoteTorchEngine(config.rollout)
        rollout.initialize()
        prewarm_reward_pool()
        workflow = RLVRWorkflow(reward_fn=reward_fn or gsm8k_reward_fn,
                                gconfig=config.gconfig, tokenizer=tokenizer)
        total_steps = config.total_train_steps or ft_spec.total_train_steps
        data_iter = _cycle(dataloader)
        for global_step in range(total_steps):
            t: Dict[str, float] = {}
            t0 = time.perf_counter()
            if config.async_training:
                batch = rollout.prepare_batch(dataloader, workflow=workflow)
            else:
                batch = rollout.rollout_batch(next(data_iter), workflow=workflow)
            t["rollout"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if config.actor.recompute_logprob:
                batch["prox_logp"] = actor.compute_logp(batch)
            t["recompute_logp"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            actor.compute_advantages(batch)
            t["compute_advantages"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            train_stats = actor.ppo_update(batch)
            t["ppo_update"] = time.perf_counter() - t0
            # the expensive half (snapshot write, chunk streaming) runs
            # while generation goes on; only the commit needs the pause
            t0 = time.perf_counter()
            actor.set_version(global_step + 1)
            actor.stage_weights(meta)
            t["stage_weights"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            live = meta.type == "transfer" and meta.live_commit
            if not live:
                rollout.pause()
            actor.update_weights(meta)
            rollout.update_weights(meta)
            rollout.set_version(global_step + 1)
            if not live:
                rollout.resume()
            t["update_weights"] = time.perf_counter() - t0
            rewards = np.asarray(batch["rewards"], np.float32)
            stats = {
                "step": global_step + 1,
                "version": actor.get_version(),
                "n_seqs": int(rewards.size),
                "reward": float(rewards.mean()),
                "adv_abs_mean": float(np.abs(batch["advantages"]).mean()),
                "loss": [float(s["loss"]) for s in train_stats],
                "lost_trajectories": rollout.executor.lost_trajectories,
                "timing_s": t,
            }
            stats_out.append(stats)
            print(json.dumps(stats), flush=True)
            if on_step is not None:
                on_step(global_step, actor, batch, stats)
    finally:
        if rollout is not None:
            rollout.destroy()
        launcher.stop_all()
        shutdown_reward_pool()
    return stats_out


def main(argv: Optional[List[str]] = None) -> int:
    config, args = parse_args(argv)
    run(config, device=args.device, model=args.model)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
