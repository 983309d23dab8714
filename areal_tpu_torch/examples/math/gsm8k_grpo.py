"""GSM8K-style GRPO over remote generation servers: the port of
`examples/math/gsm8k_grpo.py` (`main`).

    python -m areal_tpu_torch.examples.math.gsm8k_grpo                 # Qwen2.5-1.5B on the card
    python -m areal_tpu_torch.examples.math.gsm8k_grpo --device cpu --model tiny \\
        total_train_steps=2 gconfig.max_new_tokens=16
    python -m areal_tpu_torch.examples.math.gsm8k_grpo --weight-update-mode transfer \\
        total_train_steps=1
    python -m areal_tpu_torch.examples.math.gsm8k_grpo --launch recover.mode=fault \\
        checkpointer.freq_steps=1 total_train_steps=3

The trainer runs in this process; the generation servers are processes of
their own, started through the launch helper (`launcher/local.py`) from
`gen_server.model_path`, or from the trainer's v0 snapshot when that is
empty, unless `AREAL_LLM_SERVER_ADDRS` already names running servers:
as many as `allocation_mode`'s generation part has data-parallel ranks
(``allocation_mode=jax:d2+d1`` starts two; one without a mode), each
registered in name_resolve under the experiment and trial.  On one card,
trainer and servers share it.  With `--launch` this process is
the launcher instead (`LocalLauncher.run`): it starts the servers once
(writing the v0 snapshot of the seeded random weights itself when there
is no model path), runs the trainer as a subprocess with the same
arguments, and relaunches it after a crash (while `recover.mode` is
`auto` or `fault`, at most `recover.retries` times) or a preemption; the
relaunched trainer resumes from its recover generation.

At start: `seeding.set_random_seed`, the `PreemptionGuard`, the actor,
the ref engine (a `TorchTrainEngine` without an optimizer, from
`ref.path`, else the actor's path, else the actor's random weights from
the same seed) when `actor.kl_ctl > 0` and `ref` is set, the eval client
(no staleness limit) when `valid_dataset` is set, `Saver`, the
checkpointer (a `Saver` for recovery), `Evaluator`, `StatsLogger` and
`RecoverHandler` under the config's fingerprint; then, when
`check_if_recover` says so, `recover.load`: weights, optimizer, step,
dataloader position, the other states, the servers reloaded at the
recovered version and the ledger settled.  Each step:

1. `prepare_batch` (async, under the staleness gate) or `rollout_batch`
   (sync) through `RemoteTorchEngine`;
2. `compute_logp` (the proximal logprobs), `ref.forward` into
   `ref_logp`, `compute_advantages` (the KL penalty against the ref),
   `ppo_update` on `TorchPPOActor`;
3. the publish of the reference: `set_version` and `stage_weights` while
   the servers generate, then pause the client unless the commit is live,
   `update_weights` on the trainer and the client, the clients'
   `set_version`, resume.  `weight_update_mode` is "disk" (a snapshot the
   servers reload) or "transfer" (chunks streamed into the servers,
   committed live or after an abort);
4. `Saver.save`, and `recover.dump` when the checkpointer's period is
   up; the `Evaluator` runs the eval client greedily over the held-out
   problems;
5. the `StatsLogger` commit (flat numbers: the actor's stats, reward,
   KL to the ref, eval reward, the staleness ledger, lost trajectories,
   run id, version, the recover timings, this process's flash kernel
   launches so far, wall-clock `ts`), one JSON line
   on stdout, `fault_point("train_step")`, and the preemption check
   (`preempt_exit`: dump, exit 75).

The config is a `GRPOConfig` built in code with the values of
`examples/math/gsm8k_grpo.yaml`; the dataset is the in-repo `gsm8k-synth`
generator with its `WordTokenizer` (no download), scored by
`gsm8k_reward_fn`.  Its held-out split (`valid_dataset` of type
gsm8k-synth) is `valid_dataset.batch_size` problems drawn under seed + 1:
the generator has no fixed test split.  Without a checkpoint
(`actor.path`) the weights are random from a seed.  `key.sub=value`
overrides change any field; a path through an unset optional section
(`ref.dtype=bfloat16`, `valid_dataset.batch_size=32`) creates it with
its defaults.

`run` is also the loop of PPO with a learned critic
(`examples/math/gsm8k_ppo.py`): a config with a `critic` section
(`PPOConfig`) adds a `TorchPPOCritic` whose per-token values go into the
batch before `compute_advantages` (the GAE baseline), its `ppo_update`
after the actor's (stats `critic/`-prefixed in the StatsLogger line), its
save beside every actor save (name "critic", forced), and its state in
every recover dump and load (`extra_engines`).

Left out of the reference's example: the multi-turn and agent workflows,
`warm_pack_shapes` (eager PyTorch compiles nothing per shape) and the
generated-text dumps of the workflows.
"""

import argparse
import dataclasses
import json
import logging
import os
import sys
import threading
import time
import typing
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from areal_tpu_torch.api.config import (
    ClusterSpecConfig,
    DatasetConfig,
    EvaluatorConfig,
    GenerationHyperparameters,
    GenServerConfig,
    GRPOConfig,
    InferenceEngineConfig,
    MicroBatchSpec,
    NormConfig,
    OptimizerConfig,
    PPOActorConfig,
    RecoverConfig,
    SaverConfig,
    StatsLoggerConfig,
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
        saver=SaverConfig(freq_steps=100),
        checkpointer=SaverConfig(freq_steps=50),
        evaluator=EvaluatorConfig(freq_steps=None),
        recover=RecoverConfig(mode="disabled"),
        stats_logger=StatsLoggerConfig(),
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


def _optional_dataclass(node: Any, name: str) -> Optional[type]:
    """The dataclass type of `node`'s field `name` when it is declared
    `Optional[<dataclass>]`."""
    hint = typing.get_type_hints(type(node)).get(name)
    for arg in typing.get_args(hint):
        if dataclasses.is_dataclass(arg):
            return arg
    return None


def apply_overrides(config: Any, overrides: List[str]) -> Any:
    """Set `key.sub=value` fields of a dataclass tree in place; the value
    takes the type of the field's current value.  A path through an
    optional section that is None creates the section with its defaults."""
    for item in overrides:
        key, sep, text = item.partition("=")
        if not sep:
            raise ValueError(f"override {item!r} is not key=value")
        *path, leaf = key.split(".")
        node = config
        for part in path:
            child = getattr(node, part)
            if child is None and (cls := _optional_dataclass(node, part)) is not None:
                child = cls()
                setattr(node, part, child)
            node = child
        if not dataclasses.is_dataclass(node) or leaf not in {
                f.name for f in dataclasses.fields(node)}:
            raise ValueError(f"unknown config field {key!r}")
        setattr(node, leaf, _parse_value(text, getattr(node, leaf)))
    return config


def parse_args(argv: Optional[List[str]] = None,
               default: Callable[[], GRPOConfig] = default_config):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu, for trainer and servers")
    p.add_argument("--model", default="qwen2.5-1.5b", choices=MODELS,
                   help="the model shape when actor.path is empty")
    p.add_argument("--weight-update-mode", choices=("disk", "transfer"), default=None)
    p.add_argument("--launch", action="store_true",
                   help="run as the launcher: servers once, the trainer as a subprocess, "
                        "relaunched after a crash or a preemption")
    p.add_argument("--relaunch-delay", type=float, default=None,
                   help="--launch: seconds before a crashed trainer is relaunched "
                        "(default: the launcher's RECOVER_TIME_INTERVAL)")
    p.add_argument("--trainer-timeout", type=float, default=None,
                   help="--launch: kill a trainer that runs longer than this many seconds")
    p.add_argument("--exit-with-parent", action="store_true",
                   help="exit when the process that started this one is gone (a launcher's)")
    p.add_argument("overrides", nargs="*", help="key.sub=value, e.g. total_train_steps=2 "
                   "async_training=false weight_update_live_commit=false")
    args = p.parse_intermixed_args(argv)
    config = default()
    if args.model == "tiny":
        # the f32 CPU shape of the port's bench
        config.gen_server.dtype = "float32"
        for eng in (config.actor, getattr(config, "critic", None)):
            if eng is not None:
                eng.dtype = "float32"
                eng.pack_length_quantum = 256
                eng.max_pack_length = 1024
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


def resolve_fileroot(config: GRPOConfig) -> str:
    return config.cluster.fileroot or os.path.join(_REPO, "build", "experiments")


def _kl_to_ref(batch: Dict[str, np.ndarray], estimator: str) -> float:
    """The mean KL estimate between the behaviour and the ref policy over
    the loss tokens (after `compute_advantages`: predictor-aligned
    `logprobs` and `loss_mask`, token-aligned `ref_logp`)."""
    from areal_tpu_torch.utils.data import KLEstimator

    mask = batch["loss_mask"]
    ref = np.roll(batch["ref_logp"].astype(np.float32), -1, axis=-1) * mask
    kl = KLEstimator(estimator)(batch["logprobs"], ref) * mask
    return float(kl.sum() / max(mask.sum(), 1.0))


def serve_train_metrics() -> Tuple[int, Callable[[], None]]:
    """The trainer's `/metrics` on a free local port: the `train`
    registry (staleness at consumption, client resubmissions and their
    cache hits, partial publish failures, recover).  Returns the port and
    the function that stops it."""
    from areal_tpu_torch.utils import telemetry

    srv, port = telemetry.start_metrics_server(telemetry.TRAIN)
    logger.info("trainer /metrics on :%d", port)

    def close() -> None:
        srv.shutdown()
        srv.server_close()

    return port, close


def run(config: GRPOConfig, device: Optional[str] = None, model: str = "qwen2.5-1.5b",
        reward_fn: Optional[Callable] = None,
        dataset: Optional[List[Dict[str, Any]]] = None,
        on_step: Optional[Callable] = None,
        valid_dataset: Optional[List[Dict[str, Any]]] = None) -> List[Dict[str, Any]]:
    """The training loop; returns the stats of each step this run trained.
    `reward_fn`, `dataset` and `valid_dataset` replace gsm8k_reward_fn and
    the gsm8k-synth problems, and `on_step(step, actor, batch, stats)` runs
    after each step's commit (tests).  A config with a `critic` section
    runs PPO with that learned critic (module docstring); `on_step` then
    finds it as `actor.critic`."""
    from areal_tpu_torch.api.config import propagate_names, to_dict
    from areal_tpu_torch.api.io_struct import FinetuneSpec, StepInfo, WeightUpdateMeta
    from areal_tpu_torch.api.reward import prewarm_reward_pool, shutdown_reward_pool
    from areal_tpu_torch.dataset.gsm8k_synth import WordTokenizer
    from areal_tpu_torch.engine.ppo import TorchPPOActor, TorchPPOCritic
    from areal_tpu_torch.engine.torch_remote import RemoteTorchEngine
    from areal_tpu_torch.engine.torch_train import TorchTrainEngine
    from areal_tpu_torch.launcher.local import LocalLauncher, servers_for_allocation
    from areal_tpu_torch.ops import flash_attention as fa
    from areal_tpu_torch.reward import gsm8k_reward_fn
    from areal_tpu_torch.utils import name_resolve, seeding, stats
    from areal_tpu_torch.utils.dataloader import StatefulDataLoader
    from areal_tpu_torch.utils.evaluator import Evaluator
    from areal_tpu_torch.utils.faults import fault_point
    from areal_tpu_torch.utils.recover import RecoverHandler, check_if_recover, config_fingerprint
    from areal_tpu_torch.utils.saver import Saver
    from areal_tpu_torch.utils.shutdown import PreemptionGuard, preempt_exit
    from areal_tpu_torch.utils.stats_logger import StatsLogger
    from areal_tpu_torch.utils.telemetry import is_enabled as telemetry_enabled
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    for name, ds, given in (("train", config.train_dataset, dataset),
                            ("valid", config.valid_dataset, valid_dataset)):
        if ds is not None and ds.type != "gsm8k-synth" and given is None:
            raise ValueError(f"{name} dataset type {ds.type!r}: the port reads gsm8k-synth only")
    fileroot = resolve_fileroot(config)
    propagate_names(config, fileroot)
    # the servers this process starts inherit the store through the env
    name_resolve.export_env(config.cluster.name_resolve)
    name_resolve.reconfigure_from_env(config.cluster.name_resolve)
    seeding.set_random_seed(config.seed, "trainer")
    run_id = int(os.environ.get("AREAL_RUN_ID", 0))
    tokenizer = WordTokenizer()
    if dataset is None:
        dataset = [d for d in synth_dataset(1024, config.seed, tokenizer)
                   if len(d["input_ids"]) <= (config.train_dataset.max_length or 1 << 30)]
    if valid_dataset is None and config.valid_dataset is not None:
        valid_dataset = synth_dataset(config.valid_dataset.batch_size, config.seed + 1,
                                      tokenizer)
    dataloader = StatefulDataLoader(dataset, batch_size=config.train_dataset.batch_size,
                                    shuffle=config.train_dataset.shuffle,
                                    drop_last=config.train_dataset.drop_last, seed=config.seed)
    ft_spec = FinetuneSpec(total_train_epochs=config.total_train_epochs,
                           dataset_size=len(dataset),
                           train_batch_size=config.train_dataset.batch_size)
    run_dir = os.path.join(fileroot, config.experiment_name, config.trial_name)

    mc = None if config.actor.path else model_config_for(model)
    actor = TorchPPOActor(config.actor, model_config=mc, device=device)
    actor.initialize(ft_spec=ft_spec)
    ref = None
    if config.actor.kl_ctl > 0 and config.ref is not None:
        ref_path = config.ref.path or config.actor.path
        ref = TorchTrainEngine(dataclasses.replace(config.ref, path=ref_path, optimizer=None),
                               model_config=None if ref_path else mc, device=device)
        ref.initialize(ft_spec=ft_spec)
    critic = None
    extra_engines: Dict[str, Any] = {}
    if getattr(config, "critic", None) is not None:
        # without a path of its own the critic starts from the actor's
        # backbone (its checkpoint, or the same seeded random weights)
        ccfg = config.critic if config.critic.path else dataclasses.replace(
            config.critic, path=config.actor.path,
            init_from_scratch=config.actor.init_from_scratch)
        critic = TorchPPOCritic(ccfg, model_config=None if ccfg.path else model_config_for(model),
                                device=device)
        critic.initialize(ft_spec=ft_spec)
        actor.critic = critic
        extra_engines["critic"] = critic
    if config.weight_update_mode == "transfer":
        meta = WeightUpdateMeta.from_transfer(config.experiment_name, config.trial_name,
                                              live_commit=config.weight_update_live_commit)
    elif config.weight_update_mode == "disk":
        meta = WeightUpdateMeta.from_disk(config.experiment_name, config.trial_name, fileroot)
    else:
        raise ValueError(f"weight_update_mode {config.weight_update_mode!r}")

    launcher = LocalLauncher(os.path.join(run_dir, "logs"))
    rollout = eval_rollout = stats_logger = close_metrics = None
    stats_out: List[Dict[str, Any]] = []
    # SIGTERM/SIGINT -> dump and the resume exit code at the step boundary
    guard = (PreemptionGuard().install()
             if threading.current_thread() is threading.main_thread() else None)
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
            launcher.start_gen_servers(server_cfg,
                                       servers_for_allocation(config.allocation_mode),
                                       device=device, timeout=config.rollout.setup_timeout,
                                       experiment_name=config.experiment_name,
                                       trial_name=config.trial_name)
            logger.info("server up in %.1f s", time.perf_counter() - t0)
        rollout = RemoteTorchEngine(config.rollout)
        rollout.initialize()
        if telemetry_enabled():  # AREAL_TELEMETRY=1
            _, close_metrics = serve_train_metrics()
        if valid_dataset is not None:
            # eval has no off-policyness limit
            eval_rollout = RemoteTorchEngine(dataclasses.replace(
                config.rollout, max_head_offpolicyness=int(1e12)))
            eval_rollout.initialize()
        prewarm_reward_pool()
        workflow = RLVRWorkflow(reward_fn=reward_fn or gsm8k_reward_fn,
                                gconfig=config.gconfig, tokenizer=tokenizer)
        eval_workflow = RLVRWorkflow(reward_fn=reward_fn or gsm8k_reward_fn,
                                     gconfig=config.gconfig.new(n_samples=1, temperature=0.0),
                                     tokenizer=tokenizer)
        saver = Saver(config.saver, ft_spec)
        checkpointer = Saver(config.checkpointer, ft_spec, for_recover=True)
        evaluator = Evaluator(config.evaluator, ft_spec)
        stats_logger = StatsLogger(config.stats_logger)
        recover = RecoverHandler(config.recover, ft_spec,
                                 fingerprint=config_fingerprint(to_dict(config)))
        # what a dump needs, shared by the periodic dump and the preemption
        dump_kwargs = dict(saver=saver, evaluator=evaluator, stats_logger=stats_logger,
                           dataloader=dataloader, inference_engine=rollout,
                           extra_engines=extra_engines)

        start_step = 0
        recovered: Dict[str, Any] = {}
        if check_if_recover(config.recover, run_id=run_id):
            info = recover.load(actor, saver=saver, evaluator=evaluator,
                                stats_logger=stats_logger, dataloader=dataloader,
                                inference_engine=rollout, weight_update_meta=meta,
                                extra_engines=extra_engines)
            if info is not None:
                start_step = info.recover_start.global_step
                if eval_rollout is not None:
                    eval_rollout.set_version(actor.get_version())
                # a preempted predecessor parked the servers' generation
                rollout.continue_generation()
                recovered = dict(recover.last_load)

        total_steps = config.total_train_steps or ft_spec.total_train_steps
        steps_per_epoch = ft_spec.steps_per_epoch
        data_iter = _cycle(dataloader)
        for global_step in range(start_step, total_steps):
            step_info = StepInfo(epoch=global_step // steps_per_epoch,
                                 epoch_step=global_step % steps_per_epoch,
                                 global_step=global_step, steps_per_epoch=steps_per_epoch)
            epoch, epoch_step = step_info.epoch, step_info.epoch_step
            t: Dict[str, float] = {}
            t_step = t0 = time.perf_counter()
            if config.async_training:
                batch = rollout.prepare_batch(dataloader, workflow=workflow)
            else:
                batch = rollout.rollout_batch(next(data_iter), workflow=workflow)
            t["rollout"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if config.actor.recompute_logprob:
                batch["prox_logp"] = actor.compute_logp(batch)
            t["recompute_logp"] = time.perf_counter() - t0
            if critic is not None:
                # the critic's values are the GAE baseline, predictor-aligned
                t0 = time.perf_counter()
                batch["values"] = critic.compute_values(batch)
                t["compute_values"] = time.perf_counter() - t0
            if ref is not None:
                t0 = time.perf_counter()
                batch["ref_logp"] = ref.forward(batch)
                t["ref_logp"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            actor.compute_advantages(batch)
            t["compute_advantages"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            train_stats = actor.ppo_update(batch)
            t["ppo_update"] = time.perf_counter() - t0
            critic_stats: List[Dict[str, float]] = []
            if critic is not None:
                t0 = time.perf_counter()
                # prefixed, so the critic's loss and grad norm do not shadow
                # the actor's in the merged line
                critic_stats = [{f"critic/{k}": v for k, v in d.items()}
                                for d in critic.ppo_update(batch)]
                t["critic_update"] = time.perf_counter() - t0
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
            if eval_rollout is not None:
                eval_rollout.set_version(global_step + 1)
            if not live:
                rollout.resume()
            t["update_weights"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if (saver.save(actor, epoch, epoch_step, global_step) is not None
                    and critic is not None):
                # forced: the actor's save took this step's frequency trigger
                saver.save(critic, epoch, epoch_step, global_step, name="critic", force=True)
            t["save"] = time.perf_counter() - t0
            dumped: Dict[str, Any] = {}
            if checkpointer.freq.check(epoch, global_step):
                recover.dump(actor, step_info, **dump_kwargs)
                dumped = dict(recover.last_dump)

            def evaluate_fn():
                eval_batch = eval_rollout.rollout_batch(list(valid_dataset),
                                                        workflow=eval_workflow)
                rew = np.asarray(eval_batch["rewards"], np.float32)
                return {"eval_reward_mean": float(rew.mean()), "eval_n": int(rew.size)}

            t0 = time.perf_counter()
            evaluated = (evaluator.evaluate(evaluate_fn, epoch, epoch_step, global_step)
                         if eval_rollout is not None else None)
            t["eval"] = time.perf_counter() - t0

            rewards = np.asarray(batch["rewards"], np.float32)
            led = rollout.executor.staleness_manager.get_stats()
            record: Dict[str, float] = {
                "run_id": run_id, "version": actor.get_version(), "n_seqs": int(rewards.size),
                "reward": float(rewards.mean()),
                "adv_abs_mean": float(np.abs(batch["advantages"]).mean()),
                "lost_trajectories": rollout.executor.lost_trajectories,
                **{f"ledger/{k}": v for k, v in dataclasses.asdict(led).items()},
                **{f"timing/{k}": v for k, v in t.items()},
                "step_s": time.perf_counter() - t_step, "ts": time.time(),
            }
            # this process's kernel launches so far (0 on the CPU)
            for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
                record[f"launches/{w.__name__}"] = w.launches
                record[f"launches/{w.__name__}_tc"] = w.launches_tc
            if ref is not None:
                record["kl_ref"] = _kl_to_ref(batch, config.actor.kl_estimator)
            if evaluated is not None:
                record.update(evaluated)
            if dumped:
                record.update({"recover/dump_s": dumped["seconds"],
                               "recover/dump_gb": dumped["bytes"] / 1e9,
                               "recover/write_s": dumped["write_seconds"],
                               "recover/digest_s": dumped["digest_seconds"],
                               "recover/fsync_s": dumped["fsync_seconds"]})
            if recovered and global_step == start_step:
                record.update({"recover/load_s": recovered["seconds"],
                               "recover/validate_s": recovered["validate_seconds"],
                               "recover/restore_s": recovered["restore_seconds"],
                               "recover/replay_s": recovered["replay_seconds"],
                               "recover/settled_inflight": recovered["settled_inflight"],
                               "recover/recovered_step": recovered["recovered_step"]})
            stats_logger.commit(epoch, epoch_step, global_step,
                                [stats.export(), record, *critic_stats])
            line = {
                "step": global_step + 1, "global_step": global_step, "run_id": run_id,
                "version": actor.get_version(), "n_seqs": int(rewards.size),
                "reward": record["reward"], "adv_abs_mean": record["adv_abs_mean"],
                "loss": [float(s["loss"]) for s in train_stats],
                "critic_loss": [float(s["critic/loss"]) for s in critic_stats],
                "lost_trajectories": record["lost_trajectories"],
                "ledger": dataclasses.asdict(led), "kl_ref": record.get("kl_ref"),
                "eval": evaluated, "timing_s": t,
            }
            if dumped:
                line["recover_dump"] = dumped
            if recovered and global_step == start_step:
                line["recover_load"] = recovered
            stats_out.append(line)
            print(json.dumps(line), flush=True)
            if on_step is not None:
                on_step(global_step, actor, batch, line)
            fault_point("train_step")
            if guard is not None and guard.requested:
                # the step just completed is the dump point: the relaunch
                # loses no step
                preempt_exit(recover, actor, step_info, rollout_engines=(rollout, eval_rollout),
                             dump_kwargs=dump_kwargs)
    finally:
        if close_metrics is not None:
            close_metrics()
        for r in (rollout, eval_rollout):
            if r is not None:
                r.destroy()
        launcher.stop_all()
        shutdown_reward_pool()
        if stats_logger is not None:
            stats_logger.close()
        if guard is not None:
            guard.uninstall()
    return stats_out


def write_init_snapshot(config: GRPOConfig, model: str, device: Optional[str]) -> str:
    """The trainer's v0 snapshot, for servers a launcher starts before
    the trainer: the actor's seeded random masters (`init_params`, seed 0,
    on `device`, as `TorchTrainEngine.initialize` draws them) cast to
    bf16 as a disk publish writes them.  Returns its path."""
    import torch

    from areal_tpu_torch.api.io_struct import WeightUpdateMeta
    from areal_tpu_torch.models.hf import save_hf_checkpoint
    from areal_tpu_torch.models.transformer import init_params

    root = WeightUpdateMeta.from_disk(config.experiment_name, config.trial_name,
                                      resolve_fileroot(config), name="init").path
    path = os.path.join(root, "v0")
    m = init_params(model_config_for(model), seed=0, device=device,
                    param_dtype=config.actor.param_dtype)
    save_hf_checkpoint(m, path, save_dtype="bfloat16")
    del m
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return path


def launch(config: GRPOConfig, args, module: str = "areal_tpu_torch.examples.math.gsm8k_grpo"
           ) -> int:
    """`--launch`: this process starts the servers and runs the trainer,
    `python -m <module>` with the same arguments, through
    `LocalLauncher.run`; returns the last trainer's exit code."""
    from areal_tpu_torch.launcher.local import (
        RECOVER_TIME_INTERVAL,
        LocalLauncher,
        servers_for_allocation,
    )

    from areal_tpu_torch.utils import name_resolve

    run_dir = os.path.join(resolve_fileroot(config), config.experiment_name, config.trial_name)
    # servers and trainer rendezvous in the configured store: the launcher's
    # children inherit it through the env
    name_resolve.export_env(config.cluster.name_resolve)
    server_cfg = dataclasses.replace(config.gen_server)
    if not os.environ.get("AREAL_LLM_SERVER_ADDRS") and not server_cfg.model_path:
        server_cfg.model_path = config.actor.path or write_init_snapshot(
            config, args.model, args.device)
    cmd = [sys.executable, "-m", module, "--model", args.model, "--exit-with-parent"]
    if args.device is not None:
        cmd += ["--device", args.device]
    if args.weight_update_mode is not None:
        cmd += ["--weight-update-mode", args.weight_update_mode]
    cmd += args.overrides
    launcher = LocalLauncher(os.path.join(run_dir, "logs"))
    delay = RECOVER_TIME_INTERVAL if args.relaunch_delay is None else args.relaunch_delay
    return launcher.run(cmd, config.recover, server_cfg,
                        n_servers=servers_for_allocation(config.allocation_mode),
                        device=args.device, relaunch_delay=delay,
                        trainer_timeout=args.trainer_timeout,
                        setup_timeout=config.rollout.setup_timeout,
                        experiment_name=config.experiment_name, trial_name=config.trial_name)


def main(argv: Optional[List[str]] = None, default: Callable[[], GRPOConfig] = default_config,
         module: str = "areal_tpu_torch.examples.math.gsm8k_grpo") -> int:
    """The command line of this example (and, with its `default` config and
    `module`, of `gsm8k_ppo`)."""
    config, args = parse_args(argv, default)
    if args.exit_with_parent:
        from areal_tpu_torch.utils.shutdown import exit_with_parent

        exit_with_parent(os.getppid())
    if args.launch:
        return launch(config, args, module)
    run(config, device=args.device, model=args.model)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
