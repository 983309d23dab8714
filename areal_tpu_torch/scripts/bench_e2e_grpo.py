"""End-to-end GRPO benchmark of the port: async against sync,
trajectories/s/chip, on the colocated transport.

    python -m areal_tpu_torch.scripts.bench_e2e_grpo                  # Qwen2.5-1.5B on the card
    python -m areal_tpu_torch.scripts.bench_e2e_grpo --device cpu --model tiny

The counterpart of `scripts/bench_e2e_grpo.py --transport colocated`.  The
whole loop runs in one process on one device: the serving engine
(`ColocatedEngine`), the RLVR workflow with the parity reward in a spawned
process pool, the PPO trainer (`TorchPPOActor`: logprob recompute,
advantages, decoupled-PPO update) and a weight publish after every step,
in two modes over the same workload:

- **sync**: `rollout_batch`, then the train step inside `train_phase()`
  (serving parked, its KV cache and weights released), then
  `publish_weights` (the in-memory restage);
- **async**: `WorkflowExecutor.prepare_batch` keeps rollouts in flight
  under the staleness gate (`max_head_offpolicyness`) while the trainer
  consumes; each publish is `update_weights_in_memory` with both sides
  resident: live (in-flight requests decode on under the new weights) or,
  with `--publish-mode interrupt`, aborted and resubmitted.

The port has no prefix sharing or group fan-out yet, so this is the JAX
bench's `--share-prefix off`.  Left out: the remote transport, multi-turn
workflows, the gsm8k-synth dataset mode, latency percentiles, telemetry
and recovery.

Prints ONE JSON line: {"sync": {...}, "async": {...},
"async_over_sync_trajs_per_sec": R, ...}.
"""

import argparse
import contextlib
import json
import sys
import time
from collections import Counter
from typing import Any, Dict, List

import numpy as np

MODELS = ("qwen2.5-1.5b", "tiny")


def _reward_any_even(prompt, completions, prompt_ids, completion_ids, **kw):
    """Module-level so the reward process pool can pickle it."""
    return float(any(t % 2 == 0 for t in completion_ids))


def _reward_last_even(prompt, completions, prompt_ids, completion_ids, **kw):
    """The parity of the last token.  On random weights `_reward_any_even`
    is 1 for nearly every long completion, so a group's advantages are all
    0 and an update moves nothing; this one varies within a group."""
    return float(bool(completion_ids) and completion_ids[-1] % 2 == 0)


def _make_parts(model: str, n_slots: int, max_seq_len: int, group_size: int,
                batch_norm: bool = False, model_path: str = "", device=None,
                lr: float = 1e-6):
    """(actor, serving, model config): the trainer and a colocated engine
    serving copies of its weights.  `qwen2.5-1.5b` trains f32 masters with
    bf16 compute and serves bf16; `tiny` runs f32 throughout.  Without a
    `model_path` the weights are random (seed 0)."""
    from areal_tpu_torch.api.config import (
        MicroBatchSpec,
        NormConfig,
        OptimizerConfig,
        PPOActorConfig,
    )
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.engine.colocated import ColocatedEngine
    from areal_tpu_torch.engine.ppo import TorchPPOActor
    from areal_tpu_torch.models.model_config import qwen25_1p5b, tiny_config

    if model == "qwen2.5-1.5b":
        cfg = qwen25_1p5b()
    else:
        cfg = tiny_config(vocab_size=512, qkv_bias=True, hf_architecture="Qwen2ForCausalLM")
    dtype = "bfloat16" if model == "qwen2.5-1.5b" else "float32"
    cfg = cfg.replace(eos_token_id=None, dtype=dtype)
    actor = TorchPPOActor(
        PPOActorConfig(
            path=model_path,
            init_from_scratch=not model_path,
            dtype=dtype,
            param_dtype="float32",
            gradient_checkpointing=True,
            remat_policy="full",
            mb_spec=MicroBatchSpec(n_mbs=1),
            optimizer=OptimizerConfig(lr=lr, warmup_steps_proportion=0.0),
            pack_length_quantum=256,
            max_pack_length=max_seq_len,
            group_size=group_size,
            ppo_n_minibatches=1,
            use_decoupled_loss=True,
            recompute_logprob=True,
            adv_norm=(
                NormConfig(mean_level="batch", std_level="batch") if batch_norm
                else NormConfig(mean_level="group", std_level="group",
                                group_size=group_size)
            ),
        ),
        model_config=cfg,
        device=device,
    )
    actor.initialize(ft_spec=FinetuneSpec(1, 4096, 8))
    serving = ColocatedEngine(
        cfg,
        params=actor.export_device_params(),
        n_slots=n_slots,
        max_seq_len=max_seq_len,
        prompt_bucket=128,
        decode_chunk=8,
        kv_dtype=dtype,
        device=actor.device,
    )
    return actor, serving, cfg


def _sync(actor) -> None:
    import torch

    if actor.device.type == "cuda":
        torch.cuda.synchronize(actor.device)


def same_version_logp_gap(batch: Dict[str, np.ndarray], version: int):
    """(sum of |trainer - behaviour| logprob, tokens) over the completion
    tokens generated under `version`.  `batch["prox_logp"]` is
    predictor-aligned (column t scores token t + 1), the behaviour
    `logprobs` and `versions` token-aligned."""
    take = (batch["loss_mask"] > 0) & (batch["versions"] == version)
    take = np.roll(take, -1, axis=-1)
    take[:, -1] = False
    behaviour = np.roll(batch["logprobs"], -1, axis=-1)
    gap = np.abs(batch["prox_logp"] - behaviour)[take]
    return float(gap.sum()), int(take.sum())


def _train_consume(actor, batch):
    """prox_logp <- compute_logp, then compute_advantages, then ppo_update.
    Returns (per-minibatch stats, same_version_logp_gap at the trainer's
    version)."""
    batch["prox_logp"] = actor.compute_logp(batch)
    gap = same_version_logp_gap(batch, actor.get_version())
    actor.compute_advantages(batch)
    return actor.ppo_update(batch), gap


def _batch_tokens(batch) -> int:
    return int(np.asarray(batch["attention_mask"]).sum())


def _version_lag(batch, version: int):
    """Per trajectory: trainer version minus the oldest token version, and
    the newest token version minus the trainer's (> 0 = from the future)."""
    v = np.asarray(batch["versions"])
    out = np.asarray(batch["loss_mask"]) > 0  # completion tokens (not prompt or pad)
    oldest = np.where(out, v, np.iinfo(np.int32).max).min(-1)
    newest = np.where(out, v, -1).max(-1)
    return (version - oldest).tolist(), int((newest - version).max())


def _measure_loop(mode: str, actor, get_batch, publish, steps: int, warmup: int,
                  train_phase=contextlib.nullcontext):
    """The timed region shared by both modes: rollout -> train (inside
    `train_phase()`) -> version bump -> publish, with the warmup steps
    outside the timed window."""
    trajs = tokens = 0
    pauses: List[float] = []
    rewards: List[float] = []
    rollout_s: List[float] = []
    train_s: List[float] = []
    losses: List[float] = []
    lags: Counter = Counter()
    ahead = -(1 << 30)
    gap_sum, gap_n = 0.0, 0
    t_start = None
    for step in range(warmup + steps):
        if step == warmup:
            _sync(actor)
            trajs = tokens = 0
            pauses, rewards, rollout_s, train_s = [], [], [], []
            t_start = time.perf_counter()
        t0 = time.perf_counter()
        batch = get_batch()
        t1 = time.perf_counter()
        trajs += int(np.asarray(batch["attention_mask"]).shape[0])
        tokens += _batch_tokens(batch)
        rewards.append(float(np.asarray(batch["rewards"]).mean()))
        lag, newest = _version_lag(batch, actor.get_version())
        lags.update(lag)
        ahead = max(ahead, newest)
        with train_phase():
            stats, (gs, gn) = _train_consume(actor, batch)
            _sync(actor)
        t2 = time.perf_counter()
        gap_sum, gap_n = gap_sum + gs, gap_n + gn
        losses += [float(st["loss"]) for st in stats]
        rollout_s.append(t1 - t0)
        train_s.append(t2 - t1)
        pauses.append(publish())
        print(f"{mode} step {step}: trajs={trajs} tokens={tokens} rollout "
              f"{t1 - t0:.3f} s train {t2 - t1:.3f} s pause {pauses[-1]:.4f} s",
              file=sys.stderr, flush=True)
    _sync(actor)
    wall = time.perf_counter() - t_start
    return {
        "steps": steps,
        "trajectories": trajs,
        "effective_tokens": tokens,
        "wall_s": wall,
        "trajs_per_sec_per_chip": trajs / wall,
        "effective_tokens_per_sec_per_chip": tokens / wall,
        "pause_window_s_mean": float(np.mean(pauses)),
        "pause_window_s": pauses,
        "reward_mean": float(np.mean(rewards)),
        "rollout_s": rollout_s,
        "train_s": train_s,
        "loss_trajectory": losses,
        # over every consumed trajectory, warmup included
        "version_lag_hist": {int(k): int(n) for k, n in sorted(lags.items())},
        "max_version_ahead": ahead,
        "same_version_logp_gap_mean": gap_sum / max(gap_n, 1),
        "same_version_tokens": gap_n,
    }


class _VersionsFrom:
    """The serving engine with versions counted from `origin`, as a fresh
    executor must see it: the staleness gate's formula assumes its run
    started at version 0, so a mode that starts after another would
    otherwise inherit that mode's versions as extra staleness budget."""

    def __init__(self, inner, origin: int):
        self._inner = inner
        self._origin = origin

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def get_version(self) -> int:
        return self._inner.get_version() - self._origin


def run_mode(mode: str, actor, serving, workflow, dataset, batch_size: int,
             steps: int, warmup: int = 1, interrupt_publish: bool = False,
             max_head_offpolicyness: int = 4) -> Dict[str, Any]:
    """One mode over `warmup + steps` steps; see the module docstring."""
    from areal_tpu_torch.api.config import InferenceEngineConfig
    from areal_tpu_torch.core.executor import WorkflowExecutor
    from areal_tpu_torch.utils.dataloader import StatefulDataLoader

    executor = None
    if mode == "async":
        executor = WorkflowExecutor(
            InferenceEngineConfig(
                consumer_batch_size=batch_size,
                max_concurrent_rollouts=batch_size * 2,
                max_head_offpolicyness=max_head_offpolicyness,
            ),
            _VersionsFrom(serving, serving.get_version()),
        )
        executor.initialize()
        dataloader = StatefulDataLoader(dataset, batch_size=batch_size, seed=0)
    elif mode != "sync":
        raise ValueError(f"mode {mode!r}: use sync or async")

    data_iter = iter(np.random.default_rng(1).permutation(len(dataset)))

    def get_batch():
        if mode == "async":
            return executor.prepare_batch(dataloader, workflow=workflow)
        items = [dataset[int(next(data_iter)) % len(dataset)] for _ in range(batch_size)]
        return serving.rollout_batch(items, workflow=workflow)

    state = {"version": serving.get_version()}
    export_s: List[float] = []

    def publish():
        """-> the generation-idle window; the export (the serving copy,
        made while decoding goes on in async) is timed apart."""
        state["version"] += 1
        actor.set_version(state["version"])
        t0 = time.perf_counter()
        model = actor.export_device_params()
        _sync(actor)
        export_s.append(time.perf_counter() - t0)
        if mode == "sync":
            # serving was released for the train step: restage in memory
            t0 = time.perf_counter()
            serving.publish_weights(model, state["version"])
            return time.perf_counter() - t0
        return serving.update_weights_in_memory(model, state["version"],
                                                interrupt=interrupt_publish)

    timeouts, failures = workflow.reward_fn.timeouts, workflow.reward_fn.failures
    try:
        # sync: serving parked and released while the trainer steps
        result = _measure_loop(
            mode, actor, get_batch, publish, steps, warmup,
            train_phase=serving.train_phase if mode == "sync" else contextlib.nullcontext)
        if executor is not None:
            st = executor.staleness_manager.get_stats()
            result["ledger"] = {"submitted": st.submitted, "accepted": st.accepted,
                                "rejected": st.rejected, "running": st.running}
    finally:
        if executor is not None:
            executor.destroy()
        # requests still in flight belong to this mode's executor
        serving.stop_serving()
        serving.engine.abort_all("abort")
    result["export_s"] = export_s[-result["steps"]:]  # the timed steps
    result["publish"] = ("release" if mode == "sync"
                         else "interrupt" if interrupt_publish else "live")
    result["reward_timeouts"] = workflow.reward_fn.timeouts - timeouts
    result["reward_failures"] = workflow.reward_fn.failures - failures
    return result


def make_dataset(n: int, vocab_size: int, prompt_len: int, prompt_len_min: int = 0,
                 seed: int = 0) -> List[Dict[str, Any]]:
    """`n` random prompts, of `prompt_len` tokens or, with `prompt_len_min`,
    of lengths drawn uniformly from [prompt_len_min, prompt_len]."""
    rng = np.random.default_rng(seed)
    lo = prompt_len_min or prompt_len
    return [{"input_ids": rng.integers(0, vocab_size, int(rng.integers(lo, prompt_len + 1))
                                       ).tolist(),
             "query_id": str(i)} for i in range(n)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="qwen2.5-1.5b", choices=MODELS)
    p.add_argument("--model-path", default="",
                   help="HF checkpoint the trainer starts from (default: random weights)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a card only cpu runs")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=8, help="prompts per step")
    p.add_argument("--group-size", type=int, default=4, help="samples per prompt")
    p.add_argument("--n-slots", type=int, default=32)
    p.add_argument("--max-seq-len", type=int, default=1024)
    p.add_argument("--prompt-len", type=int, default=256)
    p.add_argument("--prompt-len-min", type=int, default=64,
                   help="prompt lengths are uniform in [min, --prompt-len]")
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--modes", default="sync,async")
    p.add_argument("--publish-mode", default="live", choices=["live", "interrupt"],
                   help="async publish: live swap, or abort and resubmit (sync "
                        "always releases serving memory for the train step)")
    args = p.parse_args(argv)

    from areal_tpu_torch.api.config import GenerationHyperparameters
    from areal_tpu_torch.api.reward import prewarm_reward_pool, shutdown_reward_pool
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    actor, serving, cfg = _make_parts(
        args.model, args.n_slots, args.max_seq_len, args.group_size,
        model_path=args.model_path, device=args.device)
    prewarm_reward_pool()
    workflow = RLVRWorkflow(
        reward_fn=_reward_any_even,
        gconfig=GenerationHyperparameters(
            n_samples=args.group_size, max_new_tokens=args.max_new_tokens, temperature=1.0),
    )
    dataset = make_dataset(256, cfg.vocab_size, args.prompt_len, args.prompt_len_min)
    result: Dict[str, Any] = {
        "model": args.model,
        "transport": "colocated",
        "device": str(actor.device),
        "batch_size": args.batch_size,
        "group_size": args.group_size,
        "max_new_tokens": args.max_new_tokens,
        "publish_mode": args.publish_mode,
        "share_prefix": "off",
    }
    try:
        for mode in args.modes.split(","):
            result[mode] = run_mode(
                mode, actor, serving, workflow, dataset, args.batch_size, args.steps,
                warmup=args.warmup, interrupt_publish=args.publish_mode == "interrupt")
        if "sync" in result and "async" in result:
            result["async_over_sync_trajs_per_sec"] = (
                result["async"]["trajs_per_sec_per_chip"]
                / result["sync"]["trajs_per_sec_per_chip"])
        print(json.dumps(result), flush=True)
    finally:
        serving.destroy()
        shutdown_reward_pool()
    return 0


if __name__ == "__main__":
    sys.exit(main())
