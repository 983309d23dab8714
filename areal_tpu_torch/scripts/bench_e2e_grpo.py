"""End-to-end GRPO benchmark of the port: async against sync,
trajectories/s/chip, on the colocated or the remote transport.

    python -m areal_tpu_torch.scripts.bench_e2e_grpo                  # Qwen2.5-1.5B on the card
    python -m areal_tpu_torch.scripts.bench_e2e_grpo --device cpu --model tiny
    python -m areal_tpu_torch.scripts.bench_e2e_grpo --transport remote
    python -m areal_tpu_torch.scripts.bench_e2e_grpo --model-path <hf dir>  # any family

The counterpart of `scripts/bench_e2e_grpo.py --transport colocated` and
`--transport remote`.  The RLVR workflow rewards the parity of each
completion's last token in a spawned process pool (`_reward_last_even`,
which varies within a group on random weights, so advantages are not all
0), and the PPO trainer (`TorchPPOActor`: logprob recompute, advantages,
decoupled-PPO update) publishes after every step, in two modes over the
same workload:

- **sync**: rollouts of one batch, then the train step, then the publish;
- **async**: `WorkflowExecutor.prepare_batch` keeps rollouts in flight
  under the staleness gate (`max_head_offpolicyness`) while the trainer
  consumes.

**colocated**: the whole loop runs in one process on one device: the
serving engine is a `ColocatedEngine`; sync trains inside `train_phase()`
(serving parked, its KV cache and weights released) and restages in
memory (`publish_weights`); async publishes with
`update_weights_in_memory` with both sides resident: live (in-flight
requests decode on under the new weights) or, with `--publish-mode
interrupt`, aborted and resubmitted.

**remote**: the server is a process of its own, started by the launch
helper on the same device from the trainer's v0 snapshot, and driven over
HTTP by `RemoteTorchEngine`; each publish is the transfer path: the
trainer streams and stages its bf16 weights while the server generates
(`stage_weights`), then commits (`update_weights`), live or, with
`--publish-mode interrupt`, after an abort.  The pause window is the server's
idle time in the swap (`/metrics last_pause_s`).

Both transports share `_measure_loop`, so the two measure the same thing.
As in the JAX bench, the engine runs with prefix reuse and group fan-out
(`--share-prefix on`, the default: a GRPO group's prompt prefills once and
its K/V is copied to the siblings); `--share-prefix off` keeps per-slot
retained reuse only, for A/B runs (colocated only: the server process,
like the JAX server, has no such flag).  The workload options of the JAX
bench:

- `--len-jitter J`: each prompt gets a log-uniform generation budget in
  [max_new / (1 + J), max_new], the length spread of real math workloads
  that async absorbs and sync pays as a straggler tail;
- `--dataset gsm8k-synth`: the in-repo GSM8K generator, its
  `WordTokenizer` and the real `gsm8k_reward_fn`;
- `--workflow multi_turn --max-turns N`: retry-until-correct episodes
  (`MultiTurnWorkflow`, a grader that accepts about a third of the turns),
  whose later turns ride retained prefix reuse; advantages normalise over
  the batch.

Every mode reports the client's per-request latency distributions
(`latency`: e2e, TTFT and inter-token seconds, p50/p90/p99, warmup
requests left out when the timed window has its own) and its prefill
accounting (`prefill`: cold, suffix, reused and shared tokens, fan-out
copies).  Left out: telemetry, chaos and recovery.

Prints ONE JSON line: {"sync": {...}, "async": {...},
"async_over_sync_trajs_per_sec": R, ...}.
"""

import argparse
import contextlib
import json
import os
import sys
import time
from collections import Counter
from typing import Any, Dict, List

import numpy as np

MODELS = ("qwen2.5-1.5b", "tiny")
# the engine counters of the prefill accounting, per mode
PREFILL_KEYS = ("prefill_tokens", "suffix_tokens", "reused_tokens", "shared_tokens",
                "copy_calls")


class _LatencyRecorder:
    """Per-request client latencies (`ModelResponse.latency` and `.ttft`)
    over a measured mode, for p50/p99 distributions."""

    def __init__(self):
        self.samples = []
        self._mark = 0

    def reset(self):
        self.samples = []
        self._mark = 0

    def mark(self):
        # the warmup boundary: later samples are preferred, the earlier ones
        # stay as a fallback (prepare_batch keeps batches in flight, so a
        # short run may consume only episodes that finished in its warmup)
        self._mark = len(self.samples)

    def record(self, resp):
        self.samples.append((float(resp.latency), float(resp.ttft), int(resp.output_len)))

    def summary(self):
        from areal_tpu_torch.obs.trace import dist_summary

        post = self.samples[self._mark:]
        use = post or self.samples
        if not use:
            return None
        inf = float("inf")
        return {
            "n": len(use),
            "includes_warmup": not post,
            "e2e_s": dist_summary(s[0] for s in use if s[0] != inf),
            "ttft_s": dist_summary(s[1] for s in use if s[1] != inf),
            "inter_token_s": dist_summary(
                (lat - tf) / (n - 1) for lat, tf, n in use if lat != inf and tf != inf and n > 1),
        }


class _RecordingEngine:
    """Engine proxy that forwards everything and records each agenerate."""

    def __init__(self, inner, recorder):
        self._inner = inner
        self._recorder = recorder

    def __getattr__(self, name):
        return getattr(self._inner, name)

    async def agenerate(self, req):
        resp = await self._inner.agenerate(req)
        self._recorder.record(resp)
        return resp


class _RecordingWorkflow:
    """Workflow wrapper that hands its episodes the recording engine; both
    `WorkflowExecutor` and `rollout_batch` drive episodes through
    `workflow.arun_episode(engine, data)`, so it serves every transport and
    mode."""

    def __init__(self, inner, recorder):
        self._inner = inner
        self._recorder = recorder

    def __getattr__(self, name):
        return getattr(self._inner, name)

    async def arun_episode(self, engine, data):
        return await self._inner.arun_episode(_RecordingEngine(engine, self._recorder), data)


def _reward_any_even(prompt, completions, prompt_ids, completion_ids, **kw):
    """Module-level so the reward process pool can pickle it."""
    return float(any(t % 2 == 0 for t in completion_ids))


def _reward_last_even(prompt, completions, prompt_ids, completion_ids, **kw):
    """The parity of the last token.  On random weights `_reward_any_even`
    is 1 for nearly every long completion, so a group's advantages are all
    0 and an update moves nothing; this one varies within a group."""
    return float(bool(completion_ids) and completion_ids[-1] % 2 == 0)


def _reward_mt(prompt, completions, prompt_ids, completion_ids, **kw):
    """The multi-turn grader: about a third of the turns "solve" the task,
    so episodes span 1..max_turns turns."""
    return float(sum(completion_ids) % 3 == 0)


class _FakeTokenizer:
    """Just enough of a tokenizer for MultiTurnWorkflow on token prompts."""

    def decode(self, tokens):
        return " ".join(str(t) for t in tokens)

    def encode(self, text, add_special_tokens=False):
        return [3] * 6  # a fixed-size feedback suffix

    def apply_chat_template(self, messages, add_generation_prompt=True, tokenize=True):
        raise NotImplementedError("the bench feeds token prompts")


def _make_actor(model: str, max_seq_len: int, group_size: int, batch_norm: bool = False,
                model_path: str = "", device=None, lr: float = 1e-6):
    """(actor, model config): `tiny` runs f32 throughout, every other model
    trains f32 masters with bf16 compute.  With a `model_path` the config
    comes from its `config.json` (any family the port runs; `model` is then
    a label that picks the dtype) and the weights from its checkpoint;
    without one `model` names the config (`qwen2.5-1.5b` or `tiny`) and the
    weights are random (seed 0)."""
    from areal_tpu_torch.api.config import (
        MicroBatchSpec,
        NormConfig,
        OptimizerConfig,
        PPOActorConfig,
    )
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.engine.ppo import TorchPPOActor
    from areal_tpu_torch.models.model_config import TransformerConfig, qwen25_1p5b, tiny_config

    if model_path:
        cfg = TransformerConfig.from_hf(model_path)
    elif model == "qwen2.5-1.5b":
        cfg = qwen25_1p5b()
    else:
        cfg = tiny_config(vocab_size=512, qkv_bias=True, hf_architecture="Qwen2ForCausalLM")
    dtype = "float32" if model == "tiny" else "bfloat16"
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
    return actor, cfg


def _make_parts(model: str, n_slots: int, max_seq_len: int, group_size: int,
                batch_norm: bool = False, model_path: str = "", device=None,
                lr: float = 1e-6, share_prefix: bool = True):
    """(actor, serving, model config): the trainer and a colocated engine
    serving copies of its weights (bf16 at full width), with group fan-out
    when `share_prefix`."""
    from areal_tpu_torch.engine.colocated import ColocatedEngine

    actor, cfg = _make_actor(model, max_seq_len, group_size, batch_norm, model_path,
                             device, lr)
    serving = ColocatedEngine(
        cfg,
        params=actor.export_device_params(),
        n_slots=n_slots,
        max_seq_len=max_seq_len,
        prompt_bucket=128,
        decode_chunk=8,
        kv_dtype=cfg.dtype,
        device=actor.device,
        share_prefix=share_prefix,
    )
    return actor, serving, cfg


def _make_remote_parts(actor, cfg, n_slots: int, max_seq_len: int, run_dir: str):
    """A launcher running one port server from the trainer's v0 snapshot
    (in the serving dtype), on the trainer's device, with
    AREAL_LLM_SERVER_ADDRS exported.  The caller stops it."""
    from areal_tpu_torch.api.config import GenServerConfig
    from areal_tpu_torch.launcher.local import LocalLauncher
    from areal_tpu_torch.models.hf import save_hf_checkpoint

    v0 = os.path.join(run_dir, "v0")
    save_hf_checkpoint(actor.model, v0, save_dtype=cfg.dtype)
    launcher = LocalLauncher(os.path.join(run_dir, "logs"))
    launcher.start_gen_servers(
        GenServerConfig(model_path=v0, dtype=cfg.dtype, max_seqs=n_slots,
                        max_context_len=max_seq_len, page_size=128, random_seed=0),
        device=actor.device.type)
    return launcher


def server_metrics(addr: str) -> Dict[str, Any]:
    from areal_tpu_torch.utils.http import request_with_retry

    return request_with_retry(addr, "/metrics", method="GET", timeout=60)


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
                  train_phase=contextlib.nullcontext, recorder=None):
    """The timed region shared by both modes: rollout -> train (inside
    `train_phase()`) -> version bump -> publish, with the warmup steps
    outside the timed window (and, with a `recorder`, outside the latency
    distributions when the timed steps have requests of their own)."""
    trajs = tokens = 0
    pauses: List[float] = []
    rewards: List[float] = []
    adv_abs: List[float] = []
    rollout_s: List[float] = []
    train_s: List[float] = []
    losses: List[float] = []
    lags: Counter = Counter()
    ahead = -(1 << 30)
    gap_sum, gap_n = 0.0, 0
    t_start = None
    if recorder is not None:
        recorder.reset()
    for step in range(warmup + steps):
        if step == warmup:
            _sync(actor)
            trajs = tokens = 0
            pauses, rewards, adv_abs, rollout_s, train_s = [], [], [], [], []
            if recorder is not None:
                recorder.mark()
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
        adv_abs.append(float(np.abs(batch["advantages"]).mean()))
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
        # mean |advantage| per step: 0 when every group's rewards tie
        "adv_abs_mean": adv_abs,
        "rollout_s": rollout_s,
        "train_s": train_s,
        "loss_trajectory": losses,
        # over every consumed trajectory, warmup included
        "version_lag_hist": {int(k): int(n) for k, n in sorted(lags.items())},
        "max_version_ahead": ahead,
        "same_version_logp_gap_mean": gap_sum / max(gap_n, 1),
        "same_version_tokens": gap_n,
        "latency": recorder.summary() if recorder is not None else None,
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


def _prefill_delta(before: Dict[str, Any], after: Dict[str, Any]) -> Dict[str, int]:
    return {k: int(after[k]) - int(before[k]) for k in PREFILL_KEYS}


def run_mode(mode: str, actor, serving, workflow, dataset, batch_size: int,
             steps: int, warmup: int = 1, interrupt_publish: bool = False,
             max_head_offpolicyness: int = 4, recorder=None) -> Dict[str, Any]:
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
    stats0 = dict(serving.engine.stats)
    try:
        # sync: serving parked and released while the trainer steps
        result = _measure_loop(
            mode, actor, get_batch, publish, steps, warmup,
            train_phase=serving.train_phase if mode == "sync" else contextlib.nullcontext,
            recorder=recorder)
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
    result["prefill"] = _prefill_delta(stats0, serving.engine.stats)  # warmup included
    result["export_s"] = export_s[-result["steps"]:]  # the timed steps
    result["publish"] = ("release" if mode == "sync"
                         else "interrupt" if interrupt_publish else "live")
    result["reward_timeouts"] = workflow.reward_fn.timeouts - timeouts
    result["reward_failures"] = workflow.reward_fn.failures - failures
    return result


def run_mode_remote(mode: str, actor, meta, workflow, dataset, batch_size: int,
                    steps: int, warmup: int = 1, max_head_offpolicyness: int = 4,
                    recorder=None) -> Dict[str, Any]:
    """The remote counterpart of `run_mode`: rollouts over HTTP through a
    fresh `RemoteTorchEngine` (its versions counted from this mode's
    start, as the staleness gate assumes), and each publish the trainer's
    `stage_weights` while the servers generate, then the commit:
    `update_weights` on the trainer and the client, inside a client pause
    unless the commit is live.  The pause window is the server's
    `last_pause_s`; stage and commit are timed apart."""
    from areal_tpu_torch.api.config import InferenceEngineConfig
    from areal_tpu_torch.engine.torch_remote import RemoteTorchEngine
    from areal_tpu_torch.utils.dataloader import StatefulDataLoader

    if mode not in ("sync", "async"):
        raise ValueError(f"mode {mode!r}: use sync or async")
    client = RemoteTorchEngine(InferenceEngineConfig(
        consumer_batch_size=batch_size, max_concurrent_rollouts=batch_size * 2,
        max_head_offpolicyness=max_head_offpolicyness))
    client.initialize()
    addr = client.addresses[0]
    dataloader = StatefulDataLoader(dataset, batch_size=batch_size, seed=0)
    data_iter = iter(np.random.default_rng(1).permutation(len(dataset)))

    def get_batch():
        if mode == "async":
            return client.prepare_batch(dataloader, workflow=workflow)
        items = [dataset[int(next(data_iter)) % len(dataset)] for _ in range(batch_size)]
        return client.rollout_batch(items, workflow=workflow)

    origin = actor.get_version()
    live = meta.type == "transfer" and meta.live_commit
    stage_s: List[float] = []
    commit_s: List[float] = []

    def publish():
        version = actor.get_version() + 1
        actor.set_version(version)
        t0 = time.perf_counter()
        actor.stage_weights(meta)
        t1 = time.perf_counter()
        if not live:
            client.pause()
        actor.update_weights(meta)
        client.update_weights(meta)
        client.set_version(version - origin)
        if not live:
            client.resume()
        commit_s.append(time.perf_counter() - t1)
        stage_s.append(t1 - t0)
        return float(server_metrics(addr)["last_pause_s"])

    timeouts, failures = workflow.reward_fn.timeouts, workflow.reward_fn.failures
    stats0 = server_metrics(addr)
    try:
        result = _measure_loop(mode, actor, get_batch, publish, steps, warmup,
                               recorder=recorder)
        st = client.executor.staleness_manager.get_stats()
        result["ledger"] = {"submitted": st.submitted, "accepted": st.accepted,
                            "rejected": st.rejected, "running": st.running}
        result["lost_trajectories"] = client.executor.lost_trajectories
    finally:
        client.destroy()
    # rollouts still in flight belonged to this mode: let the server finish
    # them before the next mode starts
    deadline = time.monotonic() + 600
    while server_metrics(addr)["active"]:
        if time.monotonic() > deadline:
            raise TimeoutError("the server did not drain the mode's requests")
        time.sleep(0.1)
    result["prefill"] = _prefill_delta(stats0, server_metrics(addr))  # warmup included
    result["stage_s"] = stage_s[-result["steps"]:]
    result["commit_s"] = commit_s[-result["steps"]:]
    result["publish"] = (meta.type if meta.type == "disk"
                         else "transfer-live" if live else "transfer-abort")
    result["server_version"] = int(server_metrics(addr)["version"])
    result["reward_timeouts"] = workflow.reward_fn.timeouts - timeouts
    result["reward_failures"] = workflow.reward_fn.failures - failures
    return result


def make_dataset(n: int, vocab_size: int, prompt_len: int, prompt_len_min: int = 0,
                 seed: int = 0, len_jitter: float = 0.0,
                 max_new_tokens: int = 0) -> List[Dict[str, Any]]:
    """`n` random prompts, of `prompt_len` tokens or, with `prompt_len_min`,
    of lengths drawn uniformly from [prompt_len_min, prompt_len].  With
    `len_jitter` J > 0 each item also carries a generation budget drawn
    log-uniformly from [max_new_tokens / (1 + J), max_new_tokens]."""
    rng = np.random.default_rng(seed)
    lo = prompt_len_min or prompt_len
    out = []
    for i in range(n):
        item = {"input_ids": rng.integers(0, vocab_size, int(rng.integers(lo, prompt_len + 1))
                                          ).tolist(),
                "query_id": str(i)}
        if len_jitter > 0:
            low = max_new_tokens / (1.0 + len_jitter)
            item["max_new_tokens"] = int(np.exp(rng.uniform(np.log(low),
                                                            np.log(max_new_tokens))))
        out.append(item)
    return out


def make_gsm8k_dataset(n: int, vocab_size: int):
    """(items, tokenizer): `n` gsm8k-synth problems as token prompts of the
    `WordTokenizer`'s chat template, with their answers."""
    from areal_tpu_torch.dataset.gsm8k_synth import WordTokenizer, generate_problems

    tok = WordTokenizer()
    if len(tok) > vocab_size:
        raise ValueError(f"model vocab {vocab_size} < tokenizer {len(tok)}")
    return [{"input_ids": tok.apply_chat_template(p["messages"], add_generation_prompt=True),
             "query_id": p["query_id"], "answer": p["answer"]}
            for p in generate_problems(n, seed=0)], tok


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="qwen2.5-1.5b", choices=MODELS)
    p.add_argument("--model-path", default="",
                   help="HF checkpoint the trainer starts from; its config.json sets the "
                        "model, --model then only the dtype (default: random weights)")
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
    p.add_argument("--transport", default="colocated", choices=["colocated", "remote"])
    p.add_argument("--publish-mode", default="live", choices=["live", "interrupt"],
                   help="live swap, or abort and resubmit: the colocated async publish "
                        "(sync always releases serving memory for the train step) and the "
                        "remote transfer commit")
    p.add_argument("--run-dir", default="",
                   help="remote: the v0 snapshot and the server's log "
                        "(default: build/bench_e2e_grpo under the checkout)")
    p.add_argument("--share-prefix", default="on", choices=["on", "off"],
                   help="off = per-slot retained reuse only (no group fan-out), for A/B "
                        "runs; colocated only")
    p.add_argument("--len-jitter", type=float, default=0.0,
                   help=">0 gives each prompt a log-uniform generation budget in "
                        "[max_new/(1+j), max_new]")
    p.add_argument("--dataset", default="random", choices=["random", "gsm8k-synth"],
                   help="random token prompts, or the gsm8k-synth generator with its "
                        "WordTokenizer and gsm8k_reward_fn")
    p.add_argument("--workflow", default="rlvr", choices=["rlvr", "multi_turn"],
                   help="multi_turn = retry-until-correct episodes (rides prefix reuse)")
    p.add_argument("--max-turns", type=int, default=3)
    args = p.parse_args(argv)
    if args.dataset == "gsm8k-synth" and args.workflow != "rlvr":
        p.error("--dataset gsm8k-synth runs the RLVR workflow (its reward parses "
                "\\boxed{} answers, not multi-turn feedback)")
    if args.workflow == "multi_turn" and args.len_jitter > 0:
        # MultiTurnWorkflow generates with its fixed budget: per-item budgets
        # would be ignored while the result claimed a jittered run
        p.error("--len-jitter is not supported with --workflow multi_turn")
    if args.transport == "remote" and args.share_prefix == "off":
        p.error("--share-prefix off needs --transport colocated: the server process "
                "runs the engine's defaults (reuse and sharing on) and has no such flag")

    from areal_tpu_torch.api.config import GenerationHyperparameters
    from areal_tpu_torch.api.io_struct import WeightUpdateMeta
    from areal_tpu_torch.api.reward import prewarm_reward_pool, shutdown_reward_pool
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    remote = args.transport == "remote"
    multi_turn = args.workflow == "multi_turn"
    serving = launcher = None
    if remote:
        actor, cfg = _make_actor(args.model, args.max_seq_len, args.group_size,
                                 batch_norm=multi_turn, model_path=args.model_path,
                                 device=args.device)
    else:
        actor, serving, cfg = _make_parts(
            args.model, args.n_slots, args.max_seq_len, args.group_size,
            batch_norm=multi_turn, model_path=args.model_path, device=args.device,
            share_prefix=args.share_prefix == "on")
    gconfig = GenerationHyperparameters(n_samples=args.group_size,
                                        max_new_tokens=args.max_new_tokens, temperature=1.0)
    if args.dataset == "gsm8k-synth":
        from areal_tpu_torch.reward import gsm8k_reward_fn

        dataset, tokenizer = make_gsm8k_dataset(256, cfg.vocab_size)
        workflow = RLVRWorkflow(reward_fn=gsm8k_reward_fn, gconfig=gconfig,
                                tokenizer=tokenizer)
    elif multi_turn:
        from areal_tpu_torch.workflow.multi_turn import MultiTurnWorkflow

        dataset = make_dataset(256, cfg.vocab_size, args.prompt_len, args.prompt_len_min)
        # one trajectory per episode (the workflow samples one per turn):
        # advantages normalise over the batch
        workflow = MultiTurnWorkflow(reward_fn=_reward_mt, gconfig=gconfig,
                                     tokenizer=_FakeTokenizer(), max_turns=args.max_turns)
    else:
        dataset = make_dataset(256, cfg.vocab_size, args.prompt_len, args.prompt_len_min,
                               len_jitter=args.len_jitter, max_new_tokens=args.max_new_tokens)
        workflow = RLVRWorkflow(reward_fn=_reward_last_even, gconfig=gconfig)
    recorder = _LatencyRecorder()
    workflow = _RecordingWorkflow(workflow, recorder)
    result: Dict[str, Any] = {
        "model": args.model,
        "architecture": cfg.hf_architecture,
        "transport": args.transport,
        "device": str(actor.device),
        "workflow": args.workflow,
        "dataset": args.dataset,
        "batch_size": args.batch_size,
        "group_size": args.group_size,
        "max_new_tokens": args.max_new_tokens,
        "len_jitter": args.len_jitter,
        "publish_mode": args.publish_mode,
        "share_prefix": args.share_prefix,
    }
    try:
        if remote:
            run_dir = args.run_dir or os.path.join(
                os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                "build", "bench_e2e_grpo")
            launcher = _make_remote_parts(actor, cfg, args.n_slots, args.max_seq_len, run_dir)
            meta = WeightUpdateMeta.from_transfer(live_commit=args.publish_mode == "live")
        prewarm_reward_pool()
        for mode in args.modes.split(","):
            if remote:
                result[mode] = run_mode_remote(mode, actor, meta, workflow, dataset,
                                               args.batch_size, args.steps, warmup=args.warmup,
                                               recorder=recorder)
            else:
                result[mode] = run_mode(
                    mode, actor, serving, workflow, dataset, args.batch_size, args.steps,
                    warmup=args.warmup, interrupt_publish=args.publish_mode == "interrupt",
                    recorder=recorder)
        if "sync" in result and "async" in result:
            result["async_over_sync_trajs_per_sec"] = (
                result["async"]["trajs_per_sec_per_chip"]
                / result["sync"]["trajs_per_sec_per_chip"])
        # the whole run's prefill accounting, as the JAX bench reports it
        st = (server_metrics(launcher.server_addrs[0]) if remote
              else serving.engine.stats)
        total = sum(int(st[k]) for k in PREFILL_KEYS if k != "copy_calls")
        acct = {k: int(st[k]) for k in PREFILL_KEYS}
        if multi_turn:
            result["kv_reuse"] = dict(acct, reused_fraction=acct["reused_tokens"] / max(total, 1))
        if args.group_size > 1:
            result["shared_prefill"] = dict(
                acct, shared_fraction=acct["shared_tokens"] / max(total, 1))
        print(json.dumps(result), flush=True)
    finally:
        if serving is not None:
            serving.destroy()
        if launcher is not None:
            launcher.stop_all()
        shutdown_reward_pool()
    return 0


if __name__ == "__main__":
    sys.exit(main())
