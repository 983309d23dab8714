"""TorchTrainEngine: the training backend (the port of
`areal_tpu/engine/jax_train.py JaxTrainEngine`), on one device or over a
(dp, sp) mesh of ranks.

- Parameters are `param_dtype` masters (f32 by default) in the port's
  `Transformer`; the forward computes in `dtype` (bf16 by default),
  casting each weight at use, with `torch.utils.checkpoint` around each
  layer when `gradient_checkpointing` is set (the `full` rung).
- Batches use the row-packed layout (`utils/data.py pack_into_rows`):
  rows of a power-of-two multiple of `pack_length_quantum` tokens, a
  power-of-two row count divisible by the micro-batch count.
- `train_batch` follows the reference's loss protocol: `loss_fn(model_out,
  mb) -> (sum_loss, stats_sums)`, `loss_weight_fn(batch) -> float`; each
  micro-batch's loss is divided by the summed weight of the whole batch
  and its gradient accumulates in the parameters' dtype.  Then one
  optimizer step, written out as optax's `clip_by_global_norm` followed by
  `adamw` (weight decay masked as the JAX engine's, see `decays`) at the
  warmup/cosine/linear schedule evaluated at the pre-increment step.
- Weights are published in two halves, as the JAX engine does:
  `stage_weights` runs the expensive half while the servers go on
  generating, `update_weights` the commit (and the whole publish when
  nothing was staged for this version).  "disk": a bf16 HF snapshot
  staged in `.tmp-v{N}-{pid}` and renamed to `v{N}`, the newest two kept,
  and the version's `names.update_weights_from_disk` key in name_resolve,
  where a router's checkpoint watcher finds it; servers reload the
  snapshot on `/update_weights_from_disk`.  "transfer": every HF-named
  tensor in bf16, in the JAX engine's order and pieces of at most
  `chunk_mb` MiB, streamed to every server's `/update_weights_chunk`
  (`AREAL_LLM_SERVER_ADDRS`, else the servers registered in name_resolve
  under the meta's experiment and trial), then `prepare`; the commit swaps
  them in, live or after an abort, and a router registered for the
  experiment is told the version (`/set_version`, fire-and-forget: a stale
  address never stalls a publish).  The commit's wall time lands in
  `last_weight_update_seconds`.
  `export_device_params` is the colocated in-memory publish: copies of
  the masters in the compute dtype, on the card, for an engine in the same
  process (`engine/colocated.py`).
- `save` writes the weights as an HF safetensors dir through the port's
  writer: the f32 masters with `with_optim` (a recover checkpoint), the
  bf16 cast otherwise (an export).  With `with_optim` it also writes
  AdamW's state into `optimizer/`: `mu` and `nu` keyed by parameter name
  (`mu/<name>`, `nu/<name>` in `adamw*.safetensors` shards) and
  `adamw_state.json` with the update count, which is the schedule's
  position and the bias correction's exponent.  The reference writes the
  optimizer state with orbax; the port has no orbax, and keying by name
  keeps the moments with their parameters (and their decay mask) whatever
  order the parameters are listed in.  `load` restores all of it in
  place, so the next update is bit-identical to an uninterrupted one.

`train_batch` strips a batch's `trace_keys` (the rollout's telemetry
hash) before packing; with telemetry on it observes each row's
staleness at consumption (the trainer's version minus the row's newest
behaviour version) and emits a `train_consume` event per row.

Multi-process (`parallel/`): `initialize` joins the process group under
the env contract of `parallel/distributed.py` (nothing with one process),
puts the rank on its device and builds the mesh of `config.mesh` (dp and
sp; fsdp, tp and ep raise).  The head's parameters are broadcast, so
every rank starts bit-equal.  Every rank holds the same whole host batch
(the head's rollout, broadcast by `core/dist_rollout.py`); packing
rounds the row count to a multiple of n_mbs x dp, as the JAX engine
does, and each micro-batch's device batch is the rank's shard: rows over
dp, sequence over sp.  Next-token `labels` are formed from the whole rows
before that, so a shard's last position is scored against the next
shard's first token.  Each rank's loss is its tokens' sum over the whole
batch's weight; losses, stats and gradients are summed over every rank
of the mesh, the gradient before `AdamW.step` (whose norm is then the
whole batch's), so the ranks' parameters stay bit-equal.  `forward`
gathers every rank's logprobs, so each rank returns the whole batch's.
`save`, `stage_weights` and `update_weights` write and post from the
head alone, then wait at a barrier.  A departure: GSPMD pads a row
length that sp does not divide, the port cannot, so `initialize` raises
unless sp divides `pack_length_quantum` and `max_pack_length`.

Not ported yet: the fsdp, tp and ep axes (FSDP2 and DTensor), ring
attention, LoRA, `async_stats`, and the per-step train-stats gauges.
`warm_shapes` has no counterpart: eager PyTorch compiles nothing per
shape.
"""

import concurrent.futures
import json
import logging
import math
import os
import re
import shutil
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.api.config import OptimizerConfig, TrainEngineConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec, SaveLoadMeta, WeightUpdateMeta
from areal_tpu_torch.device import DeviceLike
from areal_tpu_torch.models import safetensors_io
from areal_tpu_torch.models.hf import load_hf_params, params_to_hf_state, save_hf_checkpoint
from areal_tpu_torch.models.model_config import TransformerConfig
from areal_tpu_torch.models.transformer import (
    Transformer,
    build_model,
    check_trainable,
    forward_lm,
    init_params,
)
from areal_tpu_torch.ops.attention import ATTN_IMPLS
from areal_tpu_torch.ops.functional import lm_logprobs_entropy, next_token_labels
from areal_tpu_torch.parallel import distributed
from areal_tpu_torch.parallel.mesh import Mesh, build_mesh, mesh_from_alloc
from areal_tpu_torch.utils import name_resolve, names, telemetry
from areal_tpu_torch.utils.data import RowPackedBatch, pack_into_rows, unpack_rows
from areal_tpu_torch.utils.datapack import round_up_to_bucket
from areal_tpu_torch.utils.http import post_bytes_with_retry, request_with_retry
from areal_tpu_torch.utils.profiling import mfu, train_flops_per_token

logger = logging.getLogger("areal_tpu_torch.train")

Batch = Dict[str, torch.Tensor]


def _logp_hook(model_out, mb: Batch) -> torch.Tensor:
    """Default forward hook: next-token logprobs at predictor positions."""
    logp, _, _ = lm_logprobs_entropy(model_out, next_token_labels(mb), with_entropy=False)
    return logp


# ---------------------------------------------------------------------------
# learning-rate schedule and optimizer (optax semantics)
# ---------------------------------------------------------------------------


def make_schedule(oc: OptimizerConfig, total_steps: int) -> Callable[[int], float]:
    """lr(step): optax's linear warmup joined to constant, linear or cosine
    decay (`JaxTrainEngine._build_optimizer`)."""
    warmup = int(oc.warmup_steps_proportion * total_steps)
    peak, floor = oc.lr, oc.lr * oc.min_lr_ratio
    decay_steps = max(1, total_steps - warmup)

    def decay(step: int) -> float:
        if oc.lr_scheduler_type == "cosine":
            c = min(step, decay_steps)
            cos = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
            return peak * ((1 - oc.min_lr_ratio) * cos + oc.min_lr_ratio)
        if oc.lr_scheduler_type == "linear":
            c = min(max(step, 0), decay_steps)
            return (peak - floor) * (1 - c / decay_steps) + floor
        return peak

    def schedule(step: int) -> float:
        if warmup > 0 and step < warmup:
            return peak * step / warmup  # linear_schedule(0, peak, warmup)
        return decay(step - warmup) if warmup > 0 else decay(step)

    return schedule


def decays(name: str, p: torch.Tensor) -> bool:
    """The JAX engine's weight-decay mask, `ndim >= 2` on its scan-stacked
    tree: per-layer leaves carry a leading layer axis there, so every
    per-layer tensor decays (norm weights and LayerNorm biases, q/k norms,
    projection and MLP biases included), and of the rest only the matrices
    (the token and learned-position embeddings, an untied head) do; the
    final norm's weight and bias do not.  This needs the port's names to
    keep every per-layer tensor under `model.layers.`, which the
    Llama-style names of every family do."""
    return p.ndim + name.startswith("model.layers.") >= 2


class AdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(...)) over the
    model's named parameters, state in the parameters' dtype.  Clipping
    scales by max_norm / norm only when the norm is not below max_norm (no
    epsilon); weight decay follows `decays`."""

    STATE_FORMAT = "areal-torch-adamw/v1"

    def __init__(self, named_params: List[Tuple[str, torch.nn.Parameter]],
                 oc: OptimizerConfig, schedule: Callable[[int], float]):
        params = [p for _, p in named_params]
        self.names = [n for n, _ in named_params]
        self.params = params
        self.decay = [decays(n, p) for n, p in named_params]
        self.oc = oc
        self.schedule = schedule
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self) -> Tuple[torch.Tensor, float]:
        """Clip, update the moments, apply; returns (grad norm before
        clipping, the lr used)."""
        oc = self.oc
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        clip = norm >= oc.gradient_clipping
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - oc.beta1 ** self.count
        c2 = 1.0 - oc.beta2 ** self.count
        for p, g, mu, nu, decay in zip(self.params, grads, self.mu, self.nu, self.decay):
            g = torch.where(clip, g / norm * oc.gradient_clipping, g)
            mu.mul_(oc.beta1).add_(g, alpha=1.0 - oc.beta1)
            nu.mul_(oc.beta2).addcmul_(g, g, value=1.0 - oc.beta2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + oc.eps)
            if oc.weight_decay and decay:
                update.add_(p, alpha=oc.weight_decay)
            p.add_(update, alpha=-lr)
        return norm, lr

    def save(self, out_dir: str, extra: Optional[dict] = None) -> None:
        """`mu`/`nu` by parameter name in safetensors shards, and the
        update count (with `extra`) in `adamw_state.json`."""
        os.makedirs(out_dir, exist_ok=True)
        moments = [(f"{kind}/{n}", t) for kind, ts in (("mu", self.mu), ("nu", self.nu))
                   for n, t in zip(self.names, ts)]
        safetensors_io.save_sharded(moments, out_dir, "adamw")
        state = {"format": self.STATE_FORMAT, "count": self.count,
                 "next_lr": self.schedule(self.count), "names": self.names, **(extra or {})}
        with open(os.path.join(out_dir, "adamw_state.json"), "w") as f:
            json.dump(state, f, indent=1)

    @torch.no_grad()
    def load(self, in_dir: str) -> dict:
        """Restore what `save` wrote, in place, matching the moments to the
        parameters by name; returns the state JSON."""
        with open(os.path.join(in_dir, "adamw_state.json")) as f:
            state = json.load(f)
        if state.get("format") != self.STATE_FORMAT:
            raise ValueError(f"{in_dir}: optimizer state format {state.get('format')!r}")
        saved = dict(safetensors_io.iter_safetensors(in_dir))
        want = {f"{kind}/{n}" for kind in ("mu", "nu") for n in self.names}
        if set(saved) != want:
            raise ValueError(f"{in_dir}: the optimizer state names "
                             f"{sorted(set(saved) ^ want)[:4]} do not match the model's")
        for kind, ts in (("mu", self.mu), ("nu", self.nu)):
            for n, t in zip(self.names, ts):
                t.copy_(saved[f"{kind}/{n}"])
        self.count = int(state["count"])
        return state


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class TorchTrainEngine:
    # keys the forward reads (the JAX engine's FORWARD_KEYS)
    FORWARD_KEYS = ("input_ids", "positions", "segment_ids")

    def __init__(self, config: TrainEngineConfig,
                 model_config: Optional[TransformerConfig] = None, device: DeviceLike = None):
        self.config = config
        self.model_config = model_config
        self._device_arg = device
        self.device: Optional[torch.device] = None
        self.mesh: Optional[Mesh] = None
        self.model = None
        self.step_count = 0
        self._version = 0
        self._optimizer: Optional[AdamW] = None
        self._ft_spec: Optional[FinetuneSpec] = None
        self.initialized = False
        # (type, version) of the publish `stage_weights` prepared
        self._staged: Optional[Tuple[str, int]] = None
        self.last_weight_update_seconds = 0.0

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def create_process_group(self, alloc_mode=None) -> None:
        """Join the process group (a no-op with one process) and build the
        mesh: the allocation's train strategy when `alloc_mode` has one,
        else `config.mesh`."""
        if self.mesh is not None:
            return
        distributed.init_distributed(self._device_arg)
        if alloc_mode is not None and getattr(alloc_mode, "train", None):
            self.mesh = mesh_from_alloc(alloc_mode.train)
        else:
            m = self.config.mesh
            self.mesh = build_mesh(dp=m.data_parallel_size, fsdp=m.fsdp_parallel_size,
                                   sp=m.sequence_parallel_size, tp=m.tensor_parallel_size,
                                   ep=m.expert_parallel_size)
        logger.info("mesh %s, rank %d of %d (%s)", self.mesh.shape,
                    distributed.process_index(), distributed.process_count(),
                    distributed.backend() or "one process")

    def initialize(self, addr: Optional[str] = None,
                   ft_spec: Optional[FinetuneSpec] = None) -> None:
        cfg = self.config
        if cfg.attn_impl not in ATTN_IMPLS:
            # forwarded onto the model config: an unknown value would
            # silently take the auto ladder (JAX's engine refuses it too)
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}: use auto, splash, "
                             "naive, or ring")
        self.create_process_group()
        sp = self.mesh.sp
        if cfg.pack_length_quantum % sp or cfg.max_pack_length % sp:
            raise ValueError(f"sequence parallelism over {sp} ranks needs row lengths it "
                             f"divides: pack_length_quantum {cfg.pack_length_quantum} and "
                             f"max_pack_length {cfg.max_pack_length} must be multiples of {sp}")
        self.device = distributed.rank_device(self._device_arg)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self._ft_spec = ft_spec
        if cfg.path and not cfg.init_from_scratch:
            model, mc = load_hf_params(cfg.path, self.model_config, self.device,
                                       param_dtype=cfg.param_dtype)
        else:
            if self.model_config is None:
                raise ValueError("init_from_scratch requires model_config")
            mc = self.model_config
            model = init_params(mc, seed=0, device=self.device, param_dtype=cfg.param_dtype)
        self.model_config = mc.replace(
            dtype=cfg.dtype,
            remat=cfg.gradient_checkpointing,
            remat_policy=cfg.remat_policy,
            layer_group_size=cfg.layer_group_size,
            # an explicitly set model config wins; the engine config is the
            # path for checkpoints (from_hf leaves "auto")
            attn_impl=mc.attn_impl if mc.attn_impl != "auto" else cfg.attn_impl,
        )
        check_trainable(self.model_config)
        model.cfg = self.model_config
        with torch.no_grad():
            for p in model.parameters():  # every rank starts from the head's values
                distributed.broadcast_(p.data, self.mesh.group)
        self.model = model.requires_grad_(True)
        if cfg.optimizer is not None:
            self._build_optimizer(ft_spec)
        self.initialized = True
        n = sum(p.numel() for p in self.model.parameters())
        logger.info("initialized %.1fM params on %s", n / 1e6, self.device)

    def _build_optimizer(self, ft_spec: Optional[FinetuneSpec]) -> None:
        total_steps = ft_spec.total_train_steps if ft_spec is not None else 1_000_000
        # the schedule is indexed per optimizer update, and PPO-style engines
        # make ppo_n_minibatches updates per dataset iteration
        total_steps *= max(1, getattr(self.config, "ppo_n_minibatches", 1))
        schedule = make_schedule(self.config.optimizer, total_steps)
        self._optimizer = AdamW(list(self.model.named_parameters()), self.config.optimizer,
                                schedule)

    def destroy(self) -> None:
        self.model = None
        self._optimizer = None
        self.initialized = False

    def save(self, meta: SaveLoadMeta) -> None:
        """The weights as an HF safetensors dir: f32 with `with_optim`,
        bf16 otherwise; with `with_optim`, AdamW's state in `optimizer/`
        (module docstring)."""
        assert self.initialized
        if meta.weight_format != "safetensors":
            raise NotImplementedError(f"weight format {meta.weight_format!r}")
        if distributed.is_head():  # the ranks' parameters are bit-equal
            save_hf_checkpoint(self.model, meta.path,
                               save_dtype="float32" if meta.with_optim else "bfloat16")
            if meta.with_optim and self._optimizer is not None:
                self._optimizer.save(os.path.join(meta.path, "optimizer"),
                                     extra={"step_count": self.step_count})
        self._barrier()

    @torch.no_grad()
    def load(self, meta: SaveLoadMeta) -> None:
        """Restore `save`'s weights (cast to `param_dtype`) into the live
        parameters, in place, and with `with_optim` the optimizer state
        when the checkpoint holds one."""
        assert self.initialized
        loaded, _ = load_hf_params(meta.path, self.model_config, self.device,
                                   param_dtype=self.config.param_dtype)
        src = dict(loaded.named_parameters())
        for name, p in self.model.named_parameters():
            p.copy_(src[name])
        del loaded, src
        opt_dir = os.path.join(meta.path, "optimizer")
        if meta.with_optim and os.path.isdir(opt_dir):
            if self._optimizer is None:
                raise ValueError(f"{meta.path} holds optimizer state and this engine has "
                                 "no optimizer")
            self.step_count = int(self._optimizer.load(opt_dir)["step_count"])

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.group is not None:
            torch.distributed.barrier(group=self.mesh.group)

    def set_version(self, version: int) -> None:
        self._version = version

    def get_version(self) -> int:
        return self._version

    # ------------------------------------------------------------------
    # data-parallel topology (the JAX engine's: one process a rank)
    # ------------------------------------------------------------------

    @property
    def data_parallel_rank(self) -> int:
        return distributed.process_index()

    @property
    def data_parallel_world_size(self) -> int:
        return distributed.process_count()

    def is_data_parallel_head(self) -> bool:
        return distributed.is_head()

    def current_data_parallel_head(self) -> int:
        return 0

    # ------------------------------------------------------------------
    # batch preparation
    # ------------------------------------------------------------------

    def _row_len(self, batch: Dict[str, np.ndarray]) -> int:
        lens = batch["attention_mask"].astype(np.int64).sum(-1)
        longest = int(lens.max()) if lens.size else 1
        return round_up_to_bucket(longest, self.config.pack_length_quantum,
                                  self.config.max_pack_length)

    def _prepare_rows(self, batch: Dict[str, np.ndarray],
                      n_mbs: int) -> Tuple[RowPackedBatch, Dict[str, np.ndarray], int]:
        """Row-pack a padded batch; the row count is divisible by n_mbs x
        dp, and `labels` are the whole rows' next tokens."""
        row_len = self._row_len(batch)
        rp = pack_into_rows(batch, row_len, rows_multiple=n_mbs * self.mesh.row_shards,
                            rows_bucket_pow2=True)
        data = dict(rp.data)
        data["input_ids"] = data["input_ids"].astype(np.int32)
        data["labels"] = np.roll(data["input_ids"], -1, axis=-1)
        # filler rows and tokens never contribute to the loss
        if "loss_mask" in data:
            data["loss_mask"] = data["loss_mask"] * (data["segment_ids"] >= 0)
        return rp, data, row_len

    def _to_device(self, data: Dict[str, np.ndarray]) -> Batch:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in data.items()}

    def _micro_batches(self, data: Dict[str, np.ndarray], n_mbs: int) -> Iterator[Batch]:
        """[R, L] rows -> n_mbs device batches of R / n_mbs consecutive rows
        (rows were FFD-balanced, so token counts are roughly even), each
        this rank's shard of them."""
        R = data["input_ids"].shape[0]
        per = R // n_mbs
        for i in range(n_mbs):
            yield self._to_device(distributed.make_global_batch(
                self.mesh, {k: v[i * per:(i + 1) * per] for k, v in data.items()}))

    def _call_model(self, mb: Batch):
        return forward_lm(self.model, mb["input_ids"], mb["positions"], mb["segment_ids"],
                          mesh=self.mesh)

    def _sum_over_mesh(self, values: List[torch.Tensor]) -> List[float]:
        """Sums over every rank of the mesh, in one collective and one host
        transfer."""
        return distributed.all_sum_(torch.stack(values), self.mesh.group).cpu().tolist()

    # ------------------------------------------------------------------
    # train / eval / forward
    # ------------------------------------------------------------------

    def _consume_telemetry(self, input_: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Strip the telemetry-only `trace_keys` and, with telemetry on,
        record the staleness of each row at consumption: the trainer's
        version minus the row's newest behaviour version (`versions`, -1
        on the prompt)."""
        keys = input_.get("trace_keys")
        if keys is not None:
            input_ = {k: v for k, v in input_.items() if k != "trace_keys"}
        if not telemetry.is_enabled():
            return input_
        versions = np.asarray(input_.get("versions", ()))
        if versions.ndim != 2:
            return input_
        behavior = np.where(versions >= 0, versions, -1).max(axis=-1)
        tks = None if keys is None else np.asarray(keys).reshape(-1).tolist()
        consumed = self._version
        for i, bv in enumerate(behavior.tolist()):
            if bv < 0:
                continue
            staleness = max(0, consumed - int(bv))
            telemetry.STALENESS_AT_CONSUMPTION.observe(staleness)
            telemetry.emit("train_consume",
                           trace_key=tks[i] if tks is not None and i < len(tks) else None,
                           behavior_version=int(bv), consumed_version=consumed,
                           staleness=staleness)
        return input_

    def train_batch(self, input_: Dict[str, np.ndarray], loss_fn: Callable,
                    loss_weight_fn: Callable) -> Dict[str, float]:
        assert self.initialized and self._optimizer is not None
        input_ = self._consume_telemetry(input_)
        n_mbs = max(1, self.config.mb_spec.n_mbs)
        rp, data, row_len = self._prepare_rows(input_, n_mbs)
        total_weight = float(loss_weight_fn(data))
        if total_weight <= 0:
            raise ValueError("loss_weight_fn returned non-positive total weight")
        t0 = time.perf_counter()
        self.model.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        stat_sums: Dict[str, torch.Tensor] = {}
        for mb in self._micro_batches(data, n_mbs):
            loss, stats = loss_fn(self._call_model(mb), mb)
            loss = loss / total_weight
            loss.backward()
            loss_sum += loss.detach()
            for k, v in stats.items():
                stat_sums[k] = stat_sums.get(k, 0.0) + v.detach().float()
        if self.mesh.group is not None:  # the whole batch's gradient on every rank
            for p in self.model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            distributed.all_sum_grads_(self.model.parameters(), self.mesh.group)
        grad_norm, lr = self._optimizer.step()
        self.model.zero_grad(set_to_none=True)  # free the gradients until the next step
        self.step_count += 1
        keys = list(stat_sums) + ["loss"]
        sums = self._sum_over_mesh([*stat_sums.values(), loss_sum])
        out = dict(zip(keys, sums))
        out["grad_norm"] = grad_norm.item()  # one host transfer, after the step
        out["lr"] = lr
        out["total_loss_weight"] = total_weight
        out["step_time"] = time.perf_counter() - t0
        seg = data["segment_ids"]
        tokens = int((seg >= 0).sum())
        # attention flops scale with segment length, not packed row length
        n_segs = int(np.sum(np.where(seg.max(axis=-1) >= 0, seg.max(axis=-1) + 1, 0)))
        mean_seg = max(1, tokens // max(1, n_segs))
        tps = tokens / max(out["step_time"], 1e-9)
        # the whole batch's tokens over the cards the mesh's ranks run on
        # (ranks share a card when there are more of them than cards)
        n_chips = (min(self.mesh.size, torch.cuda.device_count()) if self.device.type == "cuda"
                   else self.mesh.size)
        out["tflops_per_chip"] = (tps * train_flops_per_token(self.model_config, mean_seg)
                                  / 1e12 / n_chips)
        m = (mfu(tps, self.model_config, mean_seg, n_chips=n_chips)
             if self.device.type == "cuda" else None)
        if m is not None:
            out["mfu"] = m
        return out

    @torch.no_grad()
    def eval_batch(self, input_: Dict[str, np.ndarray], loss_fn: Callable,
                   loss_weight_fn: Callable) -> Dict[str, float]:
        assert self.initialized
        n_mbs = max(1, self.config.mb_spec.n_mbs)
        rp, data, row_len = self._prepare_rows(input_, n_mbs)
        total_weight = float(loss_weight_fn(data))
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        stat_sums: Dict[str, torch.Tensor] = {}
        for mb in self._micro_batches(data, n_mbs):
            loss, stats = loss_fn(self._call_model(mb), mb)
            loss_sum += loss.float()
            for k, v in stats.items():
                stat_sums[k] = stat_sums.get(k, 0.0) + v.float()
        values = self._sum_over_mesh([*stat_sums.values(), loss_sum])
        out = dict(zip(stat_sums, values[:-1]))
        out["loss"] = values[-1] / max(total_weight, 1e-8)
        return out

    @torch.no_grad()
    def forward(self, input_: Dict[str, np.ndarray], output_key: str = "logprobs",
                post_hook: Optional[Callable] = None,
                aggregate_fn: Optional[Callable] = None) -> np.ndarray:
        """No-grad forward over all rows at once; returns a padded [B, L]
        array aligned with the input batch (default: next-token logprobs at
        predictor positions).  Over a mesh each rank runs its shard and
        every rank returns the whole batch's array."""
        assert self.initialized
        if output_key != "logprobs":
            raise NotImplementedError("forward() returns per-token arrays directly")
        if aggregate_fn is not None:
            raise NotImplementedError("forward() runs all rows at once; nothing to aggregate")
        rp, data, row_len = self._prepare_rows(input_, 1)
        mb = next(self._micro_batches({k: data[k] for k in (*self.FORWARD_KEYS, "labels")}, 1))
        rows = (post_hook or _logp_hook)(self._call_model(mb), mb).float()
        R, T = data["input_ids"].shape
        starts = (self.mesh.row_slice(R).start, self.mesh.seq_slice(T).start)
        rows = distributed.gather_blocks(rows, (R, T), starts, self.mesh.group)
        B, L = input_["attention_mask"].shape
        return unpack_rows(rp, rows.cpu().numpy(), B, L)

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------

    @torch.no_grad()
    def export_device_params(self) -> Transformer:
        """The serving model of the colocated publish: a `Transformer`
        holding COPIES of the masters cast to the compute dtype (bf16 where
        the masters are f32 at full width, the cast of the disk publish;
        f32 in an f32 config), on the trainer's device, with no host round
        trip.  They are copies, so the next optimizer step cannot change
        what is being served."""
        served = build_model(self.model_config.replace(remat=False), self.device)
        masters = dict(self.model.named_parameters())
        for name, p in served.named_parameters():
            p.copy_(masters[name])
        return served

    def stage_weights(self, meta: WeightUpdateMeta) -> None:
        """The expensive half of a publish, run while the servers go on
        generating: disk = the snapshot write; transfer = streaming every
        tensor into the servers' staging buffers and `prepare` (assembly on
        their devices).  Nothing is swapped.  Call at the version
        `update_weights` publishes."""
        if meta.type not in ("disk", "transfer"):
            raise NotImplementedError(f"weight update type {meta.type!r}")
        if distributed.is_head():
            if meta.type == "disk":
                self._write_disk_snapshot(meta)
            else:
                self._push_transfer_chunks(meta)
        self._barrier()
        self._staged = (meta.type, self._version)

    def update_weights(self, meta: WeightUpdateMeta) -> None:
        """Publish the current weights: disk = the snapshot (unless staged
        for this version), which the servers reload when the client fans
        out `/update_weights_from_disk`; transfer = the push (unless
        staged) and the commit on every server.  The staged marker is
        consumed either way, so a failed commit is retried with a push."""
        t0 = time.perf_counter()
        try:
            if meta.type not in ("disk", "transfer"):
                raise NotImplementedError(f"weight update type {meta.type!r}")
            staged = self._staged == (meta.type, self._version)
            if distributed.is_head():  # the head writes and posts for every rank
                if meta.type == "disk":
                    if not staged:
                        self._write_disk_snapshot(meta)
                    name_resolve.add(names.update_weights_from_disk(
                        meta.experiment_name, meta.trial_name, self._version),
                        str(time.time_ns()), replace=True)
                else:
                    if not staged:
                        self._push_transfer_chunks(meta)
                    self._commit_transfer(meta)
                    self._notify_router(meta)
        finally:
            self._staged = None
        self._barrier()
        self.last_weight_update_seconds = time.perf_counter() - t0

    def _write_disk_snapshot(self, meta: WeightUpdateMeta) -> None:
        final = os.path.join(meta.path, f"v{self._version}")
        tmp = os.path.join(meta.path, f".tmp-v{self._version}-{os.getpid()}")
        save_hf_checkpoint(self.model, tmp, save_dtype="bfloat16")
        if os.path.isdir(final):  # re-publish of the same version
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune_weight_dirs(meta.path, keep=2)

    @staticmethod
    def _server_addrs(meta: WeightUpdateMeta, timeout: float = 30.0) -> List[str]:
        """The rollout client's discovery: `AREAL_LLM_SERVER_ADDRS`, else
        the servers registered under the meta's experiment and trial,
        polled through a registration race."""
        addrs = [a for a in os.environ.get("AREAL_LLM_SERVER_ADDRS", "").split(",") if a]
        if addrs:
            return addrs
        key = names.gen_servers(meta.experiment_name, meta.trial_name)
        deadline = time.monotonic() + timeout
        while True:
            found = name_resolve.get_subtree(key)
            if found:
                return sorted(found)
            if time.monotonic() >= deadline:
                raise RuntimeError(f"a transfer publish found no servers: neither "
                                   f"AREAL_LLM_SERVER_ADDRS nor name_resolve {key}")
            time.sleep(0.5)

    def _notify_router(self, meta: WeightUpdateMeta) -> None:
        """Tell the experiment's router, if one is registered, the version of
        a transfer publish, which leaves no checkpoint for its watcher: its
        staleness gate's budget grows with it.  Fire-and-forget on a thread
        of its own; the router's poll of the servers' versions covers a
        miss."""
        try:
            addr = name_resolve.get(names.gen_router(meta.experiment_name, meta.trial_name))
        except name_resolve.NameEntryNotFoundError:
            return
        version = self._version

        def post() -> None:
            try:
                request_with_retry(addr, "/set_version", payload={"version": version},
                                   max_retries=1, timeout=5)
            except Exception as e:  # noqa: BLE001 — the router's poller covers the miss
                logger.warning("router /set_version failed (its poll covers it): %s", e)

        threading.Thread(target=post, daemon=True, name="notify-router").start()

    @staticmethod
    def _on_every_server(addrs: List[str], fn: Callable[[str], None]) -> None:
        """fn(addr) for every server in parallel; raises the first failure."""
        with concurrent.futures.ThreadPoolExecutor(len(addrs)) as pool:
            for f in [pool.submit(fn, a) for a in addrs]:
                f.result()

    @torch.no_grad()
    def _push_transfer_chunks(self, meta: WeightUpdateMeta) -> None:
        """Stream every HF-named tensor in bf16 as raw octet-stream pieces
        of at most `chunk_mb` MiB (name, dtype, shape, byte count and
        offset in X-Weight-* headers: the JAX engine's wire form) into
        every server's staging buffer, then `prepare` there.  Swaps
        nothing, so it is safe while the servers generate."""
        addrs = self._server_addrs(meta)
        chunk = max(1, meta.chunk_mb) << 20
        state = [(name, t.to(torch.bfloat16).contiguous().cpu().view(torch.uint8).numpy(),
                  list(t.shape)) for name, t in params_to_hf_state(self.model)]
        version = self._version

        def push(addr: str) -> None:
            for name, raw, shape in state:
                hdrs = {"X-Weight-Name": name, "X-Weight-Dtype": "bfloat16",
                        "X-Weight-Shape": json.dumps(shape), "X-Weight-Nbytes": str(raw.nbytes)}
                view = memoryview(raw).cast("B")
                for off in range(0, raw.nbytes or 1, chunk):
                    post_bytes_with_retry(addr, "/update_weights_chunk", view[off:off + chunk],
                                          headers={**hdrs, "X-Weight-Offset": str(off)},
                                          timeout=300.0)
            request_with_retry(addr, "/update_weights_chunk",
                               payload={"prepare": True, "version": version}, timeout=600.0)

        self._on_every_server(addrs, push)

    def _commit_transfer(self, meta: WeightUpdateMeta) -> None:
        """Swap the staged weights in on every server."""
        payload = {"commit": True, "version": self._version, "live": meta.live_commit}
        self._on_every_server(self._server_addrs(meta), lambda a: request_with_retry(
            a, "/update_weights_chunk", payload=payload, timeout=600.0))

    @staticmethod
    def _prune_weight_dirs(root: str, keep: int) -> None:
        vs = sorted(
            (int(m.group(1)), d)
            for d in os.listdir(root)
            if (m := re.fullmatch(r"v(\d+)", d)) and os.path.isdir(os.path.join(root, d))
        )
        for _, d in vs[:-keep]:
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
