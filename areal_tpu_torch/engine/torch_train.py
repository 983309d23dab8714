"""TorchTrainEngine: the single-GPU training backend (the port of
`areal_tpu/engine/jax_train.py JaxTrainEngine`).

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
- `update_weights` publishes on the "disk" path: a bf16 HF snapshot
  staged in `.tmp-v{N}-{pid}` and renamed to `v{N}`, the newest two kept;
  servers reload it on `/update_weights_from_disk`.

Not ported yet: meshes beyond one device, LoRA, `async_stats`, the
transfer publish path and the name_resolve version handshake, `save` /
`load` with the optimizer.  `warm_shapes` has no counterpart: eager
PyTorch compiles nothing per shape.
"""

import logging
import math
import os
import re
import shutil
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.api.config import OptimizerConfig, TrainEngineConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec, WeightUpdateMeta
from areal_tpu_torch.device import DeviceLike, resolve_device
from areal_tpu_torch.models.hf import load_hf_params, save_hf_checkpoint
from areal_tpu_torch.models.model_config import TransformerConfig
from areal_tpu_torch.models.transformer import check_trainable, forward_lm, init_params
from areal_tpu_torch.ops.functional import lm_logprobs_entropy
from areal_tpu_torch.utils.data import RowPackedBatch, pack_into_rows, unpack_rows
from areal_tpu_torch.utils.datapack import round_up_to_bucket
from areal_tpu_torch.utils.profiling import mfu, train_flops_per_token

logger = logging.getLogger("areal_tpu_torch.train")

Batch = Dict[str, torch.Tensor]


def _logp_hook(model_out, mb: Batch) -> torch.Tensor:
    """Default forward hook: next-token logprobs at predictor positions."""
    labels = torch.roll(mb["input_ids"], -1, dims=-1)
    logp, _, _ = lm_logprobs_entropy(model_out, labels, with_entropy=False)
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
    per-layer tensor (norm weights and biases included) decays, and of the
    rest only the matrices (the embedding, an untied head) do."""
    return p.ndim + name.startswith("model.layers.") >= 2


class AdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(...)) over the
    model's named parameters, state in the parameters' dtype.  Clipping
    scales by max_norm / norm only when the norm is not below max_norm (no
    epsilon); weight decay follows `decays`."""

    def __init__(self, named_params: List[Tuple[str, torch.nn.Parameter]],
                 oc: OptimizerConfig, schedule: Callable[[int], float]):
        params = [p for _, p in named_params]
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
        self.model = None
        self.step_count = 0
        self._version = 0
        self._optimizer: Optional[AdamW] = None
        self._ft_spec: Optional[FinetuneSpec] = None
        self.initialized = False

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def initialize(self, addr: Optional[str] = None,
                   ft_spec: Optional[FinetuneSpec] = None) -> None:
        cfg = self.config
        self.device = resolve_device(self._device_arg)
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
        )
        check_trainable(self.model_config)
        model.cfg = self.model_config
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

    def set_version(self, version: int) -> None:
        self._version = version

    def get_version(self) -> int:
        return self._version

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
        """Row-pack a padded batch; the row count is divisible by n_mbs."""
        row_len = self._row_len(batch)
        rp = pack_into_rows(batch, row_len, rows_multiple=n_mbs, rows_bucket_pow2=True)
        data = dict(rp.data)
        data["input_ids"] = data["input_ids"].astype(np.int32)
        # filler rows and tokens never contribute to the loss
        if "loss_mask" in data:
            data["loss_mask"] = data["loss_mask"] * (data["segment_ids"] >= 0)
        return rp, data, row_len

    def _to_device(self, data: Dict[str, np.ndarray]) -> Batch:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in data.items()}

    def _micro_batches(self, data: Dict[str, np.ndarray], n_mbs: int) -> Iterator[Batch]:
        """[R, L] rows -> n_mbs device batches of R / n_mbs consecutive rows
        (rows were FFD-balanced, so token counts are roughly even)."""
        R = data["input_ids"].shape[0]
        per = R // n_mbs
        for i in range(n_mbs):
            yield self._to_device({k: v[i * per:(i + 1) * per] for k, v in data.items()})

    def _call_model(self, mb: Batch):
        return forward_lm(self.model, mb["input_ids"], mb["positions"], mb["segment_ids"])

    # ------------------------------------------------------------------
    # train / eval / forward
    # ------------------------------------------------------------------

    def train_batch(self, input_: Dict[str, np.ndarray], loss_fn: Callable,
                    loss_weight_fn: Callable) -> Dict[str, float]:
        assert self.initialized and self._optimizer is not None
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
        grad_norm, lr = self._optimizer.step()
        self.model.zero_grad(set_to_none=True)  # free the gradients until the next step
        self.step_count += 1
        keys = list(stat_sums) + ["grad_norm", "loss"]
        values = torch.stack([*stat_sums.values(), grad_norm.float(), loss_sum])
        out = dict(zip(keys, values.cpu().tolist()))  # one host transfer, after the step
        out["lr"] = lr
        out["total_loss_weight"] = total_weight
        out["step_time"] = time.perf_counter() - t0
        seg = data["segment_ids"]
        tokens = int((seg >= 0).sum())
        # attention flops scale with segment length, not packed row length
        n_segs = int(np.sum(np.where(seg.max(axis=-1) >= 0, seg.max(axis=-1) + 1, 0)))
        mean_seg = max(1, tokens // max(1, n_segs))
        tps = tokens / max(out["step_time"], 1e-9)
        out["tflops_per_chip"] = tps * train_flops_per_token(self.model_config, mean_seg) / 1e12
        m = mfu(tps, self.model_config, mean_seg) if self.device.type == "cuda" else None
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
        values = torch.stack([*stat_sums.values(), loss_sum]).cpu().tolist()
        out = dict(zip(stat_sums, values[:-1]))
        out["loss"] = values[-1] / max(total_weight, 1e-8)
        return out

    @torch.no_grad()
    def forward(self, input_: Dict[str, np.ndarray], output_key: str = "logprobs",
                post_hook: Optional[Callable] = None,
                aggregate_fn: Optional[Callable] = None) -> np.ndarray:
        """No-grad forward over all rows at once; returns a padded [B, L]
        array aligned with the input batch (default: next-token logprobs at
        predictor positions)."""
        assert self.initialized
        if output_key != "logprobs":
            raise NotImplementedError("forward() returns per-token arrays directly")
        if aggregate_fn is not None:
            raise NotImplementedError("forward() runs all rows at once; nothing to aggregate")
        rp, data, row_len = self._prepare_rows(input_, 1)
        mb = self._to_device({k: data[k] for k in self.FORWARD_KEYS})
        rows = (post_hook or _logp_hook)(self._call_model(mb), mb)
        B, L = input_["attention_mask"].shape
        return unpack_rows(rp, rows.float().cpu().numpy(), B, L)

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------

    def update_weights(self, meta: WeightUpdateMeta) -> None:
        """Publish the current weights for the servers: the "disk" path."""
        if meta.type != "disk":
            raise NotImplementedError(f"weight update type {meta.type!r} is not ported")
        final = os.path.join(meta.path, f"v{self._version}")
        tmp = os.path.join(meta.path, f".tmp-v{self._version}-{os.getpid()}")
        save_hf_checkpoint(self.model, tmp, save_dtype="bfloat16")
        if os.path.isdir(final):  # re-publish of the same version
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune_weight_dirs(meta.path, keep=2)

    @staticmethod
    def _prune_weight_dirs(root: str, keep: int) -> None:
        vs = sorted(
            (int(m.group(1)), d)
            for d in os.listdir(root)
            if (m := re.fullmatch(r"v(\d+)", d)) and os.path.isdir(os.path.join(root, d))
        )
        for _, d in vs[:-keep]:
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
