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
- Weights are published in two halves, as the JAX engine does:
  `stage_weights` runs the expensive half while the servers go on
  generating, `update_weights` the commit (and the whole publish when
  nothing was staged for this version).  "disk": a bf16 HF snapshot
  staged in `.tmp-v{N}-{pid}` and renamed to `v{N}`, the newest two kept;
  servers reload it on `/update_weights_from_disk`.  "transfer": every
  HF-named tensor in bf16, in the JAX engine's order and pieces of at most
  `chunk_mb` MiB, streamed to every server's `/update_weights_chunk`
  (`AREAL_LLM_SERVER_ADDRS`), then `prepare`; the commit swaps them in,
  live or after an abort.  The commit's wall time lands in
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

Not ported yet: meshes beyond one device, LoRA, `async_stats`, the
name_resolve version handshake and router notice of a publish.
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
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.api.config import OptimizerConfig, TrainEngineConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec, SaveLoadMeta, WeightUpdateMeta
from areal_tpu_torch.device import DeviceLike, resolve_device
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
from areal_tpu_torch.ops.functional import lm_logprobs_entropy
from areal_tpu_torch.utils.data import RowPackedBatch, pack_into_rows, unpack_rows
from areal_tpu_torch.utils.datapack import round_up_to_bucket
from areal_tpu_torch.utils.http import post_bytes_with_retry, request_with_retry
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

    def initialize(self, addr: Optional[str] = None,
                   ft_spec: Optional[FinetuneSpec] = None) -> None:
        cfg = self.config
        if cfg.attn_impl not in ATTN_IMPLS:
            # forwarded onto the model config: an unknown value would
            # silently take the auto ladder (JAX's engine refuses it too)
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}: use auto, splash, "
                             "naive, or ring")
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
            # an explicitly set model config wins; the engine config is the
            # path for checkpoints (from_hf leaves "auto")
            attn_impl=mc.attn_impl if mc.attn_impl != "auto" else cfg.attn_impl,
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

    def save(self, meta: SaveLoadMeta) -> None:
        """The weights as an HF safetensors dir: f32 with `with_optim`,
        bf16 otherwise; with `with_optim`, AdamW's state in `optimizer/`
        (module docstring)."""
        assert self.initialized
        if meta.weight_format != "safetensors":
            raise NotImplementedError(f"weight format {meta.weight_format!r}")
        save_hf_checkpoint(self.model, meta.path,
                           save_dtype="float32" if meta.with_optim else "bfloat16")
        if meta.with_optim and self._optimizer is not None:
            self._optimizer.save(os.path.join(meta.path, "optimizer"),
                                 extra={"step_count": self.step_count})

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
        if meta.type == "disk":
            self._write_disk_snapshot(meta)
        elif meta.type == "transfer":
            self._push_transfer_chunks(meta)
        else:
            raise NotImplementedError(f"weight update type {meta.type!r}")
        self._staged = (meta.type, self._version)

    def update_weights(self, meta: WeightUpdateMeta) -> None:
        """Publish the current weights: disk = the snapshot (unless staged
        for this version), which the servers reload when the client fans
        out `/update_weights_from_disk`; transfer = the push (unless
        staged) and the commit on every server.  The staged marker is
        consumed either way, so a failed commit is retried with a push."""
        t0 = time.perf_counter()
        try:
            if meta.type == "disk":
                if self._staged != ("disk", self._version):
                    self._write_disk_snapshot(meta)
            elif meta.type == "transfer":
                if self._staged != ("transfer", self._version):
                    self._push_transfer_chunks(meta)
                self._commit_transfer(meta)
            else:
                raise NotImplementedError(f"weight update type {meta.type!r}")
        finally:
            self._staged = None
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
    def _server_addrs() -> List[str]:
        addrs = [a for a in os.environ.get("AREAL_LLM_SERVER_ADDRS", "").split(",") if a]
        if not addrs:
            raise RuntimeError("a transfer publish needs the servers' addresses in "
                               "AREAL_LLM_SERVER_ADDRS (the launch helper exports it)")
        return addrs

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
        addrs = self._server_addrs()
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
        self._on_every_server(self._server_addrs(), lambda a: request_with_retry(
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
