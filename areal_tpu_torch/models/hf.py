"""HF checkpoint <-> model conversion (the port of `areal_tpu/models/hf.py`).

The port's model keeps HF names as its state-dict names, so loading is a
checked `load_state_dict` and saving walks `state_dict()`.  Checkpoints are
read and written by `models/safetensors_io.py`, so the port needs no
`safetensors` package.  `layer_name_map` records how each HF per-layer
name corresponds to the JAX package's scan-stacked tree; the weight bridge
(`models/convert.py`) uses it.
"""

import json
import logging
import os
from typing import Dict, Iterable, Iterator, Optional, Tuple

import torch

from areal_tpu_torch.device import DeviceLike
from areal_tpu_torch.models import safetensors_io
from areal_tpu_torch.models.model_config import TransformerConfig
from areal_tpu_torch.models.transformer import Transformer, build_model, check_supported

logger = logging.getLogger("areal_tpu_torch.models.hf")

# HF per-layer suffix -> (path in the JAX tree's layer, transpose?)
_LAYER_MAP = {
    "self_attn.q_proj.weight": (("attn", "wq"), True),
    "self_attn.k_proj.weight": (("attn", "wk"), True),
    "self_attn.v_proj.weight": (("attn", "wv"), True),
    "self_attn.o_proj.weight": (("attn", "wo"), True),
    "self_attn.q_proj.bias": (("attn", "bq"), False),
    "self_attn.k_proj.bias": (("attn", "bk"), False),
    "self_attn.v_proj.bias": (("attn", "bv"), False),
    "mlp.gate_proj.weight": (("mlp", "w_gate"), True),
    "mlp.up_proj.weight": (("mlp", "w_up"), True),
    "mlp.down_proj.weight": (("mlp", "w_down"), True),
    "input_layernorm.weight": (("input_norm",), False),
    "post_attention_layernorm.weight": (("post_attn_norm",), False),
}


def layer_name_map(cfg: TransformerConfig) -> Dict[str, Tuple[Tuple[str, ...], bool]]:
    """Per-layer HF suffix -> (JAX tree path, transpose) for the families
    the port serves (the JAX map's llama/qwen2 entries; q/k/v biases only
    when the config has them)."""
    check_supported(cfg)
    return {
        suffix: entry for suffix, entry in _LAYER_MAP.items()
        if cfg.qkv_bias or not suffix.endswith(".bias")
    }


def state_to_params(
    items: Iterable[Tuple[str, torch.Tensor]],
    cfg: TransformerConfig,
    device: DeviceLike = None,
    param_dtype: Optional[str] = None,
) -> Transformer:
    """HF-named (name, tensor) pairs -> model on `device` with weights in
    `param_dtype` (default: the compute dtype), with completeness
    validation: every weight the model has must arrive exactly once;
    unmapped names are skipped with a warning; a tied config drops a
    checkpoint's `lm_head.weight`, an untied one requires it."""
    model = build_model(cfg, device, param_dtype)
    params = dict(model.named_parameters())
    filled = set()
    with torch.no_grad():
        for name, t in items:
            p = params.get(name)
            if p is None:
                if not (name == "lm_head.weight" and cfg.tie_word_embeddings):
                    logger.warning("skipping unmapped weight %s", name)
                continue
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)}, "
                                 f"model expects {tuple(p.shape)}")
            if name in filled:
                raise ValueError(f"{name} appears twice in the checkpoint")
            p.copy_(t)
            filled.add(name)
    missing = sorted(set(params) - filled)
    if missing:
        if missing == ["lm_head.weight"]:
            raise ValueError("untied config but checkpoint has no lm_head.weight")
        raise ValueError(f"incomplete weights: missing {missing[:8]}"
                         f"{' ...' if len(missing) > 8 else ''}")
    return model


def load_hf_params(
    path: str,
    cfg: Optional[TransformerConfig] = None,
    device: DeviceLike = None,
    param_dtype: Optional[str] = None,
) -> Tuple[Transformer, TransformerConfig]:
    """Load an HF checkpoint dir onto `device` (the card by default), with
    weights in `param_dtype` (default: the config's compute dtype)."""
    if cfg is None:
        cfg = TransformerConfig.from_hf(path)
    return state_to_params(safetensors_io.iter_safetensors(path), cfg, device,
                           param_dtype), cfg


def params_to_hf_state(model: Transformer) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield HF-named (name, tensor) pairs; a tied head is not emitted."""
    yield from model.state_dict().items()


def save_hf_checkpoint(
    model: Transformer,
    out_dir: str,
    save_dtype: str = "bfloat16",
    max_shard_bytes: int = 4 * 1024**3,
) -> None:
    """Write an HF-format checkpoint dir: config.json, safetensors shards
    of at most `max_shard_bytes`, and the weight index when sharded."""
    cfg = model.cfg
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg.to_hf_dict(), f, indent=2)
    target = getattr(torch, save_dtype)
    shards, sizes = [{}], [0]
    for name, t in params_to_hf_state(model):
        t = t.to(target)
        nbytes = t.numel() * t.element_size()
        if sizes[-1] + nbytes > max_shard_bytes and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = t
        sizes[-1] += nbytes
    n = len(shards)
    weight_map = {}
    for i, shard in enumerate(shards):
        fname = "model.safetensors" if n == 1 else f"model-{i + 1:05d}-of-{n:05d}.safetensors"
        safetensors_io.save_file(shard, os.path.join(out_dir, fname))
        weight_map.update({name: fname for name in shard})
    if n > 1:
        with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": sum(sizes)}, "weight_map": weight_map}, f)
