"""HF checkpoint <-> model conversion (the port of `areal_tpu/models/hf.py`).

The port's model keeps HF names as its state-dict names (Llama-style for
every family), so loading is a checked `load_state_dict` and saving walks
`state_dict()`.  GPT-2 checkpoints speak their own dialect
(`transformer.h.N.*`, `wte`/`wpe`/`ln_f`, Conv1D weights stored [in, out],
q/k/v fused in `attn.c_attn`, causal-mask buffers beside the weights); it
is translated here on the way in and out, as the JAX package does, and
nowhere else.  Checkpoints are read and written by
`models/safetensors_io.py`, so the port needs no `safetensors` package.
`layer_name_map` records how each per-layer name corresponds to the JAX
package's scan-stacked tree; the weight bridge (`models/convert.py`) uses
it.

A value model (the critic, the reward model: `engine/ppo/critic.py`)
holds a `value_head` [D] parameter and no `lm_head`; its checkpoint is the
backbone as a tied HF checkpoint (config.json says tied, no `lm_head`
tensor) with the head beside it as `value_head.npy`, in f32, the JAX
package's convention, so either package loads the other's.
"""

import json
import logging
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.device import DeviceLike
from areal_tpu_torch.models import safetensors_io
from areal_tpu_torch.models.model_config import TransformerConfig
from areal_tpu_torch.models.transformer import Transformer, build_model, check_supported

logger = logging.getLogger("areal_tpu_torch.models.hf")

GPT2 = "GPT2LMHeadModel"
# gpt2 per-layer suffix -> (the port's suffix, transpose?); c_attn apart
_GPT2_LAYER = {
    "ln_1.weight": ("input_layernorm.weight", False),
    "ln_1.bias": ("input_layernorm.bias", False),
    "attn.c_proj.weight": ("self_attn.o_proj.weight", True),
    "attn.c_proj.bias": ("self_attn.o_proj.bias", False),
    "ln_2.weight": ("post_attention_layernorm.weight", False),
    "ln_2.bias": ("post_attention_layernorm.bias", False),
    "mlp.c_fc.weight": ("mlp.up_proj.weight", True),
    "mlp.c_fc.bias": ("mlp.up_proj.bias", False),
    "mlp.c_proj.weight": ("mlp.down_proj.weight", True),
    "mlp.c_proj.bias": ("mlp.down_proj.bias", False),
}
_GPT2_TOP = {
    "wte.weight": "model.embed_tokens.weight",
    "wpe.weight": "model.embed_positions.weight",
    "ln_f.weight": "model.norm.weight",
    "ln_f.bias": "model.norm.bias",
}
_GPT2_H = re.compile(r"h\.(\d+)\.(.+)")
VALUE_HEAD_FILE = "value_head.npy"


def _layer_norms(cfg: TransformerConfig) -> List[Tuple[str, str]]:
    """(the port's norm module, JAX leaf) per layer.  gemma2's sandwich
    layout: its post_attention_layernorm normalises the attention OUTPUT
    (JAX's sandwich_attn_norm) while pre_feedforward_layernorm is the
    pre-MLP norm every other family calls post_attention_layernorm."""
    if cfg.sandwich_norms:
        return [("input_layernorm", "input_norm"),
                ("post_attention_layernorm", "sandwich_attn_norm"),
                ("pre_feedforward_layernorm", "post_attn_norm"),
                ("post_feedforward_layernorm", "sandwich_ffn_norm")]
    return [("input_layernorm", "input_norm"), ("post_attention_layernorm", "post_attn_norm")]


def layer_name_map(cfg: TransformerConfig) -> Dict[str, Tuple[Tuple[str, ...], bool]]:
    """Per-layer suffix of the port's state dict -> (JAX tree path,
    transpose), in the order the JAX package emits a layer's tensors:
    projections, their biases, q/k norms, the MLP, the norms (with their
    LayerNorm biases)."""
    check_supported(cfg)
    m = {f"self_attn.{x}_proj.weight": (("attn", f"w{x}"), True) for x in "qkvo"}
    if cfg.qkv_bias:
        m.update({f"self_attn.{x}_proj.bias": (("attn", f"b{x}"), False) for x in "qkv"})
    if cfg.attn_output_bias:
        m["self_attn.o_proj.bias"] = (("attn", "bo"), False)
    if cfg.qk_norm:
        m.update({f"self_attn.{x}_norm.weight": (("attn", f"{x}_norm"), False) for x in "qk"})
    mlp = ("gate", "up", "down") if cfg.mlp_gated else ("up", "down")
    m.update({f"mlp.{x}_proj.weight": (("mlp", f"w_{x}"), True) for x in mlp})
    if cfg.mlp_bias and not cfg.mlp_gated:
        m.update({f"mlp.{x}_proj.bias": (("mlp", f"b_{x}"), False) for x in mlp})
    for module, leaf in _layer_norms(cfg):
        m[f"{module}.weight"] = ((leaf,), False)
        if cfg.norm_type == "layernorm":
            m[f"{module}.bias"] = ((leaf + "_b",), False)
    return m


def _from_gpt2(items: Iterable[Tuple[str, torch.Tensor]]) -> Iterator[Tuple[str, torch.Tensor]]:
    """gpt2-dialect (name, tensor) pairs -> the port's names: Conv1D
    weights transposed to [out, in], `c_attn` split into q/k/v, the
    causal-mask buffers (`attn.bias`, `attn.masked_bias`) skipped.  Names
    it does not know pass through, for `state_to_params` to report."""
    for name, t in items:
        name = name.removeprefix("transformer.")
        if name.endswith((".attn.bias", ".attn.masked_bias")):
            continue  # buffers, not weights (c_attn.bias has no leading ".attn.")
        if name in _GPT2_TOP:
            yield _GPT2_TOP[name], t
            continue
        m = _GPT2_H.fullmatch(name)
        if m is None:
            yield name, t
            continue
        pre, suffix = f"model.layers.{m.group(1)}.", m.group(2)
        if suffix in ("attn.c_attn.weight", "attn.c_attn.bias"):
            kind = suffix.rsplit(".", 1)[1]
            for x, part in zip("qkv", t.chunk(3, dim=-1)):
                yield f"{pre}self_attn.{x}_proj.{kind}", part.t() if kind == "weight" else part
        elif suffix in _GPT2_LAYER:
            port, transpose = _GPT2_LAYER[suffix]
            yield pre + port, t.t() if transpose else t
        else:
            yield pre + suffix, t


def _to_gpt2(state: Dict[str, torch.Tensor],
             cfg: TransformerConfig) -> Iterator[Tuple[str, torch.Tensor]]:
    """The port's state -> gpt2-dialect pairs in the JAX package's order
    (`_gpt2_state`): wte, wpe, per layer the re-fused c_attn and the rest,
    ln_f."""
    top = {port: f"transformer.{hf}" for hf, port in _GPT2_TOP.items()}
    for port in ("model.embed_tokens.weight", "model.embed_positions.weight"):
        yield top[port], state[port]
    for i in range(cfg.num_layers):
        pre, out = f"model.layers.{i}.", f"transformer.h.{i}."
        yield out + "attn.c_attn.weight", torch.cat(
            [state[f"{pre}self_attn.{x}_proj.weight"].t() for x in "qkv"], dim=1)
        yield out + "attn.c_attn.bias", torch.cat(
            [state[f"{pre}self_attn.{x}_proj.bias"] for x in "qkv"])
        for suffix, (port, transpose) in _GPT2_LAYER.items():
            t = state[pre + port]
            yield out + suffix, t.t() if transpose else t
    for port in ("model.norm.weight", "model.norm.bias"):
        yield top[port], state[port]


def state_to_params(
    items: Iterable[Tuple[str, torch.Tensor]],
    cfg: TransformerConfig,
    device: DeviceLike = None,
    param_dtype: Optional[str] = None,
) -> Transformer:
    """HF-named (name, tensor) pairs (gpt2's dialect for a gpt2 config) ->
    model on `device` with weights in `param_dtype` (default: the compute
    dtype), with completeness validation: every weight the model has must arrive exactly once;
    unmapped names are skipped with a warning; a tied config drops a
    checkpoint's `lm_head.weight`, an untied one requires it."""
    model = build_model(cfg, device, param_dtype)
    params = dict(model.named_parameters())
    filled = set()
    if cfg.hf_architecture == GPT2:
        items = _from_gpt2(items)
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
    weights in `param_dtype` (default: the config's compute dtype); a value
    model's dir gives the model its `value_head` too."""
    if cfg is None:
        cfg = TransformerConfig.from_hf(path)
    model = state_to_params(safetensors_io.iter_safetensors(path), cfg, device, param_dtype)
    head = load_value_head(path)
    if head is not None:
        attach_value_head(model, head)
    return model, cfg


def params_to_hf_state(model: Transformer) -> Iterator[Tuple[str, torch.Tensor]]:
    """HF-named (name, tensor) pairs of a checkpoint, in the order the JAX
    package's `params_to_hf_state` yields them: the embeddings, each
    layer's tensors in `layer_name_map` order, the final norm, an untied
    head (a tied one is not emitted); gpt2 in its own dialect.  The disk
    and transfer publishes write them so."""
    state = model.state_dict()
    state.pop("value_head", None)  # a value model's head goes beside (VALUE_HEAD_FILE)
    cfg = model.cfg
    if cfg.hf_architecture == GPT2:
        yield from _to_gpt2(state, cfg)
        return
    names = (["model.embed_tokens.weight"]
             + (["model.embed_positions.weight"] if cfg.pos_emb == "learned" else [])
             + [f"model.layers.{i}.{suffix}" for i in range(cfg.num_layers)
                for suffix in layer_name_map(cfg)]
             + ["model.norm.weight"]
             + (["model.norm.bias"] if cfg.norm_type == "layernorm" else [])
             + (["lm_head.weight"] if "lm_head.weight" in state else []))
    if set(names) != set(state):
        raise ValueError(f"state names differ from the HF layout: "
                         f"{sorted(set(names) ^ set(state))[:8]}")
    for n in names:
        yield n, state[n]


def save_hf_checkpoint(
    model: Transformer,
    out_dir: str,
    save_dtype: str = "bfloat16",
    max_shard_bytes: int = 4 * 1024**3,
) -> None:
    """Write an HF-format checkpoint dir: config.json, safetensors shards
    of at most `max_shard_bytes`, the weight index when sharded, and a
    value model's head as `VALUE_HEAD_FILE`."""
    cfg = model.cfg
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg.to_hf_dict(), f, indent=2)
    target = getattr(torch, save_dtype)
    weight_map, total = safetensors_io.save_sharded(
        ((name, t.to(target)) for name, t in params_to_hf_state(model)), out_dir, "model",
        max_shard_bytes)
    if len(set(weight_map.values())) > 1:
        with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    head = getattr(model, "value_head", None)
    if head is not None:
        np.save(os.path.join(out_dir, VALUE_HEAD_FILE), head.detach().float().cpu().numpy())


def attach_value_head(model: Transformer, head: np.ndarray) -> None:
    """Give `model` a value head [D] (gradients off, as `build_model`
    leaves every weight), on its device and in its weights' dtype."""
    ref = model.model.norm.weight
    model.value_head = torch.nn.Parameter(
        torch.tensor(np.asarray(head, np.float32)).to(device=ref.device, dtype=ref.dtype),
        requires_grad=False)


def load_value_head(path: str) -> Optional[np.ndarray]:
    """A value model's head [D] from a checkpoint dir (f32), or None when
    the dir has none."""
    f = os.path.join(path, VALUE_HEAD_FILE)
    return np.load(f).astype(np.float32) if os.path.exists(f) else None
