"""Weight bridge: the JAX package's param tree -> the port's model.

`params_from_jax` takes the scan-stacked tree that `areal_tpu`'s
`init_params` emits (as numpy arrays: `tree["layers"]["attn"]["wq"]` is
[L, D, Hq*hd], matrices are [in, out]) and returns the port's model with
the same weights, so tests can run both packages on one set of weights.
A critic's or reward model's tree carries a `value_head` [D] beside the
backbone (and no `lm_head`): the port's model gets it as its `value_head`
parameter (`engine/ppo/critic.py`).
"""

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.device import DeviceLike
from areal_tpu_torch.models.hf import attach_value_head, layer_name_map, state_to_params
from areal_tpu_torch.models.model_config import TransformerConfig
from areal_tpu_torch.models.transformer import Transformer


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


def jax_tree_to_hf(tree: Dict[str, Any], cfg: TransformerConfig) -> Iterator[Tuple[str, torch.Tensor]]:
    """The port's state-dict names (HF names, Llama-style for every family)
    with f32 tensors from a JAX scan-stacked tree: the embeddings (token,
    and learned positions), each layer's leaves by `layer_name_map`, the
    final norm (with its LayerNorm bias), an untied head."""
    yield "model.embed_tokens.weight", _tensor(tree["embedding"])
    if "pos_embedding" in tree:
        yield "model.embed_positions.weight", _tensor(tree["pos_embedding"])
    layers = tree["layers"]
    lmap = layer_name_map(cfg)
    for i in range(cfg.num_layers):
        for suffix, (path, transpose) in lmap.items():
            leaf = layers
            for key in path:
                leaf = leaf[key]
            arr = np.asarray(leaf[i])
            yield f"model.layers.{i}.{suffix}", _tensor(arr.T if transpose else arr)
    yield "model.norm.weight", _tensor(tree["final_norm"])
    if "final_norm_b" in tree:
        yield "model.norm.bias", _tensor(tree["final_norm_b"])
    if "lm_head" in tree:
        yield "lm_head.weight", _tensor(np.asarray(tree["lm_head"]).T)


def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
                    device: DeviceLike = None, param_dtype: Optional[str] = None,
                    trainable: bool = False) -> Transformer:
    """The port's model (on `device`, the card by default) holding the
    weights of a JAX param tree in `param_dtype` (default: the config's
    compute dtype; "float32" builds the trainer's f32 masters), with
    gradients enabled when `trainable`.  A tree with a `value_head` (a
    critic's: its `lm_head` dropped, so it loads under a tied `cfg`) gives
    the model that head as its `value_head` parameter."""
    model = state_to_params(jax_tree_to_hf(tree, cfg), cfg, device, param_dtype)
    if "value_head" in tree:
        attach_value_head(model, tree["value_head"])
    return model.requires_grad_(trainable)
