"""Weight bridge: the JAX package's param tree -> the port's model.

`params_from_jax` takes the scan-stacked tree that `areal_tpu`'s
`init_params` emits (as numpy arrays: `tree["layers"]["attn"]["wq"]` is
[L, D, Hq*hd], matrices are [in, out]) and returns the port's model with
the same weights, so tests can run both packages on one set of weights.
"""

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.device import DeviceLike
from areal_tpu_torch.models.hf import layer_name_map, state_to_params
from areal_tpu_torch.models.model_config import TransformerConfig
from areal_tpu_torch.models.transformer import Transformer


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


def jax_tree_to_hf(tree: Dict[str, Any], cfg: TransformerConfig) -> Iterator[Tuple[str, torch.Tensor]]:
    """HF-named f32 tensors from a JAX scan-stacked tree."""
    yield "model.embed_tokens.weight", _tensor(tree["embedding"])
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
    if "lm_head" in tree:
        yield "lm_head.weight", _tensor(np.asarray(tree["lm_head"]).T)


def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
                    device: DeviceLike = None, param_dtype: Optional[str] = None,
                    trainable: bool = False) -> Transformer:
    """The port's model (on `device`, the card by default) holding the
    weights of a JAX param tree in `param_dtype` (default: the config's
    compute dtype; "float32" builds the trainer's f32 masters), with
    gradients enabled when `trainable`."""
    model = state_to_params(jax_tree_to_hf(tree, cfg), cfg, device, param_dtype)
    return model.requires_grad_(trainable)
