"""Datasets of the port (copies of `areal_tpu/dataset/`): the registry
`get_custom_dataset` dispatches on a dataset's `type` to a loader.
Registered: `gsm8k-synth` (the in-repo problem generator), `jsonl` (a
local prompt file) and `hhrlhf` (preference pairs from a local `.jsonl`).
Every loader reads local files with the standard library: the card's
machine has no HF `datasets`."""

from typing import Callable, Dict, Optional

_REGISTRY: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_custom_dataset(path: str, type: str = "", split: str = "train", tokenizer=None,
                       max_length: Optional[int] = None, **kwargs):
    """The loader registered under `type` (else `path`): an exact name
    first, then the first name the key contains."""
    key = type or path
    fn = _REGISTRY.get(key) or next((f for n, f in _REGISTRY.items() if n in key), None)
    if fn is None:
        raise ValueError(f"unknown dataset type {key!r}; known: {sorted(_REGISTRY)}")
    return fn(path=path, split=split, tokenizer=tokenizer, max_length=max_length, **kwargs)


from areal_tpu_torch.dataset import gsm8k_synth as _gsm8k_synth  # noqa: E402,F401  (registers)
from areal_tpu_torch.dataset import hhrlhf as _hhrlhf  # noqa: E402,F401
from areal_tpu_torch.dataset import jsonl as _jsonl  # noqa: E402,F401
