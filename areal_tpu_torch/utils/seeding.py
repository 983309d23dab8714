"""Deterministic seeding of python, numpy and torch (the port's copy of
`areal_tpu/utils/seeding.py`).

`set_random_seed(base, key)` folds the key into the base seed with the
reference's blake2b fold, so the seeds equal the JAX package's, and seeds
`random`, numpy's global generator, `torch.manual_seed` and, when a card
is present, every CUDA generator.  The reference's `jax_root_key` has no
counterpart: the port's random draws take explicit `torch.Generator`s.
"""

import hashlib
import random
from typing import Optional

import numpy as np
import torch

_BASE_SEED: Optional[int] = None


def _fold(seed: int, *keys: str) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(str(seed).encode())
    for k in keys:
        h.update(b"\x00" + k.encode())
    return int.from_bytes(h.digest(), "little") % (2**31 - 1)


def set_random_seed(base_seed: int, key: str = "") -> int:
    """Seed python, numpy and torch with a value derived from (base_seed,
    key): different keys (worker identities) get decorrelated streams from
    one base seed.  Returns the folded seed."""
    global _BASE_SEED
    _BASE_SEED = base_seed
    seed = _fold(base_seed, key)
    random.seed(seed)
    np.random.seed(seed % (2**32 - 1))
    torch.manual_seed(seed)  # seeds the CUDA generators too, lazily
    return seed


def get_seed() -> int:
    if _BASE_SEED is None:
        raise RuntimeError("set_random_seed() has not been called")
    return _BASE_SEED
