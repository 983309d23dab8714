"""Device resolution for the port's entry points.

The card is the default: `GenEngine`, `gen/server.py main` and
`init_params` run on `cuda` unless the caller asks for the CPU.  Without a
card and without `device="cpu"` they raise; nothing quietly carries on on
the CPU.
"""

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the card.  Raises when a CUDA device is asked for (or
    defaulted to) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: Optional[str]) -> torch.dtype:
    """Config dtype string ('bfloat16', 'float32', ...) -> torch dtype."""
    dt = getattr(torch, name or "float32", None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
