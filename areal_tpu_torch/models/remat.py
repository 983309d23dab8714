"""The remat rungs of the training forward (the port of
`areal_tpu/models/transformer.py` `_remat_checkpoint_kwargs` and the
layer grouping of `_backbone`).

JAX wraps each layer, or each group of `layer_group_size` layers, in one
`jax.checkpoint` whose policy decides what the backward keeps from the
forward and what it recomputes; `_layer_forward` names two tensors with
`checkpoint_name`: `attn_out` (the attention output before `wo`) and
`mlp_out` (the FFN output before the sandwich norm).  The rungs:

- `full`: keep nothing; the backward recomputes the layer.
- `dots`: keep every product with no batch dims (the projections); the
  attention, which is no such product, is recomputed.
- `save_attn` / `save_mlp`: keep the `attn_out` / `mlp_out` tag.
- `carry_offload`: keep both tags, in pinned host memory.

Here `checkpoint` is `torch.utils.checkpoint` (non-reentrant) with a pair
of dispatch modes as its context: in the forward `_Keep` sees every op
and holds on to the outputs the rung keeps; in the recompute `_Replay`
returns those outputs in place of running their ops again, and runs every
other op as before.  A product is `aten.mm`, `aten.addmm`, `aten.bmm` or
the flash attention op (`areal_torch::flash_attention`, whose outputs are
out and lse).  In eager PyTorch a kept tensor spares only the op that made
it, so a tag here is a region (`tag`, around the attention call and the
MLP in `DecoderLayer`) and the rung keeps the region's last product: the
flash op, or naive attention's PV product; the MLP's down projection.
Under `save_attn` and `carry_offload` the backward therefore recomputes
the norms and the q/k/v projections but launches no attention forward.
The kept outputs are the ones the recompute would make, so every rung
gives the gradients of `full` bit for bit.
"""

import contextlib
import threading
from typing import Callable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.checkpoint import checkpoint as _checkpoint

from areal_tpu_torch.ops.flash_attention import flash_attention_op  # noqa: F401 (registers it)

# each rung and the tags it keeps
_TAGS = {"full": (), "dots": (), "save_attn": ("attn_out",), "save_mlp": ("mlp_out",),
         "carry_offload": ("attn_out", "mlp_out")}
RUNGS = tuple(_TAGS)

_aten = torch.ops.aten
_DOTS = frozenset((_aten.mm.default, _aten.addmm.default))
_PRODUCTS = _DOTS | {_aten.bmm.default, torch.ops.areal_torch.flash_attention.default}

_state = threading.local()  # the forward's `_Keep`, in the thread that runs it


def _detach(x):
    return x.detach() if isinstance(x, torch.Tensor) else x


class _Host:
    """A kept tensor parked in host memory, and the device it came from."""

    __slots__ = ("tensor", "device")

    def __init__(self, x: torch.Tensor):
        # pinned, so that both copies run on the stream without a sync (a
        # plain copy for a CPU tensor)
        self.tensor = torch.empty(x.shape, dtype=x.dtype, device="cpu", pin_memory=x.is_cuda)
        self.tensor.copy_(x, non_blocking=True)
        self.device = x.device


def _to_host(x):
    return _Host(x) if isinstance(x, torch.Tensor) else x


def _from_host(x):
    return x.tensor.to(x.device, non_blocking=True) if isinstance(x, _Host) else x


class _Keep(TorchDispatchMode):
    """The forward's mode: one entry per product op, in call order, holding
    its outputs where the rung keeps them and None where it does not."""

    def __init__(self, rung: str):
        super().__init__()
        self.dots = rung == "dots"
        self.tags = _TAGS[rung]
        self.offload = rung == "carry_offload"
        self.saved: List = []
        self.region: Optional[int] = None  # first entry of the open tag region

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _PRODUCTS:
            keep = (self.dots and func in _DOTS) or self.region is not None
            self.saved.append(tree_map(_detach, out) if keep else None)
        return out

    def close_region(self) -> None:
        """Keep the region's last product (in host memory under
        carry_offload) and drop the others."""
        start, self.region = self.region, None
        last = len(self.saved) - 1
        for i in range(start, last):
            self.saved[i] = None
        if self.offload and last >= start:
            self.saved[last] = tree_map(_to_host, self.saved[last])


class _Replay(TorchDispatchMode):
    """The recompute's mode: the products `_Keep` kept come back (to the
    device) in place of running their ops; everything else runs."""

    def __init__(self, saved: List):
        super().__init__()
        self.saved = saved
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _PRODUCTS:
            i, self.n = self.n, self.n + 1
            kept = self.saved[i]
            if kept is not None:
                self.saved[i] = None  # the recomputed graph holds what it needs
                return tree_map(_from_host, kept)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _keeping(mode: _Keep):
    prev = getattr(_state, "keeper", None)
    _state.keeper = mode
    try:
        with mode:
            yield
    finally:
        _state.keeper = prev


@contextlib.contextmanager
def tag(name: str):
    """The region of a named tensor (`attn_out`, `mlp_out`): under a rung
    that keeps `name`, its last product is kept.  A no-op elsewhere (no
    checkpoint, the recompute, serving)."""
    keeper = getattr(_state, "keeper", None)
    if keeper is None or name not in keeper.tags:
        yield
        return
    keeper.region = len(keeper.saved)
    try:
        yield
    finally:
        keeper.close_region()


def check_rung(remat_policy: str) -> None:
    if remat_policy not in RUNGS:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; use 'full', 'save_attn', "
                         "'save_mlp', 'carry_offload', or 'dots'")


def checkpoint(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
               remat_policy: str) -> torch.Tensor:
    """`fn(x)` under one checkpoint boundary with the rung's policy."""
    check_rung(remat_policy)
    if remat_policy == "full":
        return _checkpoint(fn, x, use_reentrant=False)

    def context_fn():
        keep = _Keep(remat_policy)
        return _keeping(keep), _Replay(keep.saved)

    return _checkpoint(fn, x, use_reentrant=False, context_fn=context_fn)
