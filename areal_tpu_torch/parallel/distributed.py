"""Multi-process runtime on `torch.distributed` (the port of
`areal_tpu/parallel/distributed.py`).

- `init_distributed` joins the process group under the JAX package's env
  contract, one process a rank:

    AREAL_COORDINATOR   host:port of rank 0 (the TCP rendezvous)
    AREAL_NUM_PROCESSES the number of ranks
    AREAL_PROCESS_ID    this process's rank

  With one process it does nothing.  Each rank runs on `rank_device`:
  the CPU when asked, else `cuda:(rank % device_count)`, so that ranks
  share the cards when there are more ranks than cards.
- The backend follows from that layout (`backend_for`): `nccl` when every
  rank has a card of its own; `gloo` when ranks share a card (NCCL refuses
  two ranks on one device) and on the CPU.  Nothing tries one and falls
  back to the other.
- Gloo's documented collectives on CUDA tensors are `broadcast` and
  `all_reduce` only, so every collective here is one of the two: a gather
  is an `all_reduce` of a zero buffer in which each rank wrote its own
  block (adding zeros is exact), and a sum-scatter is an `all_reduce`
  followed by the rank's own slice.  The CPU tests run the same forms.
- `broadcast_pytree` sends the head's picklable object to every rank: the
  length, then the payload, as the JAX package does (only the head knows
  the size).  `make_global_batch` is this rank's shard of a replicated
  host batch (rows over dp, sequence over sp: `parallel/mesh.py`).
- `seq_gather` is the sequence-parallel attention's K/V gather, an
  autograd function: its backward sum-scatters the gradient
  (`seq_sum_scatter`), so the dK/dV partials every shard computed over
  the whole row reach their owner.
"""

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from areal_tpu_torch.device import DeviceLike, resolve_device

ENV_COORDINATOR = "AREAL_COORDINATOR"
ENV_NUM_PROCESSES = "AREAL_NUM_PROCESSES"
ENV_PROCESS_ID = "AREAL_PROCESS_ID"


def backend_for(device_type: str, world_size: int, n_cards: int) -> str:
    """`nccl` when each of `world_size` ranks has a card of its own,
    `gloo` when ranks share a card or run on the CPU."""
    return "nccl" if device_type == "cuda" and world_size <= n_cards else "gloo"


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_head() -> bool:
    return process_index() == 0


def backend() -> Optional[str]:
    """The joined group's backend, None with one process."""
    return dist.get_backend() if dist.is_initialized() else None


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: `device` resolved as everywhere in the port
    (the card unless the caller asks for the CPU) and, with several ranks
    and no card index given, card `process_index() % device_count`."""
    dev = resolve_device(device)
    asked = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and asked.index is None and process_count() > 1:
        dev = torch.device("cuda", process_index() % torch.cuda.device_count())
    return dev


def init_distributed(device: DeviceLike = None) -> Optional[str]:
    """Join the process group the env contract above describes (a no-op
    with one process or once joined); returns the backend (None with one
    process).  `device` is the ranks' device kind ("cpu" or the card, the
    default), from which the backend follows."""
    if dist.is_initialized():
        return dist.get_backend()
    n = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    if n <= 1:
        return None
    coordinator = os.environ[ENV_COORDINATOR]
    rank = int(os.environ[ENV_PROCESS_ID])
    dev_type = torch.device("cuda" if device is None else device).type
    n_cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    name = backend_for(dev_type, n, n_cards)
    if name == "nccl":
        torch.cuda.set_device(rank % n_cards)
    dist.init_process_group(name, init_method=f"tcp://{coordinator}", world_size=n, rank=rank)
    return name


# ---------------------------------------------------------------------------
# host-side data plane
# ---------------------------------------------------------------------------


def _comm_device() -> torch.device:
    """Where host payloads travel: the CPU under gloo, this rank's card
    under nccl (which moves CUDA tensors only)."""
    return rank_device() if backend() == "nccl" else torch.device("cpu")


def broadcast_pytree(obj: Any) -> Any:
    """The head's picklable `obj` on every rank (the others pass None):
    its length, then its bytes (only the head knows the size)."""
    if process_count() == 1:
        return obj
    is_source = is_head()
    dev = _comm_device()
    payload = pickle.dumps(obj) if is_source else b""
    n = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    dist.broadcast(n, src=0)
    buf = (torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(dev) if is_source
           else torch.empty(int(n.item()), dtype=torch.uint8, device=dev))
    dist.broadcast(buf, src=0)
    return pickle.loads(buf.cpu().numpy().tobytes())


def make_global_batch(mesh, host_batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """This rank's shard of a host batch every rank holds whole (after
    `broadcast_pytree`): [R, T] arrays by rows over dp and sequence over
    sp, [R] arrays by rows."""
    return {k: mesh.shard(v) for k, v in host_batch.items()}


# ---------------------------------------------------------------------------
# collectives (broadcast and all_reduce only: see the module docstring)
# ---------------------------------------------------------------------------


def all_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group`, in place (nothing without a group)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


GRAD_BUCKET_BYTES = 256 << 20


def all_sum_grads_(params, group) -> None:
    """Sum every parameter's `.grad` over `group`, in place, a bucket of
    up to GRAD_BUCKET_BYTES (same-dtype gradients laid end to end) a
    collective, as DDP buckets them: one `all_reduce` for the many small
    tensors.  Each element is summed as alone, so the result is the
    per-tensor sum's."""
    if group is None:
        return
    bucket: list = []
    size = 0

    def flush():
        if len(bucket) == 1:  # a large tensor alone: summed where it lies
            all_sum_(bucket.pop(), group)
        elif bucket:
            flat = all_sum_(torch.cat([g.reshape(-1) for g in bucket]), group)
            for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(part.view_as(g))
            bucket.clear()

    for p in params:
        g = p.grad
        if bucket and (g.dtype != bucket[0].dtype or size + g.nbytes > GRAD_BUCKET_BYTES):
            flush()
            size = 0
        bucket.append(g)
        size += g.nbytes
    flush()


def broadcast_(t: torch.Tensor, group) -> torch.Tensor:
    """The head's (global rank 0's) `t` on every rank of `group`, in
    place (nothing without a group)."""
    if group is not None:
        dist.broadcast(t, src=0, group=group)
    return t


def gather_blocks(local: torch.Tensor, full_shape, starts, group) -> torch.Tensor:
    """Every rank's block of a [full_shape] tensor, whole on every rank: a
    zero buffer holding `local` at `starts` (one start per dim), summed
    over `group`.  Each element is one rank's value plus zeros, so the
    result is exact."""
    if group is None:
        return local
    buf = torch.zeros(tuple(full_shape), dtype=local.dtype, device=local.device)
    block = buf
    for dim, (start, n) in enumerate(zip(starts, local.shape)):
        block = block.narrow(dim, start, n)
    block.copy_(local)
    return all_sum_(buf, group)


def seq_sum_scatter(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Every rank's partial [.., T, ..] -> this rank's shard of their sum
    along `dim` ([.., T/sp, ..])."""
    if group is None:
        return x
    sp, r = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[dim] // sp
    total = all_sum_(x.contiguous().clone(), group)
    return total.narrow(dim, r * n, n).contiguous()


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        sp, r = dist.get_world_size(group), dist.get_rank(group)
        shape = list(x.shape)
        shape[dim] *= sp
        starts = [0] * x.ndim
        starts[dim] = r * x.shape[dim]
        return gather_blocks(x, shape, starts, group)

    @staticmethod
    def backward(ctx, grad):
        return seq_sum_scatter(grad, ctx.group, ctx.dim), None, None


def seq_gather(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """[.., T/sp, ..] shards along `dim` -> the whole [.., T, ..] on every
    rank of the sp `group`, in rank order.  Differentiable: the backward
    sum-scatters the gradient back to the shards (every rank's partial for
    this rank's positions, summed)."""
    if group is None:
        return x
    return _SeqGather.apply(x, group, dim)
