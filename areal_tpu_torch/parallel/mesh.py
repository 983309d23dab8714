"""The device mesh of the port's train engine (the port of
`areal_tpu/parallel/mesh.py`).

The JAX package lays its chips out as one `jax.sharding.Mesh` over the
axes (dp, fsdp, ep, sp, tp), tp innermost, and GSPMD derives every
collective from the PartitionSpecs.  Here the ranks of the process group
take that layout (rank r at the C-order coordinates of r in the axis
shape) and `Mesh` carries what the engine needs to do the collectives
itself: this rank's coordinates, a process group along each axis, the
group of every rank, and `shard`, the counterpart of `batch_spec`: rows
over (dp, fsdp, ep), sequence over sp.

The port runs dp and sp.  fsdp, tp and ep > 1 raise NotImplementedError
(ROADMAP M9b); so does pipeline parallelism, as in the JAX package.
Process groups are built with `dist.new_group` on the group's own
backend: `init_device_mesh("cuda", ...)` would pick NCCL, which refuses
two ranks on one card.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch.distributed as dist

from areal_tpu_torch.api.alloc import ParallelStrategy
from areal_tpu_torch.api.config import check_ported_axes
from areal_tpu_torch.parallel import distributed

MESH_AXES = ("dp", "fsdp", "ep", "sp", "tp")
ROW_AXES = ("dp", "fsdp", "ep")  # the axes batch rows are split over


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: axis sizes and coordinates (in
    MESH_AXES order), the process group along each axis of size > 1 (None
    otherwise), and `group`, every rank of the mesh (None with one)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    group: Optional[dist.ProcessGroup]

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def sp(self) -> int:
        return self.shape["sp"]

    @property
    def row_shards(self) -> int:
        """How many ways batch rows are split (dp x fsdp x ep)."""
        return int(np.prod([self.shape[a] for a in ROW_AXES]))

    @property
    def row_rank(self) -> int:
        """This rank's row shard, (dp, fsdp, ep) flattened in order."""
        r = 0
        for a in ROW_AXES:
            r = r * self.shape[a] + self.coords[a]
        return r

    def row_slice(self, R: int) -> slice:
        n = R // self.row_shards
        return slice(self.row_rank * n, (self.row_rank + 1) * n)

    def seq_slice(self, T: int) -> slice:
        n = T // self.sp
        return slice(self.coords["sp"] * n, (self.coords["sp"] + 1) * n)

    def shard(self, x):
        """This rank's shard of a replicated [R, T] array (rows over dp,
        sequence over sp) or [R] array (rows)."""
        if x.shape[0] % self.row_shards or (x.ndim > 1 and x.shape[1] % self.sp):
            raise ValueError(f"a {tuple(x.shape)} batch does not split over "
                             f"{self.row_shards} row and {self.sp} sequence shards")
        rows = self.row_slice(x.shape[0])
        return x[rows] if x.ndim == 1 else x[rows, self.seq_slice(x.shape[1])]


def build_mesh(dp: int = 1, fsdp: int = 1, sp: int = 1, tp: int = 1, ep: int = 1) -> Mesh:
    """The mesh over every rank of the process group, which must hold
    dp x fsdp x ep x sp x tp ranks (one process: a mesh of ones).  Every
    rank must call it, in the same order as the other ranks: it creates
    the process groups of each axis."""
    check_ported_axes(fsdp, tp, ep)
    shape = dict(zip(MESH_AXES, (dp, fsdp, ep, sp, tp)))
    need = int(np.prod(list(shape.values())))
    have = distributed.process_count()
    if need != have:
        raise ValueError(f"a mesh of {shape} needs {need} ranks, the process group has {have}")
    rank = distributed.process_index()
    ranks = np.arange(need).reshape([shape[a] for a in MESH_AXES])
    coords = dict(zip(MESH_AXES, (int(c) for c in np.unravel_index(rank, ranks.shape))))
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for i, axis in enumerate(MESH_AXES):
        groups[axis] = None
        if shape[axis] == 1:
            continue
        # every line along the axis, created on every rank in one order
        for line in np.moveaxis(ranks, i, -1).reshape(-1, shape[axis]):
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    group = dist.new_group(list(range(need))) if need > 1 else None
    return Mesh(shape=shape, coords=coords, groups=groups, group=group)


def mesh_shape_from_alloc(strategy: ParallelStrategy) -> Dict[str, int]:
    """Axis sizes for an allocation-DSL strategy, as the JAX package's
    `mesh_from_alloc` sets them: s and c both land on sp, and pipeline
    parallelism is no axis."""
    if strategy.pipeline_parallel_size > 1:
        raise NotImplementedError("pipeline parallelism is not a mesh axis; use fsdp/tp/sp")
    return dict(dp=strategy.data_parallel_size, fsdp=strategy.fsdp_parallel_size,
                ep=strategy.expert_parallel_size,
                sp=strategy.sequence_parallel_size * strategy.context_parallel_size,
                tp=strategy.tensor_parallel_size)


def mesh_from_alloc(strategy: ParallelStrategy) -> Mesh:
    """`build_mesh` at an allocation-DSL strategy's axis sizes."""
    return build_mesh(**mesh_shape_from_alloc(strategy))
