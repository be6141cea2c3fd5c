"""The mesh over the ranks of a ``torch.distributed`` process group.

The port of the data-parallel half of ``kubeflow_tpu/parallel/mesh.py``.
One rank drives one device, so the mesh's devices are the group's ranks
in rank order, reshaped row-major into the six axes of ``ShardingSpec``
(``data`` outermost). Only ``data`` may exceed 1 here: every rank holds
the whole model, so the collectives run over the whole group and the
mesh is its axis sizes over that group. An fsdp axis greater than 1
(which shards the params themselves) raises, as an expert, pipeline,
sequence or tensor axis does (ROADMAP Queue 1 items 6 and 11).

``data_axes``, ``replica_axes``, ``replica_degree`` and
``local_batch_size`` are the JAX package's; ``batch_rows`` names the
rows of a global batch that ``P(data_axes)`` puts on this rank: block
``rank`` of ``replica_degree`` equal blocks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch.distributed as dist

from ..api.trainingjob import ShardingSpec

MESH_AXES = ShardingSpec.AXES  # ("data", "fsdp", "expert", "pipeline",
#                                 "sequence", "tensor")
REPLICA_AXES = ("data", "fsdp")
# axes whose sharding is not ported, and the ROADMAP item that ports it
UNPORTED_AXES = {"fsdp": "Queue 1 item 6",
                 "expert": "Queue 1 item 11", "pipeline": "Queue 1 item 11",
                 "sequence": "Queue 1 item 6", "tensor": "Queue 1 item 6"}


@dataclass(frozen=True)
class Mesh:
    """Axis sizes (every axis of ``MESH_AXES``, in order) over a process
    group; ``group`` None is the one-process mesh."""

    shape: dict
    group: Any = None
    rank: int = 0

    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n


def build_mesh(sharding: Optional[ShardingSpec] = None,
               group: Any = None) -> Mesh:
    """The mesh over ``group`` (default: the world group once
    ``torch.distributed`` is initialized, else this process alone)."""
    sharding = sharding or ShardingSpec()
    if dist.is_available() and dist.is_initialized():
        group = group or dist.group.WORLD
        n, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        group, n, rank = None, 1, 0
    sizes = check_axes(sharding.resolve(n))
    return Mesh(shape={a: sizes[a] for a in MESH_AXES},
                group=group if n > 1 else None, rank=rank)


def check_axes(sizes: dict) -> dict:
    """``sizes``, or NotImplementedError for an axis whose sharding is
    not ported (greater than 1)."""
    for axis, item in UNPORTED_AXES.items():
        if sizes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"sharding axis {axis}={sizes[axis]} is not yet ported "
                f"(ROADMAP {item}); only data may exceed 1")
    return sizes


def data_axes(mesh: Mesh) -> tuple:
    """Axes over which the batch is split (everything data-parallel)."""
    return tuple(a for a in REPLICA_AXES
                 if mesh.shape.get(a, 1) > 1) or ("data",)


def replica_axes(mesh: Mesh) -> tuple:
    """Non-trivial data-parallel axes: the axes a sharded weight update
    distributes optimizer state over. No size-1 fallback: an empty tuple
    means one replica holds the whole update."""
    return tuple(a for a in REPLICA_AXES if mesh.shape.get(a, 1) > 1)


def replica_degree(mesh: Mesh) -> int:
    """Number of data-parallel replicas (product of the replica axes)."""
    n = 1
    for a in replica_axes(mesh):
        n *= mesh.shape[a]
    return n


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    dp = 1
    for a in REPLICA_AXES:
        dp *= mesh.shape.get(a, 1)
    if global_batch % dp:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data-parallel degree {dp}")
    return global_batch // dp


def batch_rows(global_batch: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch: the contiguous block ``rank``,
    the rows ``P(data_axes)`` places on device ``rank``."""
    n = local_batch_size(global_batch, mesh)
    return slice(mesh.rank * n, (mesh.rank + 1) * n)
