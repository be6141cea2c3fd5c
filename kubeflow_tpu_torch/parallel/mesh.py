"""The mesh over the ranks of a ``torch.distributed`` process group.

The port of ``kubeflow_tpu/parallel/mesh.py``. One rank drives one
device, so the mesh's devices are the group's ranks in rank order,
reshaped row-major into the six axes of ``ShardingSpec`` (``data``
outermost, ``tensor`` innermost), the order the JAX package reshapes its
device list in: rank r sits at ``Mesh.coords``, ``np.unravel_index(r,
sizes)``.

Every axis is ported. ``data`` and ``fsdp`` are the replica axes (the
batch splits over them); fsdp, expert, tensor and pipeline shard the
params by the workload's rules (``parallel/sharding_rules.py``; pipeline
the stacked ``layers`` dimension, whose stages exchange activations
point to point, ``parallel/pipeline.py``); ``sequence`` splits dimension
1 of the token batch (``Mesh.chunk_offset`` is where a rank's chunk
starts), and the params are replicated over it, so their gradients are
summed over it (``ops/ring_attention.py``, ``models/transformer.py``).

The mesh holds one process group for each axis tuple a step reduces
over (:data:`GROUP_AXES`), made by every rank in the same order; a tuple
whose nontrivial axes span the world is the world group, and one of a
single rank is None (nothing to exchange). ``data_axes``,
``replica_axes``, ``replica_degree`` and ``local_batch_size`` are the JAX
package's; ``batch_rows`` names the rows of a global batch that
``P(("data", "fsdp"))`` puts on this rank.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch.distributed as dist

from ..api.trainingjob import ShardingSpec

MESH_AXES = ShardingSpec.AXES  # ("data", "fsdp", "expert", "pipeline",
#                                 "sequence", "tensor")
REPLICA_AXES = ("data", "fsdp")
# axes that shard params
MODEL_AXES = ("fsdp", "expert", "pipeline", "tensor")
# the axis that splits the token batch's dimension 1
SEQUENCE_AXIS = "sequence"
# axes whose sharding is not ported, and the ROADMAP item that ports it
# (none left: the hook stays for the next axis)
UNPORTED_AXES: dict = {}
# the axis tuples a step reduces over, in the order every rank makes
# their groups: the replica axes (gradient sums, metrics), each axis
# alone (fsdp gathers, the data sum of an fsdp-sharded leaf, tensor
# products), the MoE combine's partial sums, the pipeline's stage hops
# and output replication, and the sequence axis (the ring's hops, the
# gathered attention, the loss's sum) with the replica axes it joins in
# the gradient sum
GROUP_AXES = (("data", "fsdp"), ("data",), ("fsdp",), ("expert",),
              ("tensor",), ("expert", "tensor"), ("pipeline",),
              ("sequence",), ("data", "fsdp", "sequence"),
              ("data", "sequence"), ("fsdp", "sequence"))


@dataclass(frozen=True)
class Mesh:
    """Axis sizes (every axis of ``MESH_AXES``, in order) over a process
    group; ``group`` None is the one-process mesh. ``groups`` maps each
    canonical axis tuple (its axes of size > 1, in mesh order) to the
    process group of this rank's ranks along it."""

    shape: dict
    group: Any = None
    rank: int = 0
    groups: dict = field(default_factory=dict, compare=False, repr=False)

    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    @property
    def coords(self) -> dict:
        """This rank's coordinate on every axis (row-major over
        ``MESH_AXES``)."""
        return rank_coords(self.rank, self.shape)

    def axes_size(self, axes) -> int:
        n = 1
        for a in axes:
            n *= self.shape.get(a, 1)
        return n

    def axes_index(self, axes) -> int:
        """This rank's row-major position over ``axes``."""
        c, i = self.coords, 0
        for a in axes:
            i = i * self.shape.get(a, 1) + c.get(a, 0)
        return i

    def group_of(self, axes) -> Any:
        """The process group of this rank's ranks along ``axes`` (None
        for one rank)."""
        key = canonical(axes, self.shape)
        if not key:
            return None
        if self.axes_size(key) == self.size():
            return self.group
        if key not in self.groups:
            raise KeyError(f"no process group over {key}: the mesh makes "
                           f"groups over {GROUP_AXES}")
        return self.groups[key]

    def chunk_offset(self, length: int) -> int:
        """Where this rank's chunk of ``length`` positions starts along
        the sequence axis: its coordinate times ``length``."""
        return self.coords[SEQUENCE_AXIS] * length

    def model_sharded(self) -> bool:
        """Whether any axis that shards params exceeds 1."""
        return any(self.shape.get(a, 1) > 1 for a in MODEL_AXES)


def canonical(axes, shape: dict) -> tuple:
    """``axes`` as a tuple of its axes of size > 1, in mesh order."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in MESH_AXES if a in axes and shape.get(a, 1) > 1)


def rank_coords(rank: int, shape: dict) -> dict:
    """The coordinates of ``rank`` on a mesh of ``shape``: row-major over
    ``MESH_AXES``, as ``np.asarray(devices).reshape(sizes)`` places
    device ``rank``."""
    idx = np.unravel_index(rank, tuple(shape[a] for a in MESH_AXES))
    return {a: int(i) for a, i in zip(MESH_AXES, idx)}


def axis_groups(shape: dict) -> list[tuple]:
    """``(axes, [ranks of each group])`` for every canonical tuple of
    ``GROUP_AXES`` over ``shape`` that is neither one rank nor the whole
    world, in a fixed order."""
    sizes = tuple(shape[a] for a in MESH_AXES)
    world = int(np.prod(sizes))
    ranks = np.arange(world).reshape(sizes)
    out, seen = [], set()
    for axes in GROUP_AXES:
        key = canonical(axes, shape)
        if not key or key in seen:
            continue
        seen.add(key)
        inner = [MESH_AXES.index(a) for a in key]
        outer = [i for i in range(len(MESH_AXES)) if i not in inner]
        flat = ranks.transpose(outer + inner).reshape(
            -1, int(np.prod([sizes[i] for i in inner])))
        if flat.shape[1] == world:
            out.append((key, None))          # the world group itself
        else:
            out.append((key, [list(map(int, r)) for r in flat]))
    return out


def build_mesh(sharding: Optional[ShardingSpec] = None) -> Mesh:
    """The mesh over the world group once ``torch.distributed`` is
    initialized (else this process alone), with its axis groups. Every
    rank calls it, in the same order (each ``new_group`` is collective
    over the world)."""
    sharding = sharding or ShardingSpec()
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        n, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        group, n, rank = None, 1, 0
    sizes = check_axes(sharding.resolve(n))
    shape = {a: sizes[a] for a in MESH_AXES}
    groups: dict = {}
    if n > 1:
        for key, parts in axis_groups(shape):
            if parts is None:
                groups[key] = group
                continue
            for ranks in parts:
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[key] = g
    return Mesh(shape=shape, group=group if n > 1 else None, rank=rank,
                groups=groups)


def check_axes(sizes: dict) -> dict:
    """``sizes``, or NotImplementedError for an axis whose sharding is
    not ported (greater than 1)."""
    for axis, item in UNPORTED_AXES.items():
        if sizes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"sharding axis {axis}={sizes[axis]} is not yet ported "
                f"(ROADMAP {item})")
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
    """This rank's rows of a global batch: the contiguous block at its
    row-major position over ``("data", "fsdp")``, the rows
    ``P(("data", "fsdp"))`` places on its device (ranks that differ only
    on a model axis read the same rows)."""
    n = local_batch_size(global_batch, mesh)
    i = mesh.axes_index(REPLICA_AXES)
    return slice(i * n, (i + 1) * n)
