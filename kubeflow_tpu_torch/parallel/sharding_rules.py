"""The sharded weight update's per-leaf rule.

The port of ``weight_update_spec`` (``kubeflow_tpu/parallel/
sharding_rules.py``) for replicated params on a pure data-parallel mesh:
the first dimension divisible by the replica degree is split over the
replicas (gradients reduce-scatter into it, the optimizer state lives in
it, the new params all-gather out of it). A leaf with no such dimension
(scalars, odd sizes) stays replicated and its gradient is all-reduced: a
per-leaf fallback, not an error. Sharding rules for model-parallel axes
are not ported (ROADMAP Queue 1 item 6). :class:`Shard` names one
rank's block of such a leaf in a checkpoint tree (runtime/checkpoint.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence


def weight_update_dim(shape: Sequence[int], degree: int) -> Optional[int]:
    """The dimension of a leaf of ``shape`` that the update shards over
    ``degree`` replicas, or None (one replica, or no dimension divides)."""
    if degree <= 1:
        return None
    for i, dim in enumerate(shape):
        if dim and dim % degree == 0:
            return i
    return None


@dataclass
class Shard:
    """This rank's block of a leaf split along ``dim`` into ``count``
    equal blocks, ``index`` its position: how the sharded update's
    optimizer state appears in a checkpoint tree. The checkpoint stores
    the leaf as its global logical array, each rank writing its own
    block, so the saved shape does not depend on the degree."""

    block: Any
    dim: int
    index: int
    count: int

    @property
    def shape(self) -> tuple:
        """The global leaf's shape."""
        shape = list(self.block.shape)
        shape[self.dim] *= self.count
        return tuple(shape)


def block_of(full, dim: Optional[int], index: int, count: int):
    """Block ``index`` of ``count`` of ``full`` along ``dim`` (the whole
    leaf when ``dim`` is None)."""
    if dim is None:
        return full
    blk = full.shape[dim] // count
    return full.narrow(dim, index * blk, blk)
