"""Logical-axis sharding rules: parameter names → mesh axes → blocks.

The port of ``kubeflow_tpu/parallel/sharding_rules.py``. Models annotate
each parameter with *logical* axis names ("embed", "mlp", "heads",
"vocab", "expert", ...); a :class:`LogicalRules` table maps logical axes
to mesh axes (or None, replicated). A spec is a tuple with one entry per
leading dimension: None, a mesh axis, or a tuple of mesh axes (the
dimension is split over their product, the first axis major), trailing
Nones dropped, as ``PartitionSpec`` holds them.

One rank holds one block of each leaf: along each dimension, block
``row-major index of the rank's coordinates on the entry's axes`` of
``product of their sizes`` equal blocks, the tiling GSPMD gives a
``NamedSharding`` over the same mesh (:func:`block_index`,
:func:`cut_block`). :class:`Shard` names such a block in a checkpoint
tree (runtime/checkpoint.py).

:func:`weight_update_spec` is the per-leaf rule of the sharded weight
update (ZeRO-2): one more dimension, still unsharded and divisible,
split over the replica axes the leaf's spec leaves free.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Union

AxisTarget = Union[str, tuple, None]


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry, in order (``()`` for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Sequence) -> set:
    """Every mesh axis a spec uses."""
    return {a for e in spec for a in entry_axes(e)}


class LogicalRules:
    """Ordered mapping logical-axis name → mesh axis (or axes, or None).

    ``dcn_unsafe`` names logical axes whose sharding is dropped on a
    multi-slice mesh (:meth:`dcn_aware`): a gather-indexed table
    dimension (the tok_embed vocabulary) sharded over tensor would be
    gathered whole across the slow inter-slice link every step."""

    def __init__(self, rules: Sequence[tuple[str, AxisTarget]],
                 dcn_unsafe: Sequence[str] = ()):
        self.rules = list(rules)
        self._map = dict(self.rules)
        self.dcn_unsafe = tuple(dcn_unsafe)

    def dcn_aware(self, num_slices: int) -> "LogicalRules":
        """The rules on a ``num_slices``-slice mesh: on one slice,
        itself; across slices, a copy with every ``dcn_unsafe`` logical
        axis replicated."""
        if num_slices <= 1 or not self.dcn_unsafe:
            return self
        unsafe = set(self.dcn_unsafe)
        return LogicalRules(
            [(name, None if name in unsafe else target)
             for name, target in self.rules],
            dcn_unsafe=self.dcn_unsafe)

    def spec_for(self, logical_axes: Sequence[Optional[str]],
                 mesh_shape: Optional[dict] = None) -> tuple:
        """The spec of a param annotated with ``logical_axes``. Mesh axes
        of size 1 (or absent from ``mesh_shape``) are dropped; a mesh axis
        shards at most one dimension of a param (the first wins, later
        dimensions replicate), as GSPMD requires."""
        used: set = set()
        out: list = []
        for ax in logical_axes:
            target = self._map.get(ax) if ax is not None else None
            kept = []
            for t in entry_axes(target):
                if mesh_shape is not None and mesh_shape.get(t, 1) <= 1:
                    continue
                if t in used:
                    continue
                kept.append(t)
                used.add(t)
            out.append(tuple(kept) if len(kept) > 1
                       else (kept[0] if kept else None))
        while out and out[-1] is None:
            out.pop()
        return tuple(out)


def weight_update_spec(spec: Sequence, shape: Sequence[int],
                       mesh_shape: dict, axes: Sequence[str]
                       ) -> Optional[tuple]:
    """``spec`` with ONE more dimension sharded over ``axes``: the
    per-leaf rule of the sharded weight update (gradients reduce-scatter
    into it, the optimizer state lives in it, the new params all-gather
    out of it). Axes the spec already uses are skipped (an fsdp-sharded
    leaf's update is distributed already); the first dimension still
    unsharded and divisible by the product of the remaining axes wins.
    None when no axis remains or no dimension qualifies: the leaf keeps
    its param spec, a per-leaf fallback, not an error."""
    used = spec_axes(spec)
    free = tuple(a for a in axes
                 if a not in used and mesh_shape.get(a, 1) > 1)
    if not free:
        return None
    degree = 1
    for a in free:
        degree *= mesh_shape[a]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, dim in enumerate(shape):
        if entries[i] is None and dim and dim % degree == 0:
            entries[i] = free if len(free) > 1 else free[0]
            while entries[-1] is None:
                entries.pop()
            return tuple(entries)
    return None


def block_index(spec: Sequence, ndim: int, mesh_shape: dict,
                coords: dict) -> tuple[tuple, tuple]:
    """``(index, count)`` per dimension of a rank's block of a leaf of
    rank ``ndim`` under ``spec``: along each dimension the row-major
    position of the rank's coordinates on the entry's axes, among the
    product of their sizes."""
    index, count = [], []
    for d in range(ndim):
        i, n = 0, 1
        for a in entry_axes(spec[d] if d < len(spec) else None):
            i = i * mesh_shape[a] + coords[a]
            n *= mesh_shape[a]
        index.append(i)
        count.append(n)
    return tuple(index), tuple(count)


def cut(full, index: Sequence[int], count: Sequence[int]):
    """Block ``index`` of ``full`` split into ``count`` equal blocks per
    dimension (a view)."""
    out = full
    for d, (i, n) in enumerate(zip(index, count)):
        if n > 1:
            if full.shape[d] % n:
                raise ValueError(f"dimension {d} of {tuple(full.shape)} "
                                 f"does not split into {n} blocks")
            b = full.shape[d] // n
            out = out.narrow(d, i * b, b)
    return out


def cut_block(full, spec: Sequence, mesh_shape: dict, coords: dict):
    """The block of ``full`` a rank at ``coords`` holds under ``spec``."""
    return cut(full, *block_index(spec, full.dim(), mesh_shape, coords))


@dataclass
class Shard:
    """This rank's block of a leaf split into ``count[d]`` equal blocks
    along each dimension ``d``, ``index`` its position: how a sharded
    param or optimizer leaf appears in a checkpoint tree. The checkpoint
    stores the leaf as its global array, each block written once, by the
    rank with ``writer`` set (among the ranks that hold the same block),
    so the saved shape does not depend on the mesh."""

    block: Any
    index: tuple
    count: tuple
    writer: bool = True

    @property
    def shape(self) -> tuple:
        """The global leaf's shape."""
        return tuple(s * n for s, n in zip(self.block.shape, self.count))


# Default rule tables (the JAX package's). "embed" is the fsdp weight-
# sharding axis; the Megatron dimensions (mlp, heads, vocab) split over
# tensor; expert weights over expert.
TRANSFORMER_RULES = LogicalRules([
    ("batch", ("data", "fsdp")),
    ("sequence", "sequence"),
    ("embed", "fsdp"),
    ("mlp", "tensor"),
    ("heads", "tensor"),
    ("kv", None),
    ("head_dim", None),
    ("vocab", "tensor"),
    # the gather-indexed table dimension (tok_embed's vocabulary): over
    # tensor on one slice, replicated across slices (dcn_aware)
    ("vocab_table", "tensor"),
    ("expert", "expert"),
    ("stage", "pipeline"),
    ("layers", "pipeline"),
], dcn_unsafe=("vocab_table",))
