"""The sharded weight update's per-leaf rule.

The port of ``weight_update_spec`` (``kubeflow_tpu/parallel/
sharding_rules.py``) for replicated params on a pure data-parallel mesh:
the first dimension divisible by the replica degree is split over the
replicas (gradients reduce-scatter into it, the optimizer state lives in
it, the new params all-gather out of it). A leaf with no such dimension
(scalars, odd sizes) stays replicated and its gradient is all-reduced: a
per-leaf fallback, not an error. Sharding rules for model-parallel axes
are not ported (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from typing import Optional, Sequence


def weight_update_dim(shape: Sequence[int], degree: int) -> Optional[int]:
    """The dimension of a leaf of ``shape`` that the update shards over
    ``degree`` replicas, or None (one replica, or no dimension divides)."""
    if degree <= 1:
        return None
    for i, dim in enumerate(shape):
        if dim and dim % degree == 0:
            return i
    return None
