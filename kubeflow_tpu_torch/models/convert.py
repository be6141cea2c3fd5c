"""flax params tree → this package's state dict, and JAX Adam state → the
port's optimizer state.

The port keeps every parameter in the shape flax gives it and names it by
its flax path joined with dots (models/transformer.py), so converting is
flattening the tree: ``{"layer0": {"attn": {"qkv": {"kernel": a}}}}``
becomes ``{"layer0.attn.qkv.kernel": tensor(a)}``. Adam's moments are
params-shaped trees and convert the same way.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def flatten_params(params: Mapping, prefix: str = "") -> dict:
    """Nested dicts of arrays → ``{"a.b.c": np.ndarray}``."""
    out = {}
    for key, value in params.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(flatten_params(value, prefix=f"{name}."))
        else:
            out[name] = np.asarray(value)
    return out


def transformer_params_from_jax(params: Mapping) -> dict:
    """The flax ``TransformerLM`` params (nested dicts of numpy arrays,
    with or without the outer ``{"params": ...}``) as a state dict for
    :class:`kubeflow_tpu_torch.models.transformer.TransformerLM`: f32
    tensors under the dotted flax paths."""
    if set(params) == {"params"}:
        params = params["params"]
    return {name: torch.from_numpy(np.array(a, dtype=np.float32))
            for name, a in flatten_params(params).items()}


def adam_state_from_jax(state) -> dict:
    """A JAX Adam state — ``FusedAdamState`` or optax ``ScaleByAdamState``,
    anything with ``count``, ``mu`` and ``nu`` (numpy arrays, params-shaped
    trees) — as the port's: ``{"count": int, "mu": {name: f32 tensor},
    "nu": {name: f32 tensor}}`` under the dotted param names. A
    :class:`~kubeflow_tpu_torch.ops.fused_adam.FusedAdam` takes it as
    ``opt.count = s["count"]`` and ``opt.state[p] = {"mu": ..., "nu":
    ...}`` for the param ``p`` of each name."""
    def moments(tree) -> dict:
        if set(tree) == {"params"}:
            tree = tree["params"]
        return {name: torch.from_numpy(np.array(a, dtype=np.float32))
                for name, a in flatten_params(tree).items()}

    return {"count": int(np.asarray(state.count)),
            "mu": moments(state.mu), "nu": moments(state.nu)}
