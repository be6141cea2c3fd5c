"""flax params tree → this package's state dict (the LM's, and ResNet's
params with its ``batch_stats``), a JAX ``FusedBlockWeights`` → the
port's, and JAX Adam state → the port's optimizer state.

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


def resnet_variables_from_jax(params: Mapping, batch_stats: Mapping
                              ) -> tuple[dict, dict]:
    """The flax ``ResNet`` params and ``batch_stats`` trees (numpy arrays,
    with or without their outer collection key) as the port's ``(params,
    batch_stats)``: f32 tensors under the dotted flax paths
    (``stage1_block1.Conv_0.kernel`` HWIO, ``….BatchNorm_0.mean``), the
    shapes flax gives them."""
    def flat(tree, key):
        if set(tree) == {key}:
            tree = tree[key]
        return {name: torch.from_numpy(np.array(a, dtype=np.float32))
                for name, a in flatten_params(tree).items()}

    return flat(params, "params"), flat(batch_stats, "batch_stats")


def fused_block_weights_from_jax(w):
    """A JAX ``FusedBlockWeights`` (numpy arrays, the projection fields
    possibly None) as the port's
    :class:`~kubeflow_tpu_torch.ops.fused_block.FusedBlockWeights`: f32
    tensors of the same shapes."""
    from ..ops.fused_block import FusedBlockWeights
    fields = ("w1", "s1", "b1", "w2", "s2", "b2", "w3", "s3", "b3", "wp",
              "sp", "bp")
    return FusedBlockWeights(**{
        f: None if getattr(w, f) is None else torch.from_numpy(
            np.array(getattr(w, f), dtype=np.float32)) for f in fields})


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
