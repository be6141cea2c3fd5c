"""flax params tree → this package's state dict.

The port keeps every parameter in the shape flax gives it and names it by
its flax path joined with dots (models/transformer.py), so converting is
flattening the tree: ``{"layer0": {"attn": {"qkv": {"kernel": a}}}}``
becomes ``{"layer0.attn.qkv.kernel": tensor(a)}``.
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
