"""flax params tree → this package's state dict (the LM's, and ResNet's
params with its ``batch_stats``), a JAX ``FusedBlockWeights`` → the
port's, and a JAX recipe optimizer's state → the port's optimizer state
(Adam's alone, or any family as a checkpoint tree).

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


def _jax_states(state) -> list:
    """Every optax state namedtuple inside a (nested tuple) chain state."""
    if hasattr(state, "_fields"):
        out = [state]
        for f in state._fields:
            out += _jax_states(getattr(state, f))
        return out
    if isinstance(state, (tuple, list)):
        return [s for x in state for s in _jax_states(x)]
    return []


def optimizer_tree_from_jax(opt_state, optimizer: str,
                            kernels: str = "stock",
                            runtime_schedule: bool = False) -> dict:
    """A JAX recipe optimizer's state (``kubeflow_tpu/runtime/recipe.py``
    ``make_optimizer``'s chain, numpy arrays) as the port's checkpoint
    tree of the same recipe (``runtime/recipe.py`` ``optimizer_tree``):
    ``{"count": {...}, "slots": {slot: {name: tensor}}, "extra": {...}}``
    under the dotted param names, in the slots of the optimizer the port
    builds for that recipe — :class:`FusedAdam` (``mu``, ``nu``),
    ``ChainOptimizer`` (``trace``; rmsprop's ``nu``; adam's ``step``,
    ``mu``, ``nu``; the runtime schedule's scalars), ``torch.optim.SGD``
    (``momentum_buffer``) or ``Adam``/``AdamW`` (``step``, ``exp_avg``,
    ``exp_avg_sq``). Covers sgd, momentum, nesterov, adam, adamw, lars
    and rmsprop."""
    def tree(t) -> dict:
        if set(t) == {"params"}:
            t = t["params"]
        return {n: torch.from_numpy(np.array(a, dtype=np.float32))
                for n, a in flatten_params(t).items()}

    found: dict = {}
    for st in _jax_states(opt_state):
        kind = type(st).__name__
        if kind == "TraceState":
            found["trace"] = tree(st.trace)
        elif kind == "ScaleByRmsState":
            found["rms_nu"] = tree(st.nu)
        elif kind in ("ScaleByAdamState", "FusedAdamState"):
            found["adam"] = (int(np.asarray(st.count)), tree(st.mu),
                             tree(st.nu))
        elif kind == "ScaleByScheduleState":
            found["count"] = int(np.asarray(st.count))
        elif kind == "RuntimeLRState":
            found["runtime"] = st
    slots: dict = {}
    out: dict = {"count": {}, "slots": slots, "extra": {}}
    runtime = found.get("runtime")
    count = int(np.asarray(runtime.count)) if runtime is not None else \
        found.get("count", found.get("adam", (0,))[0])
    out["count"]["schedule"] = count
    chain = runtime_schedule or optimizer in ("lars", "rmsprop")
    if kernels == "fused_adam":
        adam_count, slots["mu"], slots["nu"] = found["adam"]
        out["count"]["inner"] = adam_count
    elif chain:
        if "trace" in found:
            slots["trace"] = found["trace"]
        if "rms_nu" in found:
            slots["nu"] = found["rms_nu"]
        if "adam" in found:
            adam_count, slots["mu"], slots["nu"] = found["adam"]
            slots["step"] = {n: torch.tensor(float(adam_count))
                             for n in slots["mu"]}
        if runtime is not None:
            out["extra"]["runtime_lr"] = {
                "count": torch.tensor(int(np.asarray(runtime.count)),
                                      dtype=torch.int32),
                **{f: torch.tensor(float(np.asarray(getattr(runtime, f))),
                                   dtype=torch.float32)
                   for f in ("base_lr", "warmup_steps", "total_steps")}}
    elif "adam" in found:
        adam_count, mu, nu = found["adam"]
        slots.update(exp_avg=mu, exp_avg_sq=nu,
                     step={n: torch.tensor(float(adam_count)) for n in mu})
    elif "trace" in found:
        slots["momentum_buffer"] = found["trace"]
    return out
