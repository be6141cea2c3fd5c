"""The train-step engine for one device, replicated.

The port of ``TrainState`` and ``TrainStepBuilder`` in
``kubeflow_tpu/runtime/trainstep.py``. One step is forward, backward,
clip and update, the same order as the JAX step; the JAX package jits it
into one XLA program and donates the state, while here it runs eagerly
and updates the state in place (the params are leaf tensors the
optimizer writes, which is what donation buys the JAX package).

- ``loss_fn(params, variables, batch, rng) -> (loss, aux)`` over a
  params dict, as in the JAX package (the model's functions use
  ``torch.func.functional_call``).
- ``optimizer`` is a factory ``params -> optimizer`` (a torch optimizer
  owns its params, so it is built in :meth:`TrainStepBuilder.init`);
  runtime/recipe.py ``make_optimizer`` makes one.
- Metrics: ``loss``, ``grad_norm`` (the pre-clip global norm) and the loss
  function's aux (``perplexity`` for the LM), as device tensors.

``weight_update="sharded"`` (ZeRO-2) and more than one device raise "not
yet ported" (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..api.trainingjob import validate_weight_update
from .bootstrap import resolve_device
from .recipe import global_norm

# loss_fn(params, variables, batch, rng) -> (loss, aux_dict)
LossFn = Callable[[dict, dict, dict, Any], tuple]


@dataclass
class TrainState:
    step: int
    params: dict                     # name -> leaf tensor (requires grad)
    opt_state: Any                   # the optimizer, which owns its state
    variables: dict = field(default_factory=dict)
    rng: Optional[torch.Generator] = None


@dataclass
class TrainStepBuilder:
    """Builds the init and step functions for one training setup."""

    loss_fn: LossFn
    optimizer: Callable[[dict], Any]
    device: Any = "cuda"
    weight_update: str = "replicated"
    num_devices: int = 1

    def __post_init__(self):
        validate_weight_update(self.weight_update)
        if self.weight_update == "sharded":
            raise NotImplementedError(
                "weight_update='sharded' (ZeRO-2) is not yet ported "
                "(ROADMAP Queue 1 item 3)")
        if self.num_devices != 1:
            raise NotImplementedError(
                f"{self.num_devices} devices: data parallelism is not yet "
                f"ported (ROADMAP Queue 1 item 3)")
        self.device = resolve_device(self.device)

    def init(self, init_fn: Callable, rng) -> TrainState:
        """``init_fn(rng) -> (params, variables)``; params (tensors or
        numpy arrays, by name) become f32 leaf tensors on the device, and
        the optimizer is built over them. Variables (a collection name →
        {name: array}, such as ResNet's ``batch_stats``) become f32
        tensors on the device, without gradients."""
        params, variables = init_fn(rng)
        params = {name: self._place(p).requires_grad_(True)
                  for name, p in params.items()}
        variables = {col: {name: self._place(v) for name, v in vs.items()}
                     for col, vs in variables.items()}
        return TrainState(step=0, params=params,
                          opt_state=self.optimizer(params),
                          variables=variables)

    def _place(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else \
            torch.as_tensor(np.asarray(a))
        return t.to(self.device, torch.float32).detach()

    def build(self) -> Callable[[TrainState, dict], tuple]:
        loss_fn = self.loss_fn

        def step_fn(state: TrainState, batch: dict) -> tuple:
            with torch.enable_grad():
                loss, aux = loss_fn(state.params, state.variables, batch,
                                    state.rng)
                loss.backward()
            grads = [p.grad for p in state.params.values()
                     if p.grad is not None]
            grad_norm = global_norm(grads)
            state.opt_state.step()
            state.opt_state.zero_grad(set_to_none=True)
            state.variables = aux.pop("variables", state.variables)
            state.step += 1
            metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
                       **{k: v.detach() for k, v in aux.items()}}
            return state, metrics

        return step_fn

    def build_eval(self, eval_fn: Callable[[dict, dict, dict], dict]
                   ) -> Callable[[TrainState, dict], dict]:
        """(state, batch) → metrics, without gradients."""

        def step(state: TrainState, batch: dict) -> dict:
            with torch.no_grad():
                return eval_fn(state.params, state.variables, batch)

        return step

    def place_batch(self, batch: dict) -> dict:
        """Host batch (numpy arrays or CPU tensors) → device tensors."""
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}
