"""The train-step engine: one process, or one rank of a data-parallel
gang.

The port of ``TrainState`` and ``TrainStepBuilder`` in
``kubeflow_tpu/runtime/trainstep.py``. One step is forward, backward,
gradient reduction, clip and update, the same order as the JAX step,
with the global norm taken once and nothing that waits for the card on
one process; the JAX package jits it into one XLA program and donates the
state, while here it runs eagerly and updates the state in place (the
params are leaf tensors the optimizer writes, which is what donation buys
the JAX package).

- ``loss_fn(params, variables, batch, rng) -> (loss, aux)`` over a
  params dict, as in the JAX package (the model's functions use
  ``torch.func.functional_call``). Under a mesh it sees this rank's rows
  and returns their mean loss; a statistic it takes over the global batch
  (ResNet's BatchNorm) it sums across the ranks itself
  (``parallel/collectives.py`` ``global_sum``), as GSPMD computes it.
- ``optimizer`` is a factory ``params -> optimizer`` (a torch optimizer
  owns its params, so it is built in :meth:`TrainStepBuilder.init`);
  runtime/recipe.py ``make_optimizer`` makes one, a ``RecipeOptimizer``,
  whose ``step(grad_norm=...)`` takes the step's pre-clip global norm.
- ``mesh`` (``parallel/mesh.py``): with more than one replica each rank
  runs forward and backward on its block of the global batch
  (:meth:`place_batch`), then
  - ``weight_update="replicated"``: every gradient is all-reduced to the
    global mean and every rank runs the whole update;
  - ``"sharded"`` (ZeRO-2, ``kubeflow_tpu/runtime/trainstep.py:311-468``):
    ``g / n`` is reduce-scattered along each leaf's dimension
    (``parallel/sharding_rules.py``; rank r keeps block r, as
    ``psum_scatter(..., tiled=True)``), a leaf with no divisible
    dimension all-reduced; the optimizer, built over the shards, updates
    them (its state holds 1/n of the moments), the clip by the exact
    global norm (the shards' square sums all-reduced, each replicated
    leaf counted once); then one all-gather per leaf writes the new
    params. One collective per leaf.
- Metrics: ``loss``, ``grad_norm`` (the pre-clip global norm of the
  reduced gradient) and the loss function's aux (``perplexity`` for the
  LM), as device tensors. Under a mesh the loss and aux leave as the
  cross-rank mean: a nonlinear metric (perplexity = exp(loss)) carries a
  Jensen gap against the same metric over the global batch; the loss is
  exact. The ``zero2-explicit`` strategy adds ``param_sqnorm_replicas``:
  each rank's post-update param square norm, all-gathered, which agree
  absent corruption.
- Checkpoints: :func:`state_tree` turns a ``TrainState`` into a tree of
  named leaves (the step, params, variables and the optimizer state by
  leaf name, each sharded optimizer leaf as this rank's ``Shard`` of its
  global leaf); :func:`load_state_tree` loads a tree of global leaves
  back, cut along this state's layout, which may be another degree's
  (runtime/checkpoint.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..api.trainingjob import validate_weight_update
from ..parallel import collectives
from ..parallel.mesh import (MESH_AXES, Mesh, batch_rows, check_axes,
                             replica_axes, replica_degree)
from ..parallel.sharding_rules import Shard, block_of, weight_update_dim
from .bootstrap import resolve_device
from .recipe import global_norm, load_optimizer_tree, optimizer_tree

# loss_fn(params, variables, batch, rng) -> (loss, aux_dict)
LossFn = Callable[[dict, dict, dict, Any], tuple]


@dataclass
class TrainState:
    step: int
    params: dict                     # name -> leaf tensor (requires grad)
    opt_state: Any                   # the optimizer, which owns its state
    variables: dict = field(default_factory=dict)
    rng: Optional[torch.Generator] = None
    # the sharded update: name -> the leaf the optimizer updates (this
    # rank's block of the param, or the param itself when replicated)
    update_params: Optional[dict] = None
    # the sharded update: name -> the dimension its block splits (None:
    # replicated), and this rank's (index, count) of the blocks
    layout: dict = field(default_factory=dict)
    replica: tuple = (0, 1)


def state_tree(state: TrainState) -> dict:
    """The state as a checkpoint tree of named leaves, never positions:
    ``{"step", "params", "variables", "opt"}`` (``opt`` from
    :func:`~kubeflow_tpu_torch.runtime.recipe.optimizer_tree`). Params
    and variables are whole on every rank; under the sharded update each
    optimizer leaf of a split param is this rank's :class:`Shard` of the
    global leaf."""
    index, count = state.replica
    held = state.update_params or state.params
    names = {id(t): n for n, t in held.items()}

    def leaf(name: str, t: torch.Tensor):
        d = state.layout.get(name)
        return t if d is None else Shard(t, d, index, count)

    return {"step": int(state.step),
            "params": dict(state.params),
            "variables": {c: dict(vs) for c, vs in state.variables.items()},
            "opt": optimizer_tree(state.opt_state, names, leaf)}


@torch.no_grad()
def load_state_tree(state: TrainState, tree: dict) -> TrainState:
    """Load a checkpoint tree of global leaves (CPU tensors, as
    runtime/checkpoint.py reads them) into ``state`` in place, on its
    devices: the params into the leaf tensors the optimizer holds, the
    variables, and the optimizer state cut to this rank's blocks along
    this state's layout (which may split another dimension than the
    writer's). ``update_params`` is rebuilt from the restored params."""
    index, count = state.replica
    for name, p in state.params.items():
        p.copy_(tree["params"][name])
    device = next(iter(state.params.values())).device
    for col, vs in tree.get("variables", {}).items():
        held = state.variables.setdefault(col, {})
        for name, v in vs.items():
            held[name] = v.to(device, copy=True)
    if state.update_params is not None:
        for name, u in state.update_params.items():
            if u is not state.params[name]:
                u.copy_(block_of(state.params[name], state.layout[name],
                                 index, count))
    held = state.update_params or state.params
    names = {id(t): n for n, t in held.items()}
    load_optimizer_tree(
        state.opt_state, tree["opt"], names,
        lambda name, full: block_of(full, state.layout.get(name), index,
                                    count))
    state.step = int(tree["step"])
    return state


def _sum_squares(ts: list) -> torch.Tensor:
    """Σ x² over every element of ``ts``, f32, a 0-d tensor."""
    if not ts:
        return torch.zeros(())
    return torch.stack(torch._foreach_norm([t.float() for t in ts])
                       ).square().sum()


@dataclass
class TrainStepBuilder:
    """Builds the init and step functions for one training setup."""

    loss_fn: LossFn
    optimizer: Callable[[dict], Any]
    device: Any = "cuda"
    weight_update: str = "replicated"
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        validate_weight_update(self.weight_update)
        self.device = resolve_device(self.device)
        if self.mesh is None:
            self.mesh = Mesh(shape=dict.fromkeys(MESH_AXES, 1))
        check_axes(self.mesh.shape)
        self.n_rep = replica_degree(self.mesh)
        self.group = self.mesh.group if self.n_rep > 1 else None
        self.strategy = self.update_strategy()
        self.sharded = self.strategy != "replicated"
        self.layout: dict = {}          # name -> sharded dim (or None)

    def update_strategy(self, variables: Optional[dict] = None) -> str:
        """How the weight update runs: "replicated" (every rank holds the
        whole optimizer state); "zero2-explicit" (the sharded update of a
        model without mutable variables); "zero2-gspmd" (the same
        dataflow for a model with batch statistics, which its loss takes
        over the global batch). Pass the workload's ``variables`` for the
        second distinction, as the JAX package's ``update_strategy``."""
        if self.weight_update != "sharded" or not replica_axes(self.mesh):
            return "replicated"
        stateless = variables is None or not any(
            len(v) for v in variables.values())
        return "zero2-explicit" if stateless else "zero2-gspmd"

    def init(self, init_fn: Callable, rng) -> TrainState:
        """``init_fn(rng) -> (params, variables)``; params (tensors or
        numpy arrays, by name) become f32 leaf tensors on the device, and
        the optimizer is built over them (over this rank's shards under
        the sharded update). Variables (a collection name → {name:
        array}, such as ResNet's ``batch_stats``) become f32 tensors on
        the device, without gradients. Under a mesh, rank 0's params and
        variables are broadcast to every rank."""
        params, variables = init_fn(rng)
        params = {name: self._place(p) for name, p in params.items()}
        variables = {col: {name: self._place(v) for name, v in vs.items()}
                     for col, vs in variables.items()}
        if self.group is not None:
            for t in list(params.values()) + [
                    v for vs in variables.values() for v in vs.values()]:
                collectives.broadcast_(t, self.group)
        for p in params.values():
            p.requires_grad_(True)
        update_params = None
        opt_params = params
        if self.sharded:
            self.strategy = self.update_strategy(variables)
            r = self.mesh.rank
            self.layout = {name: weight_update_dim(p.shape, self.n_rep)
                           for name, p in params.items()}
            update_params = {}
            for name, p in params.items():
                d = self.layout[name]
                if d is None:
                    update_params[name] = p
                else:
                    blk = p.shape[d] // self.n_rep
                    update_params[name] = p.detach().narrow(
                        d, r * blk, blk).clone().requires_grad_(True)
            opt_params = update_params
        opt = self.optimizer(opt_params)
        if self.sharded and hasattr(opt, "shard_over"):
            opt.shard_over(self.group, [
                update_params[n] for n, d in self.layout.items()
                if d is not None])
        return TrainState(step=0, params=params, opt_state=opt,
                          variables=variables, update_params=update_params,
                          layout=dict(self.layout),
                          replica=(self.mesh.rank, self.n_rep)
                          if self.sharded else (0, 1))

    def _place(self, a) -> torch.Tensor:
        """A copy, always: on the CPU ``.to`` of an f32 array is the
        array itself, and the update would write into the caller's."""
        t = a if isinstance(a, torch.Tensor) else \
            torch.as_tensor(np.asarray(a))
        return t.detach().to(self.device, torch.float32,
                             copy=True).contiguous()

    # -- the gradient reduction ----------------------------------------------

    def _reduce_replicated(self, state: TrainState) -> torch.Tensor:
        """All-reduce every gradient to the global mean; its norm."""
        grads = [p.grad for p in state.params.values() if p.grad is not None]
        for g in grads:
            collectives.all_reduce_(g.div_(self.n_rep), self.group)
        return global_norm(grads)

    def _reduce_sharded(self, state: TrainState) -> torch.Tensor:
        """Reduce-scatter each gradient into its update leaf (all-reduce
        where the leaf is replicated); the exact global norm."""
        sharded, replicated = [], []
        for name, p in state.params.items():
            g = p.grad
            if g is None:
                continue
            d = self.layout[name]
            g = g / self.n_rep
            if d is None:
                p.grad = collectives.all_reduce_(g, self.group)
                replicated.append(p.grad)
                continue
            block = collectives.reduce_scatter(g.movedim(d, 0), self.group)
            u = state.update_params[name]
            u.grad = block.movedim(0, d).contiguous()
            p.grad = None
            sharded.append(u.grad)
        # the shards' square sums over the ranks, each replicated leaf
        # (whole and equal on every rank) counted once
        sq = _sum_squares(sharded).to(self.device)
        collectives.all_reduce_(sq, self.group)
        return torch.sqrt(sq + _sum_squares(replicated).to(self.device))

    @torch.no_grad()
    def _gather_params(self, state: TrainState) -> None:
        """One all-gather per sharded leaf writes the new params."""
        for name, d in self.layout.items():
            if d is None:
                continue
            full = collectives.all_gather(
                state.update_params[name].movedim(d, 0), self.group)
            state.params[name].copy_(full.movedim(0, d))

    def _cross_rank_mean(self, metrics: dict) -> dict:
        """The scalar metrics as their mean over the ranks, in one
        all-reduce."""
        keys = list(metrics)
        v = torch.stack([metrics[k].float().reshape(()) for k in keys])
        collectives.all_reduce_(v.div_(self.n_rep), self.group)
        return dict(zip(keys, v.unbind()))

    def build(self) -> Callable[[TrainState, dict], tuple]:
        loss_fn = self.loss_fn

        def step_fn(state: TrainState, batch: dict) -> tuple:
            with torch.enable_grad():
                loss, aux = loss_fn(state.params, state.variables, batch,
                                    state.rng)
                loss.backward()
            if self.group is None:
                grads = [p.grad for p in state.params.values()
                         if p.grad is not None]
                # the pre-clip norm, taken once: the metric, and the clip's
                grad_norm = global_norm(grads)
            elif self.sharded:
                grad_norm = self._reduce_sharded(state)
            else:
                grad_norm = self._reduce_replicated(state)
            state.opt_state.step(grad_norm=grad_norm)
            state.opt_state.zero_grad(set_to_none=True)
            if self.sharded:
                self._gather_params(state)
                for p in state.params.values():
                    p.grad = None
            state.variables = aux.pop("variables", state.variables)
            state.step += 1
            scalars = {"loss": loss.detach(),
                       **{k: v.detach() for k, v in aux.items()}}
            if self.group is not None:
                scalars = self._cross_rank_mean(scalars)
            metrics = {"loss": scalars.pop("loss"), "grad_norm": grad_norm,
                       **scalars}
            if self.strategy == "zero2-explicit":
                with torch.no_grad():
                    p2 = _sum_squares(list(state.params.values()))
                    metrics["param_sqnorm_replicas"] = \
                        collectives.all_gather(p2.reshape(1), self.group)
            return state, metrics

        return step_fn

    def build_eval(self, eval_fn: Callable[[dict, dict, dict], dict]
                   ) -> Callable[[TrainState, dict], dict]:
        """(state, batch) → metrics, without gradients. Under a mesh each
        rank evaluates its rows and the metrics leave as the mean over
        the global batch: each rank's weighted by its rows (its
        ``batch["weight"]`` sum where the batch masks padding)."""

        def step(state: TrainState, batch: dict) -> dict:
            with torch.no_grad():
                out = eval_fn(state.params, state.variables, batch)
                if self.group is None:
                    return out
                w = batch.get("weight")
                rows = w.float().sum() if w is not None else torch.tensor(
                    float(next(iter(batch.values())).shape[0]),
                    device=self.device)
                keys = list(out)
                v = torch.stack([out[k].float().reshape(()) * rows
                                 for k in keys] + [rows])
                collectives.all_reduce_(v, self.group)
                total = torch.clamp(v[-1], min=1.0)
                return {k: v[i] / total for i, k in enumerate(keys)}

        return step

    def local_rows(self, batch: dict) -> dict:
        """This rank's rows of a host batch (every rank reads the same
        global batch); the batch itself on one replica."""
        if self.group is None:
            return batch
        n = next(iter(batch.values())).shape[0]
        rows = batch_rows(n, self.mesh)
        return {k: v[rows] for k, v in batch.items()}

    def place_local(self, batch: dict) -> dict:
        """Host batch (numpy arrays or CPU tensors) → device tensors."""
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def place_batch(self, batch: dict) -> dict:
        """A global host batch → this rank's rows on the device: the
        contiguous block ``P(data_axes)`` puts on device ``rank``."""
        return self.place_local(self.local_rows(batch))
