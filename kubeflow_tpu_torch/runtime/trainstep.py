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
  (:meth:`place_batch`; ranks that differ only on a model axis read the
  same rows), then
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
- Model parallelism (``rules`` and ``param_logical_axes``, the JAX
  package's names): on a mesh whose fsdp, tensor or expert axis exceeds
  1, each rank holds its block of each param, cut by
  ``rules.spec_for(axes, mesh)`` (``parallel/sharding_rules.py``), and the
  loss function (the workload's, built for the same mesh) runs the
  collectives of its forward and backward. After the backward each
  block's gradient is summed over the replica axes its spec leaves free
  (the fsdp sum happened in the backward's reduce-scatter) and divided
  by the replica degree; under ``"sharded"`` (the port of the JAX
  package's ``zero2-gspmd``) ``weight_update_spec`` splits one more
  dimension of the block over those axes. The clip takes the exact
  global norm: each block's square sum weighted by one over the number
  of ranks that hold the same block, all-reduced over the world in one
  call. A mesh with a model axis above 1 and a workload without rules
  raises.
- Sequence parallelism (``sequence`` above 1): a rank reads its rows
  and, of every array of rank exactly 2 (the tokens), its chunk of
  dimension 1, plus the column after the chunk under ``next_<key>`` (the
  next-token target of the chunk's last position); an array of any
  other rank keeps its rows' whole extent (:meth:`local_rows`, the JAX
  package's ``place_batch``: ResNet's images are whole on every
  sequence rank). The loss function returns the rows' loss over the
  whole sequence, the same on every sequence rank, so the metrics need
  no sum over the axis. Params are replicated over it: every gradient
  is summed over ``sequence`` with its replica axes (the divisor stays
  the replica degree), and the sharded update's domain stays ``data`` x
  ``fsdp``. The loss's backward is therefore this rank's share: the
  LM's own chunk's term, and a term every sequence rank computes whole
  (ResNet's loss, the MoE aux loss) divided by the axis's size
  (``parallel/collectives.py`` ``once_over``), so the sum counts it
  once.
- Pipeline parallelism (``pipeline`` above 1, the stacked LM): a rank's
  stacked leaves are its stage's layers, cut by the same rules
  (``("layers", "pipeline")``), and pipeline is no replica axis, so no
  gradient is summed over it here: the stage's blocks are its own, the
  embedding's gradient is summed over the stages inside the schedule
  (parallel/pipeline.py), and the head runs alike on every stage.
  :class:`MultisliceTrainStepBuilder` is the MPMD engine behind the same
  surface (parallel/multislice.py).
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
  leaf name, each model-sharded param and each split optimizer leaf as
  this rank's ``Shard`` of its global leaf); :func:`load_state_tree`
  loads a tree of global leaves back, cut along this state's layout,
  which may be another degree's or mesh's (runtime/checkpoint.py), into
  the state's own storage. Both take the MPMD engine's
  ``MultisliceState`` too (:func:`multislice_state_tree`,
  :func:`load_multislice_state_tree`).
- The AOT step (:meth:`TrainStepBuilder.build_compiled`, the counterpart
  of the JAX package's compiled step executable): the whole step captured
  as one CUDA graph and replayed, one host call a step
  (:class:`CompiledStep`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..api.trainingjob import validate_weight_update
from ..parallel import collectives
from ..parallel.multislice import MultisliceState
from ..parallel.mesh import (MESH_AXES, SEQUENCE_AXIS, Mesh, batch_rows,
                             check_axes, replica_axes, replica_degree)
from ..parallel.sharding_rules import (Shard, block_index, cut, entry_axes,
                                       spec_axes, weight_update_spec)
from .bootstrap import resolve_device
from .recipe import (CaptureError, global_norm, load_optimizer_tree,
                     optimizer_tree)

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
    # name -> (index, count, writer) of this rank's block of the global
    # leaf, per dimension: the params under model parallelism, and the
    # leaves the optimizer updates (its state's shape); absent: whole
    param_blocks: dict = field(default_factory=dict)
    update_blocks: dict = field(default_factory=dict)


def state_tree(state: TrainState) -> dict:
    """The state as a checkpoint tree of named leaves, never positions:
    ``{"step", "params", "variables", "opt"}`` (``opt`` from
    :func:`~kubeflow_tpu_torch.runtime.recipe.optimizer_tree`). Variables
    are whole on every rank; a model-sharded param, and each optimizer
    leaf of a split update leaf, is this rank's :class:`Shard` of the
    global leaf. A ``MultisliceState`` goes to
    :func:`multislice_state_tree`."""
    if isinstance(state, MultisliceState):
        return multislice_state_tree(state)
    held = state.update_params or state.params
    names = {id(t): n for n, t in held.items()}

    def leaf(name: str, t: torch.Tensor):
        b = state.update_blocks.get(name)
        return t if b is None else Shard(t, *b)

    return {"step": int(state.step),
            "params": {n: Shard(p, *state.param_blocks[n])
                       if n in state.param_blocks else p
                       for n, p in state.params.items()},
            "variables": {c: dict(vs) for c, vs in state.variables.items()},
            "opt": optimizer_tree(state.opt_state, names, leaf)}


@torch.no_grad()
def load_state_tree(state: TrainState, tree: dict) -> TrainState:
    """Load a checkpoint tree of global leaves (CPU tensors, as
    runtime/checkpoint.py reads them) into ``state`` in place, on its
    devices: the params into the leaf tensors the optimizer holds, the
    variables, and the optimizer state cut to this rank's blocks along
    this state's layout (which may split another dimension, or another
    mesh, than the writer's). ``update_params`` is rebuilt from the
    restored params. A ``MultisliceState`` goes to
    :func:`load_multislice_state_tree`."""
    if isinstance(state, MultisliceState):
        return load_multislice_state_tree(state, tree)

    def block(blocks: dict, name: str, full: torch.Tensor):
        b = blocks.get(name)
        return full if b is None else cut(full, b[0], b[1])

    for name, p in state.params.items():
        p.copy_(block(state.param_blocks, name, tree["params"][name]))
    device = next(iter(state.params.values())).device
    for col, vs in tree.get("variables", {}).items():
        held = state.variables.setdefault(col, {})
        for name, v in vs.items():
            # into the tensor the state holds (a captured step reads its
            # storage), a new one where there is none of that shape
            t = held.get(name)
            if t is not None and t.shape == v.shape and t.dtype == v.dtype:
                t.copy_(v)
            else:
                held[name] = v.to(device, copy=True)
    if state.update_params is not None:
        for name, u in state.update_params.items():
            if u is not state.params[name]:
                u.copy_(block(state.update_blocks, name,
                              tree["params"][name]))
    held = state.update_params or state.params
    names = {id(t): n for n, t in held.items()}
    load_optimizer_tree(
        state.opt_state, tree["opt"], names,
        lambda name, full: block(state.update_blocks, name, full))
    state.step = int(tree["step"])
    return state


def multislice_state_tree(state: MultisliceState) -> dict:
    """The MPMD state as a checkpoint tree: ``{"step", "stages": {"<s>":
    {"params", "opt"}}}``, each stage's params (its
    chunk of the stacked blocks under their names, stage 0's embedding
    and the last stage's head) and its optimizer's tree
    (:func:`~kubeflow_tpu_torch.runtime.recipe.optimizer_tree`: K3's
    moments and count on the fused_adam recipe), whole leaves from the
    one process that drives every stage."""
    stages = {}
    for s, (params, opt) in enumerate(zip(state.params, state.opt_state)):
        names = {id(p): n for n, p in params.items()}
        stages[str(s)] = {"params": dict(params),
                          "opt": optimizer_tree(opt, names,
                                                lambda n, t: t)}
    return {"step": int(state.step), "stages": stages}


@torch.no_grad()
def load_multislice_state_tree(state: MultisliceState,
                               tree: dict) -> MultisliceState:
    """Load :func:`multislice_state_tree`'s tree (CPU leaves) into
    ``state`` in place, each stage on its device. A tree of another
    number of stages raises, as the JAX template restore cannot take
    another list structure: the stages' chunks would not line up."""
    stages = tree.get("stages", {})
    if len(stages) != len(state.params):
        raise ValueError(
            f"the checkpoint holds {len(stages)} MPMD stages and this "
            f"run has {len(state.params)}: a restore onto another number "
            f"of slices is not supported; resume with numSlices="
            f"{len(stages)}")
    for s, (params, opt) in enumerate(zip(state.params, state.opt_state)):
        saved = stages[str(s)]["params"]
        for n, p in params.items():
            if n not in saved or tuple(saved[n].shape) != tuple(p.shape):
                raise ValueError(
                    f"stage {s} param {n}: {tuple(p.shape)} in this run, "
                    f"{None if n not in saved else tuple(saved[n].shape)} "
                    f"in the checkpoint")
            p.copy_(saved[n])
        load_optimizer_tree(opt, stages[str(s)]["opt"],
                            {id(p): n for n, p in params.items()},
                            lambda n, full: full)
    state.step = int(tree["step"])
    return state


def _writer(mesh: Mesh, used: set) -> bool:
    """Whether this rank writes its block: the first (coordinate 0 on
    every axis the block is not split on) of the ranks holding it."""
    return all(c == 0 for a, c in mesh.coords.items() if a not in used)


def _dense(a):
    """A contiguous copy of a strided slice (numpy or torch)."""
    return a.contiguous() if isinstance(a, torch.Tensor) else \
        np.ascontiguousarray(a)


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
    # the workload's sharding rules and name -> logical axes; None =
    # every param replicated
    rules: Optional[Any] = None
    param_logical_axes: Optional[dict] = None

    def __post_init__(self):
        validate_weight_update(self.weight_update)
        self.device = resolve_device(self.device)
        if self.mesh is None:
            self.mesh = Mesh(shape=dict.fromkeys(MESH_AXES, 1))
        check_axes(self.mesh.shape)
        if self.mesh.model_sharded() and (
                self.rules is None or self.param_logical_axes is None):
            axes = {a: n for a, n in self.mesh.shape.items() if n > 1}
            raise ValueError(
                f"mesh {axes} shards the params by the workload's sharding "
                f"rules, and this workload carries none (rules or "
                f"param_logical_axes is None); only data may exceed 1")
        self.n_rep = replica_degree(self.mesh)
        self.world = self.mesh.size()
        self.group = self.mesh.group_of(replica_axes(self.mesh)) \
            if self.n_rep > 1 else None
        self.seq = self.mesh.shape.get(SEQUENCE_AXIS, 1)
        self.strategy = self.update_strategy()
        self.sharded = self.strategy != "replicated"
        # name -> (dimension, axes) of the update's split (None: the
        # param's block), name -> replica axes its gradient sums over,
        # name -> ranks that hold the same update block
        self.layout: dict = {}
        self.reduce_axes: dict = {}
        self.copies: dict = {}

    def param_spec(self, name: str) -> tuple:
        """The spec of param ``name`` on this mesh (() = replicated)."""
        if self.rules is None or self.param_logical_axes is None:
            return ()
        return self.rules.spec_for(self.param_logical_axes[name],
                                   self.mesh.shape)

    def update_strategy(self, variables: Optional[dict] = None) -> str:
        """How the weight update runs: "replicated" (every rank holds the
        whole optimizer state of its params); "zero2-explicit" (the
        sharded update of replicated params of a model without mutable
        variables); "zero2-gspmd" (the same dataflow for a model with
        batch statistics, which its loss takes over the global batch, or
        for model-sharded params). Pass the workload's ``variables`` for
        the BatchNorm distinction, as the JAX package's
        ``update_strategy``."""
        if self.weight_update != "sharded" or not replica_axes(self.mesh):
            return "replicated"
        stateless = variables is None or not any(
            len(v) for v in variables.values())
        return "zero2-explicit" if stateless and \
            not self.mesh.model_sharded() else "zero2-gspmd"

    def init(self, init_fn: Callable, rng) -> TrainState:
        """``init_fn(rng) -> (params, variables)``; params (tensors or
        numpy arrays, by name) become f32 leaf tensors on the device, and
        the optimizer is built over them (over this rank's shards under
        the sharded update). Variables (a collection name → {name:
        array}, such as ResNet's ``batch_stats``) become f32 tensors on
        the device, without gradients. Under a mesh, rank 0's params and
        variables are broadcast to every rank, and each rank keeps its
        block of each model-sharded param: placed, broadcast and cut one
        leaf at a time, so the device holds one whole leaf beside the
        blocks, never the whole model."""
        params, variables = init_fn(rng)
        params = dict(params)     # the caller's dict stays as it was
        mesh = self.mesh

        def placed(a) -> torch.Tensor:
            t = self._place(a)
            if self.world > 1:
                collectives.broadcast_(t, mesh.group)
            return t

        coords = mesh.coords
        free = replica_axes(mesh)
        param_blocks, update_blocks = {}, {}
        for name in list(params):
            full = placed(params[name])
            shape = full.shape
            spec = self.param_spec(name)
            index, count = block_index(spec, full.dim(), mesh.shape, coords)
            used = spec_axes(spec)
            params[name] = full
            if any(n > 1 for n in count):
                params[name] = cut(full, index, count).clone()
                param_blocks[name] = (index, count, _writer(mesh, used))
            del full
            uspec = weight_update_spec(spec, shape, mesh.shape, free) \
                if self.sharded else None
            if uspec is not None:
                d = next(i for i, e in enumerate(uspec) if e is not None
                         and (i >= len(spec) or e != spec[i]))
                axes = entry_axes(uspec[d])
                self.layout[name] = (d, axes)
                used = spec_axes(uspec)
                uidx, ucnt = list(index), list(count)
                uidx[d], ucnt[d] = mesh.axes_index(axes), mesh.axes_size(axes)
                update_blocks[name] = (tuple(uidx), tuple(ucnt),
                                       _writer(mesh, used))
            else:
                self.layout[name] = None
                if name in param_blocks:
                    update_blocks[name] = param_blocks[name]
            # params are replicated over sequence: summed over it too
            self.reduce_axes[name] = tuple(a for a in free if a not in
                                           spec_axes(spec)) + \
                ((SEQUENCE_AXIS,) if self.seq > 1 else ())
            self.copies[name] = self.world // mesh.axes_size(used)
        variables = {col: {name: placed(v) for name, v in vs.items()}
                     for col, vs in variables.items()}
        for p in params.values():
            p.requires_grad_(True)
        update_params = None
        opt_params = params
        if self.sharded:
            self.strategy = self.update_strategy(variables)
            update_params = {}
            for name, p in params.items():
                lay = self.layout[name]
                if lay is None:
                    update_params[name] = p
                else:
                    d, axes = lay
                    blk = p.shape[d] // mesh.axes_size(axes)
                    update_params[name] = p.detach().narrow(
                        d, mesh.axes_index(axes) * blk,
                        blk).clone().requires_grad_(True)
            opt_params = update_params
        opt = self.optimizer(opt_params)
        # LARS's per-tensor norms sum each split leaf's blocks over the
        # world: a block that c ranks hold counts c times in both ‖p‖ and
        # ‖u‖, which its trust ratio cancels
        split = [n for n in params if self.copies[n] < self.world]
        if split and hasattr(opt, "shard_over"):
            opt.shard_over(mesh.group, [opt_params[n] for n in split])
        return TrainState(step=0, params=params, opt_state=opt,
                          variables=variables, update_params=update_params,
                          param_blocks=param_blocks,
                          update_blocks=update_blocks)

    def _place(self, a) -> torch.Tensor:
        """A copy, always: on the CPU ``.to`` of an f32 array is the
        array itself, and the update would write into the caller's."""
        t = a if isinstance(a, torch.Tensor) else \
            torch.as_tensor(np.asarray(a))
        return t.detach().to(self.device, torch.float32,
                             copy=True).contiguous()

    # -- the gradient reduction ----------------------------------------------

    def _reduce(self, state: TrainState) -> torch.Tensor:
        """Sum each gradient over the replica axes its block is not split
        on and the sequence axis, divided by the replica degree:
        reduce-scattered into the update block where the update splits
        the leaf (that block then summed over sequence), all-reduced
        otherwise. Returns the exact global norm of the reduced
        gradient."""
        mesh = self.mesh
        whole, parts = [], {}
        for name, p in state.params.items():
            g = p.grad
            if g is None:
                continue
            if self.n_rep > 1:
                g = g / self.n_rep
            lay = self.layout.get(name)
            if lay is not None:
                d, axes = lay
                block = collectives.reduce_scatter(g.movedim(d, 0),
                                                   mesh.group_of(axes))
                if self.seq > 1:
                    collectives.all_reduce_(block,
                                            mesh.group_of(SEQUENCE_AXIS))
                u = state.update_params[name]
                u.grad = block.movedim(0, d).contiguous()
                p.grad = None
                g = u.grad
            else:
                if self.reduce_axes.get(name):
                    collectives.all_reduce_(
                        g, mesh.group_of(self.reduce_axes[name]))
                p.grad = g
            c = self.copies.get(name, self.world)
            if c == self.world:
                whole.append(g)
            else:
                parts.setdefault(c, []).append(g)
        if not parts:
            return global_norm(whole)
        # the blocks' square sums over the world, each block counted once
        # (weighted by one over the ranks that hold it)
        sq = None
        for c in sorted(parts):
            x = _sum_squares(parts[c]).to(self.device)
            x = x if c == 1 else x / c
            sq = x if sq is None else sq + x
        collectives.all_reduce_(sq, mesh.group)
        return torch.sqrt(sq + _sum_squares(whole).to(self.device))

    @torch.no_grad()
    def _gather_params(self, state: TrainState) -> None:
        """One all-gather per split update leaf writes the new params."""
        for name, lay in self.layout.items():
            if lay is None:
                continue
            d, axes = lay
            full = collectives.all_gather(
                state.update_params[name].movedim(d, 0),
                self.mesh.group_of(axes))
            state.params[name].copy_(full.movedim(0, d))

    def _cross_rank_mean(self, metrics: dict) -> dict:
        """The scalar metrics as their mean over the replicas, in one
        all-reduce (the ranks of a model axis hold equal values, and so do
        those of the sequence axis: the loss function sums over it)."""
        keys = list(metrics)
        v = torch.stack([metrics[k].float().reshape(()) for k in keys])
        collectives.all_reduce_(v.div_(self.n_rep), self.group)
        return dict(zip(keys, v.unbind()))

    def _device_step(self, state: TrainState, batch: dict,
                     update: Callable[[torch.Tensor], None]) -> dict:
        """Forward, backward, the gradient reduction and ``update(grad
        norm)``, the optimizer's; rebinds ``state.variables`` to the new
        ones and returns the metrics. Host state moves only in
        ``update``."""
        with torch.enable_grad():
            loss, aux = self.loss_fn(state.params, state.variables, batch,
                                     state.rng)
            loss.backward()
        # the pre-clip norm, taken once: the metric, and the clip's
        grad_norm = self._reduce(state)
        # the step's own exchanges after the gradient reduction (the
        # optimizer's, the ZeRO-2 param gather, the replica check, the
        # metrics' mean): the comm profile's update phase
        with collectives.phase("update"):
            update(grad_norm)
            state.opt_state.zero_grad(set_to_none=True)
            if self.sharded:
                self._gather_params(state)
                for p in state.params.values():
                    p.grad = None
            state.variables = aux.pop("variables", state.variables)
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
        return metrics

    def build(self) -> Callable[[TrainState, dict], tuple]:
        def step_fn(state: TrainState, batch: dict) -> tuple:
            metrics = self._device_step(
                state, batch,
                lambda norm: state.opt_state.step(grad_norm=norm))
            state.step += 1
            return state, metrics

        return step_fn

    def build_compiled(self, state: TrainState, batch: dict
                       ) -> "CompiledStep":
        """The AOT path: the step captured as one CUDA graph now, against
        ``state`` and an example ``batch`` of the real shapes, and
        returned as a :class:`CompiledStep` with :meth:`build`'s
        ``step_fn`` signature. On a CUDA device a step that cannot be
        captured raises here (:class:`~kubeflow_tpu_torch.runtime.recipe.
        CaptureError`, or the capture's own error), never later and never
        by running eagerly inside the object; the worker's ladder then
        runs :meth:`build`'s step. On the CPU the object runs the same
        body eagerly through the same static buffers and copy-backs."""
        return CompiledStep(self, state, batch)

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
        global batch); the batch itself on one replica. On a sequence
        mesh each array of rank exactly 2 (the tokens) is also cut to
        this rank's chunk of dimension 1, and ``next_<key>`` holds the
        column after the chunk ([rows, 1]; the first column on the last
        rank, as ``roll(-1)`` wraps); an array of any other rank (labels,
        images [B, H, W, C]) keeps its rows whole, as the JAX package's
        ``place_batch`` places it ``P(data_axes)``."""
        if self.group is not None:
            n = next(iter(batch.values())).shape[0]
            rows = batch_rows(n, self.mesh)
            batch = {k: v[rows] for k, v in batch.items()}
        if self.seq == 1:
            return batch
        out = {}
        for k, v in batch.items():
            if v.ndim != 2:
                out[k] = v
                continue
            if v.shape[1] % self.seq:
                raise ValueError(f"batch[{k!r}] dimension 1 = "
                                 f"{v.shape[1]} not divisible by the "
                                 f"sequence axis {self.seq}")
            c = v.shape[1] // self.seq
            at = self.mesh.chunk_offset(c)
            nxt = (at + c) % v.shape[1]
            out[k] = _dense(v[:, at:at + c])
            out[f"next_{k}"] = _dense(v[:, nxt:nxt + 1])
        return out

    def place_local(self, batch: dict) -> dict:
        """Host batch (numpy arrays or CPU tensors) → device tensors."""
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def place_batch(self, batch: dict) -> dict:
        """A global host batch → this rank's rows on the device: the
        contiguous block ``P(data_axes)`` puts on device ``rank``."""
        return self.place_local(self.local_rows(batch))


@dataclass
class MultisliceTrainStepBuilder:
    """The MPMD pipeline over slices (parallel/multislice.py) behind the
    surface the worker loop drives: ``init`` / ``build`` /
    ``place_batch``. One program per slice: stage s's params, its
    optimizer and its programs live on stage s's device; activations and
    gradients cross between stages as explicit transfers under the 1F1B
    microbatch schedule, and ``last_report`` carries the schedule's
    bubble and transfer accounting. The worker's AOT ladder captures,
    exports and loads the stage programs through ``engine``. The
    pipelined transformer workload only (models/transformer.py
    ``multislice_stage_fns``).
    ``optimizer`` is a factory ``params -> optimizer``, built for each
    stage; its clip takes the cross-stage global norm."""

    cfg: Any                       # transformer.TransformerConfig
    num_slices: int
    num_microbatches: int
    optimizer: Callable[[dict], Any]
    device: Any = "cuda"

    # one replica: the stages split the model, not the batch
    n_rep = 1

    def __post_init__(self):
        from ..models.transformer import multislice_stage_fns
        from ..parallel.multislice import MPMDPipeline, stage_devices
        if self.num_slices < 2:
            raise ValueError(
                "the MPMD multislice path needs numSlices >= 2 (one "
                "program per slice); single-slice jobs take the "
                "TrainStepBuilder path")
        _, embed_fn, block_fn, head_loss_fn = multislice_stage_fns(self.cfg)
        self.engine = MPMDPipeline(
            devices=stage_devices(self.num_slices, resolve_device(
                self.device)),
            embed_fn=embed_fn, block_fn=block_fn,
            head_loss_fn=head_loss_fn, optimizer=self.optimizer,
            num_microbatches=self.num_microbatches)

    @property
    def last_report(self):
        return self.engine.last_report

    def init(self, init_fn: Callable, rng):
        """``init_fn(rng) -> (params, variables)``, the pipelined
        workload's: its whole stacked state dict, which the engine
        partitions over the stages (the single-program arm's weights
        under the same generator)."""
        return self.engine.init(lambda r: dict(init_fn(r)[0]), rng)

    def build(self) -> Callable:
        return self.engine.step

    def place_batch(self, batch: dict) -> dict:
        return self.engine.place_batch(batch)

    def build_eval(self, eval_fn):
        raise NotImplementedError(
            "eval is not supported on the MPMD multislice path yet; "
            "run eval on a single-program mesh")


def kernel_counters() -> dict:
    """``{name: (wrapper, attribute)}`` of every kernel wrapper's launch
    counter (``launches``, and the flash wrappers' ``unaligned_launches``),
    by the wrapper's name."""
    from ..ops.flash_attention import (flash_attention,
                                       flash_attention_bwd_dkv,
                                       flash_attention_bwd_dq)
    from ..ops.fused_adam import fused_adam
    from ..ops.fused_block import fused_bottleneck_eval
    from ..ops.fused_block_train import (fused_block_train_bwd,
                                         fused_block_train_fwd)
    from ..ops.fused_block_train_spatial import (
        fused_block_train_spatial_bwd, fused_block_train_spatial_fwd)
    out = {}
    for fn in (flash_attention, flash_attention_bwd_dq,
               flash_attention_bwd_dkv, fused_adam, fused_block_train_fwd,
               fused_block_train_bwd, fused_block_train_spatial_fwd,
               fused_block_train_spatial_bwd, fused_bottleneck_eval):
        for attr in ("launches", "unaligned_launches"):
            if hasattr(fn, attr):
                name = fn.__name__ if attr == "launches" else \
                    f"{fn.__name__}.{attr}"
                out[name] = (fn, attr)
    return out


def _tensor_slots(state: TrainState) -> dict:
    """Every tensor the step reads and writes in place or rebinds, as
    ``{path: (container, key)}``: params, variables, this rank's update
    blocks and the optimizer's state (per param by leaf name, and its
    named entries such as the runtime schedule's scalars)."""
    slots: dict = {("params", n): (state.params, n) for n in state.params}
    for col, vs in state.variables.items():
        for n in vs:
            slots[("variables", col, n)] = (vs, n)
    held = state.update_params or state.params
    for n, u in (state.update_params or {}).items():
        if u is not state.params[n]:
            slots[("update", n)] = (state.update_params, n)
    names = {id(t): n for n, t in held.items()}
    inner = getattr(state.opt_state, "inner", state.opt_state)
    for key, st in getattr(inner, "state", {}).items():
        owner = key if isinstance(key, str) else names.get(id(key))
        if isinstance(st, dict):
            for k, v in st.items():
                if isinstance(v, torch.Tensor):
                    slots[("opt", owner, k)] = (st, k)
        elif isinstance(st, torch.Tensor):
            slots[("opt", owner)] = (inner.state, key)
    return slots


def _tensors(state: TrainState) -> dict:
    return {path: c[k] for path, (c, k) in _tensor_slots(state).items()}


@torch.no_grad()
def _fix_point(before: dict, state: TrainState) -> list:
    """Make the step a fixed point of the state's storage: every tensor
    the step rebound (the new BatchNorm statistics, a moment the
    optimizer made anew) is copied into the tensor it replaced, which
    goes back in its place. Returns the paths the step made that did
    not exist before."""
    made = []
    for path, (c, k) in _tensor_slots(state).items():
        orig = before.get(path)
        if orig is None:
            made.append(path)
        elif c[k] is not orig:
            orig.copy_(c[k])
            c[k] = orig
    return made


def static_input_names(state: TrainState, batch: dict) -> list[str]:
    """What a captured step reads from outside its graph: the state's
    params and variables by path, and the batch's keys (the optimizer's
    state is its own)."""
    names = [f"params/{n}" for n in state.params]
    names += [f"variables/{c}/{n}" for c, vs in state.variables.items()
              for n in vs]
    return sorted(names) + [f"batch/{k}" for k in sorted(batch)]


class CompiledStep:
    """The train step captured as one CUDA graph: every kernel of the
    forward, backward, reduction and update (K1, K2a, K2b and K3, or K4
    and K5, among PyTorch's own) recorded once and replayed, one host call
    a step. Called as ``step(state, batch) -> (state, metrics)`` on the
    state it was built for; per call:

    - the batch's tensors are copied into static buffers, on the current
      stream (after the device prefetcher's event, which the caller's
      stream already waits on), without a host sync;
    - the optimizer's host scalars go to the device (``stage``: K3's lr,
      bc₁ and bc₂, a baked lr), outside the graph, in stream order;
    - the graph replays; the new BatchNorm statistics and any optimizer
      state the update made anew are copied back into the storage the
      graph reads, inside the graph, so the step is a fixed point of the
      state's storage (the port's form of the JAX package's "state out ≡
      state in");
    - the metrics come back as device copies of the graph's outputs (no
      sync), so a value held across steps is not overwritten by the next
      replay; the host counts (``state.step``, the schedule's) advance on
      the host.

    Building it warms the step up once on a side stream with the example
    batch (kernels loaded, gradients and optimizer state allocated) and
    restores every state tensor in place afterwards (one made by that
    step to zeros, its initial value), so the trajectory is the eager
    one's; then captures. A replay does not pass through the wrappers'
    Python counters: the launches each kernel made during the capture
    (:attr:`launches`) are added to its counter at every replay, and the
    capture's own are not counted.

    On the CPU there is no graph: each call runs the same body eagerly
    through the same static buffers and copy-backs."""

    def __init__(self, builder: "TrainStepBuilder", state: TrainState,
                 batch: dict):
        opt = state.opt_state
        if not all(hasattr(opt, a) for a in ("stage", "apply", "advance",
                                             "prepare_capture")):
            raise CaptureError(f"{type(opt).__name__} is not a recipe "
                               f"optimizer with a device-side update")
        if builder.world > 1 and any(
                collectives.host_staging(p, builder.mesh.group)
                for p in list(state.params.values())[:1]):
            raise CaptureError("the gloo group stages its collectives "
                               "through host memory, which a graph cannot "
                               "hold")
        opt.prepare_capture()
        self.builder = builder
        self.state = state
        self.device = builder.device
        self.static_batch = {k: torch.empty_like(torch.as_tensor(v),
                                                 device=self.device)
                             for k, v in batch.items()}
        self.static_inputs = static_input_names(state, batch)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_metrics: dict = {}
        self.launches: dict = {}        # per replay, by kernel
        self._counters = kernel_counters()
        self.replays = 0
        # the collectives the capture called (parallel/collectives.py
        # recording()): a replay calls none through Python, so this is
        # the step's comm profile input
        self.comm: Optional[collectives.Recording] = None
        if self.device.type == "cuda":
            self._capture(batch)

    def _load_batch(self, batch: dict) -> None:
        if set(batch) != set(self.static_batch):
            raise ValueError(f"batch keys {sorted(batch)}, the step was "
                             f"built for {sorted(self.static_batch)}")
        for k, v in batch.items():
            buf = self.static_batch[k]
            v = torch.as_tensor(v)
            if v.shape != buf.shape or v.dtype != buf.dtype:
                raise ValueError(f"batch[{k!r}] {v.dtype} "
                                 f"{tuple(v.shape)}; the step was built "
                                 f"for {buf.dtype} {tuple(buf.shape)}")
            buf.copy_(v, non_blocking=True)

    def _body(self, state: TrainState) -> tuple[dict, list]:
        before = _tensors(state)
        metrics = self.builder._device_step(state, self.static_batch,
                                            state.opt_state.apply)
        return metrics, _fix_point(before, state)

    def _capture(self, batch: dict) -> None:
        state = self.state
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        self._load_batch(batch)
        state.opt_state.stage()
        snap = {path: t.clone() for path, t in _tensors(state).items()}
        rng = state.rng.get_state() \
            if isinstance(state.rng, torch.Generator) else None
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            # the warm-up: one step, then every state tensor restored
            self._body(state)
            with torch.no_grad():
                for path, t in _tensors(state).items():
                    if path in snap:
                        t.copy_(snap[path])
                    else:
                        t.zero_()
        cur.wait_stream(side)
        if rng is not None:
            state.rng.set_state(rng)
        del snap
        counters = self._counters
        at = {n: getattr(f, a) for n, (f, a) in counters.items()}
        graph = torch.cuda.CUDAGraph()
        try:
            # on the warm-up's stream: autograd's accumulate nodes made
            # there are the capture's
            with torch.cuda.graph(graph, stream=side), \
                    collectives.recording() as comm:
                metrics, made = self._body(state)
                if made:
                    raise CaptureError(f"the captured step made state "
                                       f"{made}")
            self.comm = comm
            self.launches = {n: getattr(f, a) - at[n]
                             for n, (f, a) in counters.items()
                             if getattr(f, a) != at[n]}
        finally:
            for n, (f, a) in counters.items():
                setattr(f, a, at[n])
        self.graph = graph
        self.static_metrics = metrics

    def __call__(self, state: TrainState, batch: dict) -> tuple:
        if state is not self.state:
            raise ValueError("a compiled step runs the state it was built "
                             "for")
        self._load_batch(batch)
        opt = state.opt_state
        opt.stage()
        if self.graph is None:
            # the CPU: the body eagerly, its metrics through the same
            # static outputs as a replay's
            metrics, _ = self._body(state)
            for k, v in metrics.items():
                self.static_metrics.setdefault(k, torch.empty_like(v))
                self.static_metrics[k].copy_(v)
        else:
            self.graph.replay()
            for n, k in self.launches.items():
                f, a = self._counters[n]
                setattr(f, a, getattr(f, a) + k)
        metrics = {k: v.clone() for k, v in self.static_metrics.items()}
        self.replays += 1
        opt.advance()
        state.step += 1
        return state, metrics
