"""Training recipes: optimizers, LR schedules, regularization.

The port of ``kubeflow_tpu/runtime/recipe.py``. The JAX package builds one
optax chain; here the chain is :class:`RecipeOptimizer`, in the same
order:

1. clip by global norm, in optax's form: ``(g / norm) * max_norm``, only
   when ``norm >= max_norm``, bit for bit (``torch.nn.utils.clip_grad_norm_``
   multiplies by ``max_norm / (norm + 1e-6)`` and is not used). The
   pre-clip norm is taken once a step: the train step hands the one it
   reports as a metric to :meth:`RecipeOptimizer.step`;
2. L2 weight decay folded into the gradient, for sgd, momentum, nesterov
   and adam, on the parameters ``decay_mask`` selects (a param group);
   adamw decays decoupled, on the same mask;
3. the optimizer, with lr taken from the schedule at the pre-increment
   count before each step.

The stock tier builds sgd, momentum, nesterov, adam and adamw on
:class:`SGD` (``torch.optim.SGD`` with its update written out, so that
lr may live on the device) / ``torch.optim.Adam`` / ``AdamW`` (never
``fused=True``), as the JAX stock tier builds on optax. ``lars`` and ``rmsprop`` run on
:class:`ChainOptimizer`, the optax chains written out term by term:
``torch.optim`` has no LARS, and its RMSprop puts eps outside the root
and scales by lr after the momentum buffer. The ``fused_adam`` tier is
:class:`~kubeflow_tpu_torch.ops.fused_adam.FusedAdam`, one hand-written
kernel launch a step over every parameter tensor with the clip folded
in, and still requires ``adam``.

Schedules are callables of the step count, evaluated on the host: the
JAX package traces them into the step; eager PyTorch sets each step's lr
before launching it. With ``runtime_schedule=True`` (what a
hyperparameter sweep sets) the tuned scalars instead live in the
optimizer's state as device tensors (:func:`runtime_lr_state`, the port
of ``RuntimeLRState``; ``count``, ``base_lr``, ``warmup_steps``,
``total_steps`` under ``state_dict()["state"]["runtime_lr"]``) and lr is
computed from them on the device every step (:func:`runtime_lr_at`),
without a host sync: every family then runs on :class:`ChainOptimizer`,
which applies the runtime lr where the JAX chain does (before the
momentum trace for lars and rmsprop, last for the others).

:func:`optimizer_tree` and :func:`load_optimizer_tree` carry any of
these optimizers' state through a checkpoint by leaf name: the moments
and traces, torch's per-param ``step``, ``FusedAdam``'s shared count,
the schedule's host count and the runtime schedule's scalars.
"""

from __future__ import annotations

import hashlib
import json
import math
from typing import Callable, Iterable, Mapping, Optional, Union

import torch

from ..api.trainingjob import OPTIMIZER_KERNELS
from ..ops.fused_adam import FusedAdam, write_scalars
from ..parallel import collectives

OPTIMIZERS = ("sgd", "momentum", "nesterov", "adam", "adamw", "lars",
              "rmsprop")
SCHEDULES = ("constant", "cosine", "step", "linear")

# classic ImageNet step-decay epochs 30/60/80 of 90, as fractions of the run
STEP_BOUNDARIES = (1 / 3, 2 / 3, 8 / 9)
STEP_FACTOR = 0.1

Schedule = Callable[[int], float]

# optax defaults of the chains ChainOptimizer writes out
LARS_TRUST_COEFFICIENT = 0.001
RMS_DECAY, RMS_EPS = 0.9, 1e-8
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def recipe_fingerprint(**knobs) -> str:
    """Stable hash of the WHOLE recipe (trial/run identity), as the JAX
    package computes it: sha256 of the knobs as sorted JSON (a non-JSON
    knob by its repr), first 24 hex digits."""
    def default(o):  # non-JSON knob: repr is stable enough for a key
        return repr(o)

    blob = json.dumps(knobs, sort_keys=True, default=default).encode()
    return hashlib.sha256(blob).hexdigest()[:24]


# The tuned-scalar knobs that stop being compile-time constants under the
# runtime schedule: they live in the optimizer STATE, so they must not key
# a compiled or cached program. The worker's kwarg names and the generic
# shorthand.
RUNTIME_CONSTANT_KNOBS = frozenset({
    "learning_rate", "lr", "warmup_steps", "steps", "total_steps"})


def split_recipe_knobs(knobs: dict) -> tuple[dict, dict]:
    """Partition recipe knobs into (compile-shape, runtime-constants)."""
    shape = {k: v for k, v in knobs.items()
             if k not in RUNTIME_CONSTANT_KNOBS}
    runtime = {k: v for k, v in knobs.items()
               if k in RUNTIME_CONSTANT_KNOBS}
    return shape, runtime


def compile_shape_fingerprint(**knobs) -> str:
    """Hash of every knob EXCEPT the runtime constants: two trials that
    differ only in lr / warmup / total steps share it."""
    shape, _ = split_recipe_knobs(knobs)
    return recipe_fingerprint(**shape)


def runtime_constants_key(**knobs) -> str:
    """Hash of ONLY the runtime-constant knobs: trial identity within a
    shared compile shape."""
    _, runtime = split_recipe_knobs(knobs)
    return recipe_fingerprint(**runtime)


def scale_lr(base_lr: float, global_batch: int, base_batch: int = 256
             ) -> float:
    """Linear-scaling rule (Goyal et al.): lr = base · batch/256."""
    return base_lr * global_batch / base_batch


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init → end over ``steps``, then end."""
    def sched(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return sched


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule."""
    def sched(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init * ((1.0 - alpha) * cosine + alpha)
    return sched


def _piecewise(init: float, bounds: Mapping[int, float]) -> Schedule:
    """optax.piecewise_constant_schedule: each factor applies once
    ``count >= boundary``."""
    items = sorted(bounds.items())

    def sched(count: int) -> float:
        v = init
        for boundary, factor in items:
            if count >= boundary:
                v *= factor
        return v
    return sched


def lr_schedule(name: str, base_lr: float, total_steps: int,
                warmup_steps: int = 0, *, end_scale: float = 0.0,
                boundaries: tuple = STEP_BOUNDARIES,
                factor: float = STEP_FACTOR) -> Schedule:
    """A schedule over the whole run: linear warmup from 0 to base_lr over
    ``warmup_steps``, then the named decay over the remaining steps (the
    decay sees ``count - warmup_steps``, as optax.join_schedules passes)."""
    if name not in SCHEDULES:
        raise ValueError(f"schedule {name!r} not one of {SCHEDULES}")
    if warmup_steps < 0 or total_steps <= 0:
        raise ValueError("need total_steps > 0 and warmup_steps >= 0")
    warmup_steps = min(warmup_steps, total_steps)
    decay_steps = max(total_steps - warmup_steps, 1)

    if name == "constant":
        def decay(count: int) -> float:
            return base_lr
    elif name == "cosine":
        decay = _cosine(base_lr, decay_steps, end_scale)
    elif name == "linear":
        decay = _linear(base_lr, base_lr * end_scale, decay_steps)
    else:  # step
        # round (not truncate) so 2/3·90 lands on 60; boundaries that
        # collide on one step compound their factors
        bounds: dict[int, float] = {}
        for b in boundaries:
            k = max(round(b * decay_steps), 1)
            bounds[k] = bounds.get(k, 1.0) * factor
        decay = _piecewise(base_lr, bounds)

    if warmup_steps == 0:
        return decay
    warmup = _linear(0.0, base_lr, warmup_steps)

    def joined(count: int) -> float:
        return warmup(count) if count < warmup_steps \
            else decay(count - warmup_steps)
    return joined


def runtime_lr_state(learning_rate: float, total_steps: int,
                     warmup_steps: int, device=None) -> dict:
    """The port of ``RuntimeLRState``: the tuned scalars as device
    tensors (int32 count, f32 base_lr, warmup_steps, total_steps)."""
    return {
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "base_lr": torch.tensor(learning_rate, dtype=torch.float32,
                                device=device),
        "warmup_steps": torch.tensor(warmup_steps, dtype=torch.float32,
                                     device=device),
        "total_steps": torch.tensor(total_steps, dtype=torch.float32,
                                    device=device),
    }


def runtime_lr_at(name: str, count: torch.Tensor, base_lr: torch.Tensor,
                  warmup_steps: torch.Tensor, total_steps: torch.Tensor, *,
                  end_scale: float = 0.0,
                  boundaries: tuple = STEP_BOUNDARIES,
                  factor: float = STEP_FACTOR) -> torch.Tensor:
    """``lr_schedule`` as f32 tensor math over the runtime scalars, term
    by term the JAX package's ``_runtime_lr_at``: linear 0 → base warmup
    over min(warmup, total) steps, then the named decay over
    max(total − warmup, 1) steps; step-decay factors apply at
    count − warmup ≥ boundary and compound. A 0-d f32 tensor on the
    scalars' device; nothing reads it back to the host."""
    if name not in SCHEDULES:
        raise ValueError(f"schedule {name!r} not one of {SCHEDULES}")
    count = count.to(torch.float32)
    base = base_lr.to(torch.float32)
    total = torch.clamp(total_steps.to(torch.float32), min=1.0)
    warm = torch.minimum(torch.clamp(warmup_steps.to(torch.float32),
                                     min=0.0), total)
    decay_steps = torch.clamp(total - warm, min=1.0)
    t = torch.clamp((count - warm) / decay_steps, 0.0, 1.0)
    if name == "constant":
        decayed = base
    elif name == "cosine":
        cosine = 0.5 * (1.0 + torch.cos(math.pi * t))
        decayed = base * ((1.0 - end_scale) * cosine + end_scale)
    elif name == "linear":
        decayed = base + (base * end_scale - base) * t
    else:  # step
        decayed = base
        one = torch.ones_like(base)
        for b in boundaries:
            k = torch.clamp(torch.round(b * decay_steps), min=1.0)
            decayed = decayed * torch.where((count - warm) >= k,
                                            one * factor, one)
    warm_frac = torch.clamp(count / torch.clamp(warm, min=1.0), 0.0, 1.0)
    return torch.where(count < warm, base * warm_frac, decayed)


class ChainOptimizer(torch.optim.Optimizer):
    """The optax chains that ``torch.optim`` has no match for, written
    out term by term over param groups (a group's ``weight_decay`` is its
    decay-mask value):

    - ``lars`` (``optax.lars``): u = g + wd·p; u ·= trust ratio
      0.001·‖p‖/‖u‖ on every tensor, 1 where ‖p‖ or ‖u‖ is 0 (every
      block's last BN scale starts at 0); u ·= −lr; trace t = u + m·t;
      p += t.
    - ``rmsprop`` (``optax.rmsprop``): u = g + wd·p; ν = 0.1·u² + 0.9·ν
      from 0; u ·= rsqrt(ν + 1e-8) (eps inside the root); u ·= −lr;
      trace; p += t.
    - with ``runtime`` (the runtime schedule) also sgd, momentum,
      nesterov, adam and adamw, each at unit lr and then scaled by the
      runtime lr last (momentum's trace runs before the lr).

    ``lr`` is the group's (the host schedule's, set each step by
    :class:`RecipeOptimizer`) or, with ``runtime``, computed on the
    device from ``self.state["runtime_lr"]``, which ``state_dict()``
    carries; its count advances on the device after each step."""

    def __init__(self, params, name: str, *, lr: float = 1.0,
                 momentum: float = 0.9, schedule: str = "constant",
                 runtime: Optional[dict] = None):
        if name not in OPTIMIZERS:
            raise ValueError(f"optimizer {name!r} not one of {OPTIMIZERS}")
        if runtime is None and name not in ("lars", "rmsprop"):
            raise ValueError(f"{name!r} with a baked schedule runs on "
                             f"torch.optim (make_optimizer)")
        super().__init__(params, {"lr": lr, "weight_decay": 0.0})
        self.name = name
        self.momentum = momentum
        self.schedule = schedule
        if runtime is not None:
            self.state["runtime_lr"] = runtime
        self._shard_group = None
        self._sharded: set = set()

    def shard_over(self, group, shards: Iterable[torch.Tensor]) -> None:
        """Mark ``shards`` as this rank's blocks of tensors split over the
        ranks of ``group``: their per-tensor norms (LARS's ‖p‖, ‖u‖) are
        all-reduced so they are the whole tensor's."""
        self._shard_group = group
        self._sharded = {id(t) for t in shards}

    def _tensor_norms(self, ps: list, xs: list[list]) -> list:
        """Per-tensor L2 norms of each list in ``xs`` (each aligned with
        ``ps``), over the whole tensor where ``ps[i]`` is a shard: the
        shards' square sums all-reduced in one call."""
        norms = [torch.stack(torch._foreach_norm(x)) for x in xs]
        mask = [id(p) in self._sharded for p in ps]
        if self._shard_group is None or not any(mask):
            return norms
        m = torch.tensor(mask, device=norms[0].device)
        sq = torch.stack([torch.where(m, n.square(), 0.0) for n in norms])
        collectives.all_reduce_(sq, self._shard_group)
        return [torch.where(m, s.sqrt(), n) for s, n in zip(sq, norms)]

    @torch.no_grad()
    def step(self, closure=None):
        rt = self.state.get("runtime_lr")
        runtime_lr = None if rt is None else runtime_lr_at(
            self.schedule, rt["count"], rt["base_lr"], rt["warmup_steps"],
            rt["total_steps"])
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if ps:
                self._step_group(group, ps, group["lr"] if rt is None
                                 else runtime_lr)
        if rt is not None:
            rt["count"] += 1

    def _state_list(self, ps: list, key: str) -> list:
        """Per-tensor state ``key``, zeros at the first step (optax's
        init)."""
        out = []
        for p in ps:
            st = self.state[p]
            if key not in st:
                st[key] = torch.zeros_like(p, dtype=torch.float32)
            out.append(st[key])
        return out

    def _trace_(self, ps: list, us: list) -> list:
        """optax.trace in place: t = u + m·t; returns the traces."""
        ts = self._state_list(ps, "trace")
        torch._foreach_mul_(ts, self.momentum)
        torch._foreach_add_(ts, us)
        return ts

    def _step_group(self, group, ps: list, lr) -> None:
        name, wd = self.name, group["weight_decay"]
        us = [p.grad.float() for p in ps]
        # L2 into the gradient on the masked tensors (lars's own
        # add_decayed_weights; the recipe's for the others but adamw);
        # new tensors, never the gradients in place
        us = torch._foreach_add(us, ps, alpha=wd) \
            if wd and name != "adamw" else list(us)
        neg_lr = -lr
        if name in ("lars", "rmsprop"):
            if name == "lars":
                pn, un = self._tensor_norms(ps, [ps, us])
                ratio = LARS_TRUST_COEFFICIENT * pn / (un + 0.0)
                ratio = torch.where((pn == 0.0) | (un == 0.0),
                                    torch.ones_like(ratio), ratio)
                us = torch._foreach_mul(us, list(ratio.unbind()))
            else:
                nus = self._state_list(ps, "nu")
                torch._foreach_mul_(nus, RMS_DECAY)
                torch._foreach_addcmul_(nus, us, us, value=1 - RMS_DECAY)
                root = torch._foreach_add(nus, RMS_EPS)
                torch._foreach_rsqrt_(root)
                us = torch._foreach_mul(us, root)
            # lr before the trace: the trace accumulates lr-scaled steps
            torch._foreach_mul_(us, neg_lr)
            torch._foreach_add_(ps, self._trace_(ps, us))
            return
        # the runtime schedule over the stock families: the base chain at
        # unit lr (ending in the minus sign), then the runtime lr last
        if name in ("momentum", "nesterov"):
            ts = self._trace_(ps, us)
            if name == "nesterov":
                ts = torch._foreach_add(us, torch._foreach_mul(
                    ts, self.momentum))
            us = ts
        elif name in ("adam", "adamw"):
            adam = []
            for p, u in zip(ps, us):
                st = self.state[p]
                count = st.get("step", torch.zeros((), device=p.device)) + 1
                mu = (1 - ADAM_B1) * u + ADAM_B1 * st.get(
                    "mu", torch.zeros_like(u))
                nu = (1 - ADAM_B2) * (u * u) + ADAM_B2 * st.get(
                    "nu", torch.zeros_like(u))
                st.update(step=count, mu=mu, nu=nu)
                d = (mu / (1 - ADAM_B1 ** count)) / (
                    torch.sqrt(nu / (1 - ADAM_B2 ** count)) + ADAM_EPS)
                if name == "adamw" and wd:
                    d = d + wd * p
                adam.append(d)
            us = adam
        torch._foreach_add_(ps, torch._foreach_mul(us, neg_lr))


def decay_mask(params: Union[Mapping[str, torch.Tensor], Iterable]):
    """Weight decay applies to tensors of rank > 1 (kernels and
    embeddings), never to biases or LayerNorm scales. A mapping gives a
    mapping of bools, an iterable a list."""
    if isinstance(params, Mapping):
        return {k: p.dim() > 1 for k, p in params.items()}
    return [p.dim() > 1 for p in params]


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element, in f32 (optax
    ``global_norm``): PyTorch's multi-tensor norm of each tensor, then the
    norm of those, a few launches for any number of tensors. Like optax's,
    it is a library reduction outside any kernel of the port."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float,
                         norm: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """optax.clip_by_global_norm in place, bit for bit: ``(g / norm) *
    max_norm`` when ``norm >= max_norm``, else g untouched. ``norm`` is
    the pre-clip global norm, taken here when not given. Returns it; no
    host sync: the untouched branch divides and multiplies by 1, which is
    exact."""
    if norm is None:
        norm = global_norm(grads)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    divisor = torch.where(keep, one, norm)
    factor = torch.where(keep, one, torch.full_like(norm, max_norm))
    for dtype in {g.dtype for g in grads}:
        same = [g for g in grads if g.dtype == dtype]
        torch._foreach_div_(same, divisor.to(dtype))
        torch._foreach_mul_(same, factor.to(dtype))
    return norm


class SGD(torch.optim.SGD):
    """``torch.optim.SGD`` (no dampening, no maximize) whose step takes
    each group's lr as a host number or a 0-d device tensor: term by
    term SGD's foreach update, which is optax's sgd chain: u = g + wd·p;
    with momentum the trace t = m·t + u (t = u at the first step) and
    u = t, or u + m·t for nesterov; p += u·(-lr), lr·u rounded before
    the add as optax rounds it. ``torch.optim.SGD`` reads a tensor lr
    back with ``item()``, which a capture cannot hold; this step has no
    host sync, so a captured step replays it with each step's lr from
    the device buffer, and every eager step takes the same arithmetic.
    The trace is SGD's own ``momentum_buffer``."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            us = [p.grad for p in ps]
            if group["weight_decay"]:
                us = torch._foreach_add(us, ps, alpha=group["weight_decay"])
            m = group["momentum"]
            if m:
                bufs = []
                for p, u in zip(ps, us):
                    st = self.state[p]
                    buf = st.get("momentum_buffer")
                    if buf is None:
                        buf = st["momentum_buffer"] = u.detach().clone()
                    else:
                        buf.mul_(m).add_(u)
                    bufs.append(buf)
                us = torch._foreach_add(us, bufs, alpha=m) \
                    if group["nesterov"] else bufs
            torch._foreach_add_(ps, torch._foreach_mul(us, -group["lr"]))
        return loss


class CaptureError(RuntimeError):
    """A step that a CUDA graph cannot hold: an optimizer without a
    device-side update, or collectives staged through host memory."""


class RecipeOptimizer:
    """The recipe's chain around a ``torch.optim.Optimizer``: clip the
    gradients by their global norm, then step the optimizer with lr from
    the schedule at the pre-increment count. A :class:`FusedAdam` reads
    its schedule itself and clips inside its one kernel launch.

    :meth:`step` is three parts, so a train step captured into a CUDA
    graph (runtime/trainstep.py ``build_compiled``) can run the middle
    one alone: :meth:`stage` writes this step's host scalars where the
    device reads them, :meth:`apply` is the update on the device, and
    :meth:`advance` moves the host counts on. :meth:`prepare_capture`
    moves every per-step host scalar onto the device first: FusedAdam's
    (lr, bc₁, bc₂) are there already, the runtime schedule's lr too; a
    baked lr of the chain becomes a device buffer, Adam and AdamW on a
    card turn ``capturable`` with a device lr, and :class:`SGD` (sgd,
    momentum, nesterov) reads it as it is."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Schedule,
                 grad_clip: Optional[float]):
        self.inner = inner
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0
        # the captured path's lr on the device (None: a host float)
        self.lr_buffer: Optional[torch.Tensor] = None

    @property
    def param_groups(self) -> list:
        return self.inner.param_groups

    def state_dict(self) -> dict:
        """The inner optimizer's, which under the runtime schedule carries
        the runtime lr state; plus the host count of the schedule."""
        return {"inner": self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def shard_over(self, group, shards: Iterable[torch.Tensor]) -> None:
        """The sharded update (runtime/trainstep.py): the optimizer's
        params are this rank's blocks, ``shards`` those split over the
        ranks of ``group``. The elementwise families need nothing; the
        clip takes the exact global norm from the step; LARS reduces its
        per-tensor norms (:meth:`ChainOptimizer.shard_over`). The decay
        mask is keyed on ``ndim``, which a block keeps."""
        if isinstance(self.inner, ChainOptimizer):
            self.inner.shard_over(group, shards)

    @torch.no_grad()
    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update; ``grad_norm``, the gradients' pre-clip global norm
        when the caller has it already, saves taking it again."""
        self.stage()
        self.apply(grad_norm)
        self.advance()

    def stage(self) -> None:
        """This step's host scalars, from the pre-increment count, where
        the update reads them: FusedAdam's device buffer, the captured
        path's lr buffer (written on the current stream), or each group's
        lr. The runtime schedule has none."""
        if isinstance(self.inner, FusedAdam):
            self.inner.stage()
            return
        if "runtime_lr" in self.inner.state:
            return
        lr = float(self.schedule(self.count))
        if self.lr_buffer is not None:
            write_scalars(self.lr_buffer.view(1), (lr,))
            return
        for group in self.inner.param_groups:
            group["lr"] = lr

    @torch.no_grad()
    def apply(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """The update on the device, from the scalars :meth:`stage` wrote:
        the clip and the optimizer; no host count moves."""
        norm = None
        if self.grad_clip:
            grads = [p.grad for g in self.param_groups for p in g["params"]
                     if p.grad is not None]
            norm = grad_norm if grad_norm is not None else global_norm(grads)
        if isinstance(self.inner, FusedAdam):
            self.inner.launch(norm=norm, max_norm=self.grad_clip or None)
            return
        if self.grad_clip:
            clip_by_global_norm_(grads, self.grad_clip, norm=norm)
        self.inner.step()

    def advance(self) -> None:
        """Move the host counts on by one step."""
        self.count += 1
        if isinstance(self.inner, FusedAdam):
            self.inner.count += 1

    def prepare_capture(self) -> None:
        """Move every per-step host scalar onto the params' device so that
        a captured update reads each step's values (see the class
        docstring); every family can. Idempotent; the trajectory is
        unchanged except that capturable Adam takes its bias corrections
        on the device."""
        inner = self.inner
        if isinstance(inner, FusedAdam) or "runtime_lr" in inner.state:
            return
        params = [p for g in inner.param_groups for p in g["params"]]
        stock = isinstance(inner, (torch.optim.Adam, torch.optim.AdamW,
                                   torch.optim.SGD))
        if stock and params[0].device.type != "cuda":
            return      # the CPU runs the step eagerly: host step and lr
        if self.lr_buffer is None:
            self.lr_buffer = torch.zeros((), dtype=torch.float32,
                                         device=params[0].device)
        adam = isinstance(inner, (torch.optim.Adam, torch.optim.AdamW))
        if adam:
            for group in inner.param_groups:
                group["capturable"] = True
                group["foreach"] = True
            for p in params:
                st = inner.state.get(p, {})
                if "step" in st:
                    st["step"] = st["step"].to(p.device, torch.float32)
        for group in inner.param_groups:
            group["lr"] = self.lr_buffer


def optimizer_tree(opt, names: Mapping[int, str],
                   leaf: Callable[[str, torch.Tensor], object]) -> dict:
    """Any optimizer of the recipe (a :class:`RecipeOptimizer` or its
    inner optimizer) as a checkpoint tree keyed by leaf name, never by a
    param's position in a group: ``{"count", "slots": {slot: {name:
    leaf}}, "extra": {key: state}}``. ``count`` holds the schedule's host
    count and, for :class:`FusedAdam`, its shared step count
    (``inner_count``); ``slots`` every per-param state entry (Adam's
    moments, a momentum trace, torch's ``step``), each params-shaped one
    through ``leaf(name, tensor)`` (which wraps this rank's block of a
    split param); ``extra`` the non-param entries (the runtime
    schedule's scalars). ``names`` maps ``id`` of each tensor the
    optimizer updates to its leaf name."""
    inner = getattr(opt, "inner", opt)
    tree: dict = {"count": {}, "slots": {}, "extra": {}}
    if isinstance(opt, RecipeOptimizer):
        tree["count"]["schedule"] = opt.count
    if isinstance(inner, FusedAdam):
        tree["count"]["inner"] = inner.count
    for group in inner.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            for slot, v in inner.state.get(p, {}).items():
                if isinstance(v, torch.Tensor):
                    tree["slots"].setdefault(slot, {})[name] = \
                        leaf(name, v) if v.dim() and v.shape == p.shape \
                        else v
    for key, v in inner.state.items():
        if isinstance(key, str):
            tree["extra"][key] = dict(v) if isinstance(v, dict) else v
    return tree


def load_optimizer_tree(opt, tree: dict, names: Mapping[int, str],
                        block: Callable[[str, torch.Tensor], torch.Tensor]
                        ) -> None:
    """Load :func:`optimizer_tree`'s tree, with global CPU leaves, into
    ``opt``: each params-shaped leaf cut by ``block(name, leaf)`` to the
    tensor this optimizer updates and copied to its device; a 0-d entry
    on its param's device, except torch's own Adam ``step``, which
    ``torch.optim`` keeps on the CPU; the extra entries on the params'
    device."""
    inner = getattr(opt, "inner", opt)
    counts = tree.get("count", {})
    if isinstance(opt, RecipeOptimizer) and "schedule" in counts:
        opt.count = int(counts["schedule"])
    if isinstance(inner, FusedAdam) and "inner" in counts:
        inner.count = int(counts["inner"])
    by_name = {names[id(p)]: p for group in inner.param_groups
               for p in group["params"]}
    cpu_step = isinstance(inner, (torch.optim.Adam, torch.optim.AdamW)) \
        and not any(g.get("fused") or g.get("capturable")
                    for g in inner.param_groups)
    for slot, leaves in tree.get("slots", {}).items():
        for name, v in leaves.items():
            p = by_name[name]
            if v.dim() and v.shape != p.shape:
                v = block(name, v)
            dev = "cpu" if slot == "step" and cpu_step else p.device
            _load_into(inner.state[p], slot, v, dev)
    device = next(iter(by_name.values())).device if by_name else None
    for key, v in tree.get("extra", {}).items():
        if isinstance(v, dict):
            held = inner.state.setdefault(key, {})
            for k, t in v.items():
                _load_into(held, k, t, device)
        else:
            _load_into(inner.state, key, v, device)


@torch.no_grad()
def _load_into(held, key, v: torch.Tensor, device) -> None:
    """``held[key] = v`` on ``device``: copied into the tensor already
    there when it matches in shape, dtype and device (a captured train
    step reads that storage), a new tensor otherwise."""
    t = held.get(key)
    if isinstance(t, torch.Tensor) and t.shape == v.shape and \
            t.dtype == v.dtype and t.device == torch.device(device):
        t.copy_(v)
    else:
        held[key] = v.to(device, copy=True)


def decay_groups(params: list, weight_decay: float) -> list[dict]:
    """The decay mask as param groups: rank > 1 decays, the rest not."""
    mask = decay_mask(params)
    decayed = [p for p, m in zip(params, mask) if m]
    others = [p for p, m in zip(params, mask) if not m]
    groups = []
    if decayed:
        groups.append({"params": decayed, "weight_decay": weight_decay})
    if others:
        groups.append({"params": others, "weight_decay": 0.0})
    return groups


def make_optimizer(
    params: Union[Mapping[str, torch.Tensor], Iterable[torch.Tensor]],
    name: str = "momentum",
    learning_rate: float = 0.1,
    *,
    schedule: str = "constant",
    total_steps: int = 1,
    warmup_steps: int = 0,
    weight_decay: float = 0.0,
    momentum: float = 0.9,
    grad_clip: Optional[float] = 1.0,
    kernels: str = "stock",
    runtime_schedule: bool = False,
) -> tuple[RecipeOptimizer, Schedule]:
    """The recipe's optimizer over ``params``. Returns (optimizer,
    schedule); the schedule is also returned alone so callers can log
    lr(step). ``kernels="fused_adam"`` selects :class:`FusedAdam` (the
    fused kernel) and requires ``name="adam"``. ``runtime_schedule``
    keeps the schedule's scalars in the optimizer's state on the params'
    device and computes lr there (:class:`ChainOptimizer`); the returned
    schedule is the same function on the host, for logging."""
    if name not in OPTIMIZERS:
        raise ValueError(f"optimizer {name!r} not one of {OPTIMIZERS}")
    if kernels not in OPTIMIZER_KERNELS:
        raise ValueError(
            f"kernels.optimizer {kernels!r} not one of {OPTIMIZER_KERNELS}")
    if runtime_schedule and kernels == "fused_adam":
        raise ValueError(
            "runtime_schedule is incompatible with kernels.optimizer "
            "'fused_adam' (the fused kernel bakes the schedule); use the "
            "stock chain for swept trials")
    if kernels == "fused_adam" and name != "adam":
        raise ValueError(
            f"kernels.optimizer 'fused_adam' requires optimizer 'adam', "
            f"got {name!r}")

    params = list(params.values()) if isinstance(params, Mapping) \
        else list(params)
    sched = lr_schedule(schedule, learning_rate, total_steps, warmup_steps)
    # the adamw decay is decoupled (AdamW's own); the others fold L2 into
    # the gradient (torch.optim's weight_decay is that L2 form)
    groups = decay_groups(params, weight_decay)
    lr0 = float(sched(0))
    if runtime_schedule or name in ("lars", "rmsprop"):
        runtime = runtime_lr_state(
            learning_rate, total_steps, warmup_steps,
            device=params[0].device if params else None) \
            if runtime_schedule else None
        inner: torch.optim.Optimizer = ChainOptimizer(
            groups, name, lr=lr0, momentum=momentum, schedule=schedule,
            runtime=runtime)
    elif kernels == "fused_adam":
        inner = FusedAdam(groups, lr=sched)
    elif name == "sgd":
        inner = SGD(groups, lr=lr0)
    elif name in ("momentum", "nesterov"):
        inner = SGD(groups, lr=lr0, momentum=momentum,
                    nesterov=name == "nesterov")
    elif name == "adam":
        inner = torch.optim.Adam(groups, lr=lr0, fused=False)
    else:  # adamw
        inner = torch.optim.AdamW(groups, lr=lr0, fused=False)
    return RecipeOptimizer(inner, sched, grad_clip), sched
