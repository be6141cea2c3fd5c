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

The stock tier builds on ``torch.optim.SGD`` / ``Adam`` / ``AdamW``
(never ``fused=True``), as the JAX stock tier builds on optax. The
``fused_adam`` tier is :class:`~kubeflow_tpu_torch.ops.fused_adam.FusedAdam`,
one hand-written kernel launch a step over every parameter tensor with
the clip folded in, and still requires ``adam``. ``lars``, ``rmsprop``
and ``runtime_schedule=True`` raise "not yet ported" (ROADMAP Queue 1
item 2).

Schedules are callables of the step count, evaluated on the host: the
JAX package traces them into the step; eager PyTorch sets each step's lr
before launching it.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping, Optional, Union

import torch

from ..api.trainingjob import OPTIMIZER_KERNELS
from ..ops.fused_adam import FusedAdam

OPTIMIZERS = ("sgd", "momentum", "nesterov", "adam", "adamw", "lars",
              "rmsprop")
SCHEDULES = ("constant", "cosine", "step", "linear")

# classic ImageNet step-decay epochs 30/60/80 of 90, as fractions of the run
STEP_BOUNDARIES = (1 / 3, 2 / 3, 8 / 9)
STEP_FACTOR = 0.1

Schedule = Callable[[int], float]


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


class RecipeOptimizer:
    """The recipe's chain around a ``torch.optim.Optimizer``: clip the
    gradients by their global norm, then step the optimizer with lr from
    the schedule at the pre-increment count. A :class:`FusedAdam` reads
    its schedule itself and clips inside its one kernel launch."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Schedule,
                 grad_clip: Optional[float]):
        self.inner = inner
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0

    @property
    def param_groups(self) -> list:
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update; ``grad_norm``, the gradients' pre-clip global norm
        when the caller has it already, saves taking it again."""
        norm = None
        if self.grad_clip:
            grads = [p.grad for g in self.param_groups for p in g["params"]
                     if p.grad is not None]
            norm = grad_norm if grad_norm is not None else global_norm(grads)
        if isinstance(self.inner, FusedAdam):
            self.inner.step(norm=norm, max_norm=self.grad_clip or None)
        else:
            if self.grad_clip:
                clip_by_global_norm_(grads, self.grad_clip, norm=norm)
            lr = float(self.schedule(self.count))
            for group in self.inner.param_groups:
                group["lr"] = lr
            self.inner.step()
        self.count += 1


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
    fused kernel) and requires ``name="adam"``."""
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
    if name in ("lars", "rmsprop"):
        raise NotImplementedError(
            f"optimizer {name!r} is not yet ported (ROADMAP Queue 1 item 2)")
    if runtime_schedule:
        raise NotImplementedError(
            "runtime_schedule is not yet ported (ROADMAP Queue 1 item 2)")

    params = list(params.values()) if isinstance(params, Mapping) \
        else list(params)
    sched = lr_schedule(schedule, learning_rate, total_steps, warmup_steps)
    # the adamw decay is decoupled (AdamW's own); the others fold L2 into
    # the gradient (torch.optim's weight_decay is that L2 form)
    groups = decay_groups(params, weight_decay)
    lr0 = float(sched(0))
    if kernels == "fused_adam":
        inner: torch.optim.Optimizer = FusedAdam(groups, lr=sched)
    elif name == "sgd":
        inner = torch.optim.SGD(groups, lr=lr0)
    elif name in ("momentum", "nesterov"):
        inner = torch.optim.SGD(groups, lr=lr0, momentum=momentum,
                                nesterov=name == "nesterov")
    elif name == "adam":
        inner = torch.optim.Adam(groups, lr=lr0, fused=False)
    else:  # adamw
        inner = torch.optim.AdamW(groups, lr=lr0, fused=False)
    return RecipeOptimizer(inner, sched, grad_clip), sched
