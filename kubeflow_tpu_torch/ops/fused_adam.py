"""Fused Adam update: a hand-written CUDA kernel for Hopper.

The counterpart of ``kubeflow_tpu/ops/fused_adam.py``. One kernel
(``csrc/fused_adam.cu``, K3) fuses, per element of every parameter tensor
of one optimizer step:

    g  ← g if norm < max_norm else (g / norm)·max_norm   (optional clip)
    g  ← g + wd·p                 (L2-into-gradient, the recipe's decay mask)
    m' ← β₁·m + (1−β₁)·g
    v' ← β₂·v + (1−β₂)·g²
    p  ← p − lr · (m'/bc₁) / (√(v'/bc₂) + ε)

with f32 moments, reading p, g, m, v once and writing p, m, v once. The
JAX kernel emits Δp and leaves ``p + Δp`` to ``optax.apply_updates``; the
port writes the same f32 sum in place. The clip is the recipe's
``optax.clip_by_global_norm`` folded in: its trigger and rounding order,
with the pre-clip global norm read from the device, so nothing waits for
the host.

- :func:`fused_adam` updates a list of tensors in place (the step's
  table: params, grads, first and second moments, and a weight decay per
  tensor): CUDA tensors take one kernel launch over all of them (built
  with nvcc at first use, ops/_build.py; a launch takes up to the
  kernel's capacity, 384 tensors) or raise; CPU tensors run
  :func:`fused_adam_multi_plain`, which loops :func:`fused_adam_plain`,
  the same function in plain PyTorch, over the same table.
  ``chip_smoke.py`` also holds the kernel against it on the card.
  ``fused_adam.launches`` counts kernel launches.
- :class:`FusedAdam` is the ``torch.optim.Optimizer`` around it (the JAX
  ``fused_adam`` GradientTransformation): per-param f32 state ``mu`` and
  ``nu``, one shared ``count``, ``lr`` a float or a schedule (a callable
  of the count), weight decay per param group (the decay mask). Its
  ``step(norm, max_norm)`` launches the kernel once over every param
  that has a gradient.

Semantics kept from the JAX package: lr is evaluated at the
pre-increment count; the bias corrections use ``count + 1`` and are
computed in f32; β₁, β₂ and ε are fixed at construction while lr, wd, bc₁
and bc₂ are launch arguments. The TPU's (8, 128) zero padding has no
counterpart: the kernel takes a flat length and guards its edge. The JAX
refusal of ``params=None`` has none either, since the optimizer owns its
params; a param whose ``.grad`` is None is skipped, as in ``torch.optim``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from . import _build

_KERNEL = "fused_adam"


def bias_corrections(b1: float, b2: float, count: int) -> tuple[float, float]:
    """(1 − β₁^(count+1), 1 − β₂^(count+1)) in f32, as the JAX package
    computes them from the pre-increment count."""
    n = np.float32(count + 1)
    one = np.float32(1.0)
    return (float(one - np.power(np.float32(b1), n)),
            float(one - np.power(np.float32(b2), n)))


def clip_plain(g: torch.Tensor, norm: torch.Tensor,
               max_norm: float) -> torch.Tensor:
    """The kernel's clip in plain PyTorch, optax's
    ``clip_by_global_norm`` for one tensor: g while ``norm < max_norm``,
    else ``(g / norm) * max_norm``."""
    return torch.where(norm < max_norm, g, (g / norm) * max_norm)


def fused_adam_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, *, lr: float, wd: float, bc1: float,
                     bc2: float, b1: float, b2: float, eps: float,
                     norm: Optional[torch.Tensor] = None,
                     max_norm: Optional[float] = None) -> None:
    """The kernel's function for one tensor in plain PyTorch, in place on
    p, m, v. With ``max_norm``, g is first clipped by the pre-clip global
    ``norm`` (a 0-dim f32 tensor) in optax's form. Each operation rounds
    on its own, in the kernel's order."""
    g = g.float()
    if max_norm is not None:
        g = clip_plain(g, norm, max_norm)
    g = g + wd * p
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * (g * g))
    p.add_((-lr * (m / bc1)) / (torch.sqrt(v / bc2) + eps))


def fused_adam_multi_plain(params: Sequence[torch.Tensor],
                           grads: Sequence[torch.Tensor],
                           mus: Sequence[torch.Tensor],
                           nus: Sequence[torch.Tensor],
                           wds: Sequence[float], **kw) -> None:
    """:func:`fused_adam_plain` over every tensor of the table: the
    function of one kernel launch."""
    for p, g, m, v, wd in zip(params, grads, mus, nus, wds):
        fused_adam_plain(p, g, m, v, wd=wd, **kw)


def _library() -> ctypes.CDLL:
    lib = _build.load_library(_KERNEL)
    fn = lib.kftpu_fused_adam
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_float] * 9
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    return lib


def fused_adam_cuda(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
                    wds: Sequence[float], *, lr: float, bc1: float,
                    bc2: float, b1: float, b2: float, eps: float,
                    norm: Optional[torch.Tensor] = None,
                    max_norm: Optional[float] = None) -> None:
    """Launch K3 once over the table on the current stream, in place on
    the params and moments. Takes contiguous f32 CUDA tensors on one
    device, each quadruple of one shape, and ``norm`` a 0-dim f32 tensor
    there when ``max_norm`` is given; raises on anything else and on a
    launch error."""
    quads = list(zip(params, grads, mus, nus))
    if not quads:
        return
    dev = params[0].device
    if dev.type != "cuda":
        raise ValueError(f"p[0] is on {dev}; the kernel takes CUDA tensors")
    index = dev.index
    f32 = torch.float32
    ptrs = []
    for i, quad in enumerate(quads):
        shape = quad[0].shape
        for name, x in zip("pgmv", quad):
            if not (x.dtype is f32 and x.is_contiguous() and
                    x.shape == shape and x.get_device() == index):
                raise ValueError(
                    f"{name}[{i}]: {x.dtype} {tuple(x.shape)} on {x.device} "
                    f"(contiguous {x.is_contiguous()}); the kernel takes "
                    f"contiguous float32 tensors on {dev}, shaped like p "
                    f"{tuple(shape)}")
            ptrs.append(x.data_ptr())
    if max_norm is not None and (
            norm is None or norm.device != dev or
            norm.dtype != torch.float32 or norm.numel() != 1):
        raise ValueError("clipping needs the pre-clip global norm as one "
                         "f32 value on the params' device")
    n = len(quads)
    table = (ctypes.c_int64 * (4 * n))(*ptrs)
    lengths = (ctypes.c_int64 * n)(*(quad[0].numel() for quad in quads))
    decays = (ctypes.c_float * n)(*wds)
    launched = ctypes.c_int(0)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.kftpu_fused_adam(
            table, lengths, decays, n,
            None if max_norm is None else norm.data_ptr(),
            0.0 if max_norm is None else max_norm, lr, bc1, bc2, b1,
            1.0 - b1, b2, 1.0 - b2, eps, stream, ctypes.byref(launched))
    fused_adam.launches += launched.value
    _build.check(lib, err, "fused_adam launch")


def fused_adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
               wds: Sequence[float], *, lr: float, bc1: float, bc2: float,
               b1: float, b2: float, eps: float,
               norm: Optional[torch.Tensor] = None,
               max_norm: Optional[float] = None) -> None:
    """One fused update of every tensor of the table, in place: one kernel
    launch for CUDA tensors, the plain version for CPU tensors."""
    if not params:
        return
    fn = fused_adam_multi_plain if params[0].device.type == "cpu" \
        else fused_adam_cuda
    fn(params, grads, mus, nus, wds, lr=lr, bc1=bc1, bc2=bc2, b1=b1, b2=b2,
       eps=eps, norm=norm, max_norm=max_norm)


fused_adam.launches = 0


class FusedAdam(torch.optim.Optimizer):
    """Adam with L2 decay folded into the gradient, one fused kernel
    launch a step over every param that has a gradient. ``lr`` is a float
    or a callable of the pre-increment count; ``weight_decay`` is per
    param group, so the decay mask is a split into groups."""

    def __init__(self, params: Iterable, lr: Union[float, Callable] = 1e-3,
                 *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, {"weight_decay": weight_decay})
        self.lr = lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0

    def current_lr(self) -> float:
        """lr at the pre-increment count, in f32."""
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        return float(np.float32(lr))

    @torch.no_grad()
    def step(self, norm: Optional[torch.Tensor] = None,
             max_norm: Optional[float] = None) -> None:
        """One update. With ``max_norm``, the gradients are first clipped
        by ``norm``, their pre-clip global norm (a 0-dim f32 tensor), in
        optax's form, inside the same launch."""
        if max_norm is not None and norm is None:
            raise ValueError("max_norm needs the pre-clip global norm")
        table = ([], [], [], [], [])
        for group in self.param_groups:
            wd = float(np.float32(group["weight_decay"]))
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p, dtype=torch.float32)
                    state["nu"] = torch.zeros_like(p, dtype=torch.float32)
                for column, x in zip(table, (p, p.grad, state["mu"],
                                             state["nu"], wd)):
                    column.append(x)
        bc1, bc2 = bias_corrections(self.b1, self.b2, self.count)
        fused_adam(*table, lr=self.current_lr(), bc1=bc1, bc2=bc2,
                   b1=self.b1, b2=self.b2, eps=self.eps, norm=norm,
                   max_norm=max_norm)
        self.count += 1

    def state_dict(self) -> dict:
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)
