"""Fused Adam update: a hand-written CUDA kernel for Hopper.

The counterpart of ``kubeflow_tpu/ops/fused_adam.py``. One kernel
(``csrc/fused_adam.cu``, K3) fuses, per element of one parameter tensor:

    g  ← g + wd·p                 (L2-into-gradient, the recipe's decay mask)
    m' ← β₁·m + (1−β₁)·g
    v' ← β₂·v + (1−β₂)·g²
    p  ← p − lr · (m'/bc₁) / (√(v'/bc₂) + ε)

with f32 moments, reading p, g, m, v once and writing p, m, v once. The
JAX kernel emits Δp and leaves ``p + Δp`` to ``optax.apply_updates``; the
port writes the same f32 sum in place.

- :func:`fused_adam` updates one tensor in place: a CUDA tensor launches
  the kernel (built with nvcc at first use, ops/_build.py) or raises; a
  CPU tensor runs :func:`fused_adam_plain`, the same function in plain
  PyTorch, which ``chip_smoke.py`` also holds the kernel against on the
  card. ``fused_adam.launches`` counts kernel launches.
- :class:`FusedAdam` is the ``torch.optim.Optimizer`` around it (the JAX
  ``fused_adam`` GradientTransformation): per-param f32 state ``mu`` and
  ``nu``, one shared ``count``, ``lr`` a float or a schedule (a callable
  of the count), weight decay per param group (the decay mask). Its
  ``step()`` launches the kernel once per parameter tensor.

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
from typing import Callable, Iterable, Union

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


def fused_adam_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, *, lr: float, wd: float, bc1: float,
                     bc2: float, b1: float, b2: float, eps: float) -> None:
    """The kernel's function in plain PyTorch, in place on p, m, v. Each
    operation rounds on its own, in the kernel's order."""
    g = g.float() + wd * p
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * (g * g))
    p.add_((-lr * (m / bc1)) / (torch.sqrt(v / bc2) + eps))


def _library() -> ctypes.CDLL:
    lib = _build.load_library(_KERNEL)
    fn = lib.kftpu_fused_adam
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                       + [ctypes.c_float] * 9 + [ctypes.c_void_p])
    return lib


def fused_adam_cuda(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, *, lr: float, wd: float, bc1: float,
                    bc2: float, b1: float, b2: float, eps: float) -> None:
    """Launch K3 on the current stream, in place on p, m, v. Takes
    contiguous f32 CUDA tensors of one shape; raises on anything else and
    on a launch error."""
    for name, x in (("p", p), ("g", g), ("m", m), ("v", v)):
        if x.device.type != "cuda" or x.device != p.device:
            raise ValueError(f"{name} is on {x.device}; the kernel takes "
                             f"CUDA tensors on one device")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} dtype {x.dtype}: the kernel takes "
                            f"float32")
        if x.shape != p.shape or not x.is_contiguous():
            raise ValueError(f"{name} {tuple(x.shape)} must be contiguous "
                             f"and shaped like p {tuple(p.shape)}")
    lib = _library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.kftpu_fused_adam(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            p.numel(), lr, wd, bc1, bc2, b1, 1.0 - b1, b2, 1.0 - b2, eps,
            stream)
    _build.check(lib, err, "fused_adam launch")
    fused_adam.launches += 1


def fused_adam(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, *, lr: float, wd: float, bc1: float,
               bc2: float, b1: float, b2: float, eps: float) -> None:
    """One tensor's fused update in place: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    fn = fused_adam_plain if p.device.type == "cpu" else fused_adam_cuda
    fn(p, g, m, v, lr=lr, wd=wd, bc1=bc1, bc2=bc2, b1=b1, b2=b2, eps=eps)


fused_adam.launches = 0


class FusedAdam(torch.optim.Optimizer):
    """Adam with L2 decay folded into the gradient, one fused kernel
    launch per parameter tensor. ``lr`` is a float or a callable of the
    pre-increment count; ``weight_decay`` is per param group, so the
    decay mask is a split into groups."""

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
    def step(self) -> None:
        lr = self.current_lr()
        bc1, bc2 = bias_corrections(self.b1, self.b2, self.count)
        for group in self.param_groups:
            wd = float(np.float32(group["weight_decay"]))
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p, dtype=torch.float32)
                    state["nu"] = torch.zeros_like(p, dtype=torch.float32)
                fused_adam(p, p.grad, state["mu"], state["nu"], lr=lr, wd=wd,
                           bc1=bc1, bc2=bc2, b1=self.b1, b2=self.b2,
                           eps=self.eps)
        self.count += 1

    def state_dict(self) -> dict:
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)
