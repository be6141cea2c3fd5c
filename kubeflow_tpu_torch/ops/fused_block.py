"""Fused ResNet bottleneck block, inference: BatchNorm folded to an affine
and the whole stride-1 block as one hand-written CUDA kernel call (K6).

The counterpart of ``kubeflow_tpu/ops/fused_block.py``. One stride-1
bottleneck at eval,

    conv1x1 → scale/shift → relu → conv3x3 → scale/shift → relu →
    conv1x1 → scale/shift → (+ x | scale/shift(conv_proj x)) → relu

with each BatchNorm's running statistics folded into a per-channel scale
and shift (:func:`fold_block`). Every image is independent and BN is
folded, so the batch tile does not change what the block computes:
``block_bt`` is accepted and checked as the JAX package does, and the
CUDA kernel tiles as it likes.

- :func:`fused_bottleneck_eval` is the public block. A CUDA tensor
  launches the kernel of ``csrc/fused_block.cu`` (built with nvcc at first
  use, ops/_build.py) or raises; nothing falls back. A CPU tensor runs the
  plain version, :func:`fused_bottleneck_eval_plain`, which rounds where the
  TPU kernel rounds: h1, h2, h3 and the projection to the input dtype, and
  the residual sum of the two rounded branches once more.
  ``fused_bottleneck_eval.launches`` counts kernel calls.
- :func:`reference_bottleneck_eval` is the JAX package's executable spec:
  it keeps ``h3 + res`` in f32, so it is not the kernel's plain version.

Weights follow the port's naming (the flax path joined with dots):
:func:`fold_block` reads ``Conv_0.kernel`` … ``norm_proj.bias`` from one
block's params and ``BatchNorm_0.mean`` … from its batch_stats.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["FusedBlockWeights", "fold_block", "fused_bottleneck_eval",
           "fused_bottleneck_eval_plain", "reference_bottleneck_eval",
           "default_block_bt"]

_KERNEL = "fused_block"


@dataclass(frozen=True)
class FusedBlockWeights:
    """One bottleneck block with BN folded to affine (eval semantics).

    wN: conv kernels — w1 (Cin, Cmid), w2 (3, 3, Cmid, Cmid), w3 (Cmid,
    Cout); sN/bN: the folded scale and shift, s = γ·rsqrt(var + eps),
    b = β − mean·s, f32. wp/sp/bp: the projection shortcut for Cin ≠ Cout
    blocks (1x1, stride 1)."""

    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    s3: torch.Tensor
    b3: torch.Tensor
    wp: Optional[torch.Tensor] = None
    sp: Optional[torch.Tensor] = None
    bp: Optional[torch.Tensor] = None


def _fold_bn(params: dict, stats: dict, name: str,
             eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm ``name`` folded to (s, b) = (scale·rsqrt(var + eps), bias −
    mean·s) in f32, from ``{name}.scale`` / ``.bias`` in ``params`` and
    ``{name}.mean`` / ``.var`` in ``stats``."""
    s = params[f"{name}.scale"].float() * torch.rsqrt(
        stats[f"{name}.var"].float() + eps)
    return s, params[f"{name}.bias"].float() - stats[f"{name}.mean"].float() * s


def fold_block(block_params: dict, block_stats: dict,
               eps: float = 1e-5) -> FusedBlockWeights:
    """Fold one BottleneckBlock's params and batch_stats (dotted names
    relative to the block: ``Conv_0.kernel``, ``BatchNorm_0.scale``,
    ``BatchNorm_0.mean`` …, ``conv_proj`` / ``norm_proj`` when present)."""
    s1, b1 = _fold_bn(block_params, block_stats, "BatchNorm_0", eps)
    s2, b2 = _fold_bn(block_params, block_stats, "BatchNorm_1", eps)
    s3, b3 = _fold_bn(block_params, block_stats, "BatchNorm_2", eps)
    wp = sp = bp = None
    if "conv_proj.kernel" in block_params:
        wp = block_params["conv_proj.kernel"][0, 0]      # (Cin, Cout)
        sp, bp = _fold_bn(block_params, block_stats, "norm_proj", eps)
    return FusedBlockWeights(
        w1=block_params["Conv_0.kernel"][0, 0],          # (Cin, Cmid)
        s1=s1, b1=b1,
        w2=block_params["Conv_1.kernel"],                # (3, 3, Cmid, Cmid)
        s2=s2, b2=b2,
        w3=block_params["Conv_2.kernel"][0, 0],          # (Cmid, Cout)
        s3=s3, b3=b3, wp=wp, sp=sp, bp=bp)


def _mm(a: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``a @ w.astype(dt)`` with f32 accumulation: products of dt values,
    summed in f32."""
    return torch.matmul(a.float(), w.to(dt).float())


def _h2(x: torch.Tensor, w: FusedBlockWeights, wdt: torch.dtype
        ) -> torch.Tensor:
    """The block's interior: h1 = relu(x.w1·s1 + b1) and h2 = relu(3x3
    SAME conv of h1 · s2 + b2), each rounded to x's dtype, with the weights
    cast to ``wdt``; the conv as 9 shifted products summed in f32, tap by
    tap. Returns h2 as [N·H·W, Cmid]."""
    n, h, w_, cin = x.shape
    h1 = torch.relu(_mm(x.reshape(-1, cin), w.w1, wdt) * w.s1 + w.b1)
    pad = F.pad(h1.to(x.dtype).reshape(n, h, w_, -1), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((n * h * w_, w.w2.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            shifted = pad[:, dy:dy + h, dx:dx + w_, :].reshape(n * h * w_, -1)
            acc = acc + _mm(shifted, w.w2[dy, dx], wdt)
    return torch.relu(acc * w.s2 + w.b2).to(x.dtype)


def reference_bottleneck_eval(x: torch.Tensor, w: FusedBlockWeights
                              ) -> torch.Tensor:
    """The JAX package's executable spec in plain PyTorch: f32 weights,
    h1 and h2 rounded to x's dtype, the output branch and the residual kept
    in f32 until the final relu."""
    f32 = torch.float32
    xm = x.reshape(-1, x.shape[-1])
    h3 = _mm(_h2(x, w, f32), w.w3, f32) * w.s3 + w.b3
    res = _mm(xm, w.wp, f32) * w.sp + w.bp if w.wp is not None \
        else xm.float()
    return torch.relu(h3 + res).to(x.dtype).reshape(*x.shape[:3], -1)


def fused_bottleneck_eval_plain(x: torch.Tensor, w: FusedBlockWeights
                                ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, rounded where the TPU kernel
    rounds: h1, h2, h3 and the projection to x's dtype, then ``relu`` of
    the two rounded branches added in f32 and rounded once."""
    dt = x.dtype
    xm = x.reshape(-1, x.shape[-1])
    h3 = (_mm(_h2(x, w, dt), w.w3, dt) * w.s3 + w.b3).to(dt)
    res = (_mm(xm, w.wp, dt) * w.sp + w.bp).to(dt) if w.wp is not None \
        else xm
    out = torch.relu((h3.float() + res.float()).to(dt))
    return out.reshape(*x.shape[:3], -1)


def default_block_bt(n: int, h: int, w: int, cin: int, cmid: int,
                     cout: int) -> int:
    """The JAX package's default batch tile: the images whose in and out
    tiles, interiors and f32 accumulators fit 6 MiB, lowered until the tile
    divides the batch. It sets the TPU kernel's grid only: every image is
    independent, so the tile does not change the output."""
    per_image = h * w * ((cin + cout) * 2 + cmid * 12)
    bt = max(1, int((6 * 2 ** 20) // max(per_image, 1)))
    while n % bt:
        bt -= 1
    return bt


# -----------------------------------------------------------------------------
# the CUDA kernel (csrc/fused_block.cu)
# -----------------------------------------------------------------------------

_DIMS = ("N", "H", "W", "Cin", "Cmid", "Cout", "proj")
_PTRS = ("x", "w1", "w2", "w3", "wp", "s1", "b1", "s2", "b2", "s3", "b3",
         "sp", "bp", "h1", "h2", "out")


class BlockEvalArgs(ctypes.Structure):
    """``KftpuBlockEvalArgs`` of the CUDA source: every field 8 bytes."""
    _fields_ = ([(d, ctypes.c_int64) for d in _DIMS]
                + [(p, ctypes.c_void_p) for p in _PTRS])


def _library() -> ctypes.CDLL:
    lib = _build.load_library(_KERNEL)
    if lib.kftpu_block_eval.argtypes is None:
        lib.kftpu_block_eval.restype = ctypes.c_int
        lib.kftpu_block_eval.argtypes = [ctypes.POINTER(BlockEvalArgs),
                                         ctypes.c_void_p]
    return lib


def _operand(t: torch.Tensor, shape: tuple, dtype: torch.dtype,
             device: torch.device, what: str) -> torch.Tensor:
    """``t`` as a contiguous, 16-byte aligned ``dtype`` tensor on
    ``device``; raises on a shape or device the kernel does not take."""
    if tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{what}: {tuple(t.shape)} on {t.device}, "
                         f"expected {shape} on {device}")
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_block_eval(x: torch.Tensor, w: FusedBlockWeights
                      ) -> torch.Tensor:
    """One call of the CUDA block on the current stream: [N, H, W, Cout]
    bf16."""
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}; the kernel takes CUDA tensors")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x dtype {x.dtype}: the kernel takes bfloat16")
    if x.dim() != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"x {tuple(x.shape)} must be a contiguous, 16-byte "
                         f"aligned NHWC tensor")
    n, h, w_, cin = x.shape
    cmid, cout = w.w1.shape[-1], w.w3.shape[-1]
    has_proj = w.wp is not None
    if cin % 8 or cmid % 8 or cout % 8:
        raise ValueError(f"channels ({cin}, {cmid}, {cout}) must be "
                         f"multiples of 8")
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    ops = {"w1": _operand(w.w1, (cin, cmid), bf, dev, "w1"),
           "w2": _operand(w.w2, (3, 3, cmid, cmid), bf, dev, "w2"),
           "w3": _operand(w.w3, (cmid, cout), bf, dev, "w3")}
    for k, c in (("1", cmid), ("2", cmid), ("3", cout)):
        for p in "sb":
            ops[p + k] = _operand(getattr(w, p + k), (c,), f32, dev, p + k)
    if has_proj:
        ops["wp"] = _operand(w.wp, (cin, cout), bf, dev, "wp")
        ops["sp"] = _operand(w.sp, (cout,), f32, dev, "sp")
        ops["bp"] = _operand(w.bp, (cout,), f32, dev, "bp")
    m = n * h * w_
    scratch = torch.empty((2, m, cmid), dtype=bf, device=dev)
    out = torch.empty((n, h, w_, cout), dtype=bf, device=dev)
    a = BlockEvalArgs(N=n, H=h, W=w_, Cin=cin, Cmid=cmid, Cout=cout,
                      proj=int(has_proj))
    a.x, a.h1, a.h2, a.out = (x.data_ptr(), scratch[0].data_ptr(),
                              scratch[1].data_ptr(), out.data_ptr())
    for name, t in ops.items():
        setattr(a, name, t.data_ptr())
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.kftpu_block_eval(ctypes.byref(a), stream)
    _build.check(lib, err, "fused_block_eval")
    return out


# -----------------------------------------------------------------------------
# the public block: the kernel for CUDA tensors, the plain version for CPU
# tensors
# -----------------------------------------------------------------------------

def fused_bottleneck_eval(x: torch.Tensor, w: FusedBlockWeights, *,
                          block_bt: Optional[int] = None) -> torch.Tensor:
    """The fused inference block, stride 1 only (callers route strided
    blocks to plain ops). ``block_bt`` must divide the batch; it does not
    change the result."""
    n, h, w_, cin = x.shape
    cmid, cout = w.w1.shape[-1], w.w3.shape[-1]
    if w.wp is None and cin != cout:
        raise ValueError(f"Cin {cin} != Cout {cout} needs a projection")
    if block_bt is None:
        block_bt = default_block_bt(n, h, w_, cin, cmid, cout)
    elif n % block_bt:
        raise ValueError(
            f"block_bt {block_bt} must divide batch {n} (a partial last "
            f"tile would leave output rows unwritten)")
    if x.device.type == "cpu":
        return fused_bottleneck_eval_plain(x, w)
    out = launch_block_eval(x, w)
    fused_bottleneck_eval.launches += 1
    return out


fused_bottleneck_eval.launches = 0
