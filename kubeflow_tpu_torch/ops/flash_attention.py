"""Flash attention forward: a hand-written CUDA kernel for Hopper.

The counterpart of ``kubeflow_tpu/ops/flash_attention.py``. The public
:func:`flash_attention` keeps the JAX layout ``[batch, seq, heads,
head_dim]`` and semantics: causal mask top-left aligned, q scaled in f32
inside the kernel, ``lse`` returned as ``[batch, heads, seq]`` f32 with
``with_lse``.

- A CUDA tensor launches ``csrc/flash_attention_fwd.cu`` (built with
  nvcc at first use, ops/_build.py) or raises. Nothing falls back.
- A CPU tensor runs :func:`flash_attention_fwd_plain`, the same function
  in plain PyTorch; the tests compare both with the JAX package, and
  ``chip_smoke.py`` compares the kernel with it on the card.
- ``flash_attention.launches`` counts kernel launches, so a run can show
  that its attention went through the kernel.

Serving needs no gradient and the backward kernels are not ported yet,
so the CUDA path refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30  # big-but-finite: avoids NaN from (-inf) - (-inf)

_KERNEL = "flash_attention_fwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              scale: Optional[float] = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: f32 scores from f32-scaled
    q, mask ``cols <= rows`` to -1e30, softmax with l clamped at 1e-30.
    q: [B, Sq, H, D], k/v: [B, Sk, H, D] → (o [B, Sq, H, D] in q's dtype,
    lse [B, H, Sq] f32)."""
    d = q.shape[-1]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    qf = q.float() * scale
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / \
        l.squeeze(-1).transpose(1, 2)[..., None]
    lse = (m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype), lse


def _check_inputs(q, k, v) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}; the kernel takes "
                             f"CUDA tensors")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype not in _DTYPES:
            raise TypeError(f"{name} dtype {x.dtype}: the kernel takes "
                            f"float32 or bfloat16")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} dtype {x.dtype} != q dtype {q.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be [batch, seq, heads, head_dim],"
                             f" got {tuple(x.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} head_dim must be unit-stride, got "
                             f"strides {x.stride()}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if d % 8 or d > 128:
        raise ValueError(f"head_dim {d}: the kernel takes a multiple of 8 "
                         f"up to 128")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the grid limit 65535")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention on CUDA is forward-only: the backward kernels "
            "(ops/flash_attention.py _bwd_dq_kernel/_bwd_dkv_kernel) are "
            "not yet ported")


def _library() -> ctypes.CDLL:
    lib = _build.load_library(_KERNEL)
    fn = lib.kftpu_flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
    return lib


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             scale: Optional[float] = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream. Same contract as
    :func:`flash_attention_fwd_plain`; raises on anything it does not
    take, and on a launch error."""
    _check_inputs(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 9)(
        *(x.stride(i) for x in (q, k, v) for i in (0, 1, 2)))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.kftpu_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, sq, sk, d, strides, scale, int(causal),
            _DTYPES[q.dtype], stream)
    _build.check(lib, err, "flash_attention_fwd launch")
    flash_attention.launches += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    with_lse: bool = False):
    """Fused attention. q, k, v: [batch, seq, heads, head_dim].

    Returns [batch, seq, heads, head_dim]; with ``with_lse`` also the
    per-row log-sum-exp [batch, heads, seq] (f32). CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        o, lse = flash_attention_fwd_plain(q, k, v, causal=causal,
                                           scale=scale)
    else:
        o, lse = flash_attention_fwd_cuda(q, k, v, causal=causal,
                                          scale=scale)
    return (o, lse) if with_lse else o


flash_attention.launches = 0


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Naive O(S^2)-memory attention in the input dtype — the port of the
    JAX package's correctness oracle."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)
