"""Flash attention, forward and backward: hand-written CUDA kernels for Hopper.

The counterpart of ``kubeflow_tpu/ops/flash_attention.py``. The public
:func:`flash_attention` keeps the JAX layout ``[batch, seq, heads,
head_dim]`` and semantics: causal mask top-left aligned, q scaled in f32
inside the kernel, ``lse`` returned as ``[batch, heads, seq]`` f32 with
``with_lse``.

- :func:`flash_attention` is a ``torch.autograd.Function``: its forward is
  K1 (``csrc/flash_attention_fwd.cu``) and saves ``q, k, v, o, lse``; its
  backward computes ``delta = rowsum(do * o)`` with torch ops, as the JAX
  package does outside its kernels, then launches K2a (dq) and K2b (dk,
  dv) from ``csrc/flash_attention_bwd.cu``. ``with_lse`` stays
  forward-only, as in the JAX package: on CUDA, an input that requires
  grad there raises.
- A CUDA tensor launches the kernels (built with nvcc at first use,
  ops/_build.py) or raises. Nothing falls back. The dtype, the head dim
  and the layout pick the kernel (:func:`kernel_route`): bf16 K1, K2a and
  K2b at a head dim that is a multiple of 8 up to 128 run on the tensor
  cores and stage their tiles with 16-byte asynchronous copies, so their
  inputs need 16-byte aligned pointers and strides that are multiples of
  8 elements (:func:`async_ready`; the model's fused-qkv slices pass); f32
  at any head dim, bf16 at the others (above 128, or not a multiple of
  8), and a bf16 view that the 16-byte copies cannot read run the FMA
  kernels, which load each element in its own type and compute in f32.
  That last route is counted (``unaligned_launches`` beside
  ``launches``). The FMA kernels take any head dim (above 256 in chunks
  of 256 columns, the output's columns split over the grid) and every
  kernel any batch*heads (a flat grid).
- A CPU tensor runs the plain PyTorch versions
  (:func:`flash_attention_fwd_plain`, :func:`flash_attention_bwd_dq_plain`,
  :func:`flash_attention_bwd_dkv_plain`); the tests compare them with the
  JAX package, and ``chip_smoke.py`` compares the kernels with them on the
  card.
- ``flash_attention.launches``, ``flash_attention_bwd_dq.launches`` and
  ``flash_attention_bwd_dkv.launches`` count kernel launches, so a run can
  show that its attention went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30  # big-but-finite: avoids NaN from (-inf) - (-inf)

_FWD = "flash_attention_fwd"
_BWD = "flash_attention_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """True where a score is masked out: ``cols > rows``."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    return cols > rows


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              scale: Optional[float] = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: f32 scores from
    f32-scaled q, mask ``cols <= rows`` to -1e30, softmax with l clamped
    at 1e-30. q: [B, Sq, H, D], k/v: [B, Sk, H, D] → (o [B, Sq, H, D] in
    q's dtype, lse [B, H, Sq] f32)."""
    scale = _scale(q, scale)
    qf = q.float() * scale
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if causal:
        s = s.masked_fill(_causal_mask(q.shape[1], k.shape[1], q.device),
                          NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / \
        l.squeeze(-1).transpose(1, 2)[..., None]
    lse = (m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype), lse


def _probs(q, k, lse, causal: bool, scale: float) -> torch.Tensor:
    """p = exp((q.k^T) * scale - lse) in f32, masked to 0 above the
    diagonal: [B, H, Sq, Sk]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(_causal_mask(q.shape[1], k.shape[1], q.device),
                          0.0)
    return p


def _ds(p, v, do, delta) -> torch.Tensor:
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p * (dp - delta[..., None])


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, *,
                                 causal: bool = True,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """K2a's function in plain PyTorch: dq = scale * sum_k ds.k, in q's
    dtype. lse and delta: [B, H, Sq] f32."""
    scale = _scale(q, scale)
    ds = _ds(_probs(q, k, lse, causal, scale), v, do, delta)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
            ).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, *,
                                  causal: bool = True,
                                  scale: Optional[float] = None
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2b's function in plain PyTorch: dk = scale * sum_q ds^T.q and
    dv = sum_q p^T.do, in k's and v's dtype."""
    scale = _scale(q, scale)
    p = _probs(q, k, lse, causal, scale)
    ds = _ds(p, v, do, delta)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * o) in f32, as [B, H, S] (the JAX package's
    ``_flash_bwd`` computes it outside its kernels the same way)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              scale: Optional[float] = None):
    """The whole backward in plain PyTorch: (dq, dk, dv) from the saved
    forward (o, lse) and the output gradient do."""
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                      causal=causal, scale=scale)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                           causal=causal, scale=scale)
    return dq, dk, dv


# -- the CUDA kernels ---------------------------------------------------------


# the FMA kernels' chunk of the head dim, and the most chunks the grid's
# second dimension holds
HEAD_DIM_CHUNK, MAX_HEAD_DIM_CHUNKS = 256, 65535


def _check_head_dim(q) -> None:
    """The kernels pad the head dim to 32, 64, 128 or 256; above 256 the
    FMA kernels run in chunks of 256 columns, one chunk a grid row."""
    d = q.shape[-1]
    if not 0 < d <= HEAD_DIM_CHUNK * MAX_HEAD_DIM_CHUNKS:
        raise ValueError(f"head_dim {d}: the kernels take 1 to "
                         f"{HEAD_DIM_CHUNK * MAX_HEAD_DIM_CHUNKS}")


def tensor_core_route(q: torch.Tensor) -> bool:
    """Whether the bf16 tensor-core kernels take ``q``'s head dim (a
    multiple of 8 up to 128, their 16-byte copies); the FMA kernels take
    every other one."""
    d = q.shape[-1]
    return q.dtype == torch.bfloat16 and d % 8 == 0 and d <= 128


def _check_inputs(q, k, v) -> None:
    """What the kernels take."""
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
    _check_head_dim(q)


def async_ready(x: torch.Tensor) -> bool:
    """Whether the 16-byte asynchronous copies of the bf16 kernels can read
    ``x`` ([batch, seq, heads, head_dim], unit-stride head dim): a 16-byte
    aligned ``data_ptr()`` and (batch, seq, head) strides that are
    multiples of 8 elements wherever that dim has more than one index."""
    return x.data_ptr() % 16 == 0 and all(
        x.shape[i] == 1 or x.stride(i) % 8 == 0 for i in range(3))


def kernel_route(q: torch.Tensor, *others: torch.Tensor) -> str:
    """Which kernel a call on ``q`` and the other inputs takes:
    ``"tensor_core"`` (bf16 at a head dim the tensor cores take, every view
    :func:`async_ready`), ``"fma_unaligned"`` (the same dtype and head dim,
    but a view the 16-byte copies cannot read: the bf16 FMA instance reads
    scalars, so nothing is copied behind the caller's back) or ``"fma"``
    (f32, and every other head dim). The kernels' own dispatch makes the
    same choice."""
    if not tensor_core_route(q):
        return "fma"
    if all(async_ready(x) for x in (q, *others)):
        return "tensor_core"
    return "fma_unaligned"


def _check_bwd_inputs(q, k, v, do, lse, delta) -> None:
    _check_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or \
            do.device != q.device or do.stride(-1) != 1:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} on {do.device} "
                         f"(strides {do.stride()}) must match q "
                         f"{tuple(q.shape)} {q.dtype} with a unit-stride "
                         f"head dim")
    b, sq, h, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b, h, sq) or x.dtype != torch.float32 or \
                x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 {(b, h, sq)} "
                             f"on {q.device}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")


def _library(name: str) -> ctypes.CDLL:
    lib = _build.load_library(name)
    if name == _FWD:
        fns = [(lib.kftpu_flash_attention_fwd, 5)]
    else:
        fns = [(lib.kftpu_flash_attention_bwd_dq, 7),
               (lib.kftpu_flash_attention_bwd_dkv, 8)]
    for fn, pointers in fns:
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 5
                           + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p])
    return lib


def _strides(*xs: torch.Tensor):
    return (ctypes.c_int64 * (3 * len(xs)))(
        *(x.stride(i) for x in xs for i in (0, 1, 2)))


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             scale: Optional[float] = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on the current stream (the tensor-core kernel or the FMA
    kernel, :func:`kernel_route`). Same contract as
    :func:`flash_attention_fwd_plain`; raises on anything it does not
    take, and on a launch error."""
    _check_inputs(q, k, v)
    route = kernel_route(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _library(_FWD)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.kftpu_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, sq, sk, d, _strides(q, k, v),
            _scale(q, scale), int(causal), _DTYPES[q.dtype], stream)
    _build.check(lib, err, "flash_attention_fwd launch")
    flash_attention.launches += 1
    flash_attention.unaligned_launches += route == "fma_unaligned"
    return o, lse


def flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, *,
                                causal: bool = True,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Launch K2a on the current stream (the tensor-core kernel or the FMA
    kernel, :func:`kernel_route`). Same contract as
    :func:`flash_attention_bwd_dq_plain`; raises on anything it does not
    take, and on a launch error."""
    _check_bwd_inputs(q, k, v, do, lse, delta)
    route = kernel_route(q, k, v, do)
    b, sq, h, d = q.shape
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lib = _library(_BWD)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.kftpu_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq,
            k.shape[1], d, _strides(q, k, v, do), _scale(q, scale),
            int(causal), _DTYPES[q.dtype], stream)
    _build.check(lib, err, "flash_attention_bwd_dq launch")
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.unaligned_launches += route == "fma_unaligned"
    return dq


def flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, *,
                                 causal: bool = True,
                                 scale: Optional[float] = None
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2b on the current stream (the tensor-core kernel or the FMA
    kernel, :func:`kernel_route`). Same contract as
    :func:`flash_attention_bwd_dkv_plain`."""
    _check_bwd_inputs(q, k, v, do, lse, delta)
    route = kernel_route(q, k, v, do)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=v.device)
    lib = _library(_BWD)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.kftpu_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, sq, sk, d, _strides(q, k, v, do), _scale(q, scale),
            int(causal), _DTYPES[q.dtype], stream)
    _build.check(lib, err, "flash_attention_bwd_dkv launch")
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.unaligned_launches += route == "fma_unaligned"
    return dk, dv


# -- public functions: CPU tensors take the plain version, CUDA the kernel ---


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """dq of attention (K2a on CUDA tensors)."""
    fn = flash_attention_bwd_dq_plain if q.device.type == "cpu" \
        else flash_attention_bwd_dq_cuda
    return fn(q, k, v, do, lse, delta, causal=causal, scale=scale)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            scale: Optional[float] = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of attention (K2b on CUDA tensors)."""
    fn = flash_attention_bwd_dkv_plain if q.device.type == "cpu" \
        else flash_attention_bwd_dkv_cuda
    return fn(q, k, v, do, lse, delta, causal=causal, scale=scale)


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.unaligned_launches = 0
flash_attention_bwd_dkv.unaligned_launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        scale: Optional[float] = None):
    """(dq, dk, dv) from the saved forward: delta with torch ops, then
    K2a and K2b (the plain versions for CPU tensors)."""
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                                scale=scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                                     scale=scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2 backward (``jax.custom_vjp`` around ``_flash``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        fwd = flash_attention_fwd_plain if q.device.type == "cpu" \
            else flash_attention_fwd_cuda
        o, lse = fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # the upstream gradient's layout is autograd's choice, not the
        # caller's: give the kernels one they take
        if do.stride(-1) != 1 or (do.is_cuda and tensor_core_route(q)
                                  and not async_ready(do)):
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    with_lse: bool = False):
    """Fused attention. q, k, v: [batch, seq, heads, head_dim].

    Returns [batch, seq, heads, head_dim], differentiable through the
    backward kernels; with ``with_lse`` also the per-row log-sum-exp
    [batch, heads, seq] (f32), forward-only. CPU tensors take the plain
    versions; CUDA tensors launch the kernels."""
    scale = _scale(q, scale)
    if not with_lse:
        return _FlashAttention.apply(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention(with_lse=True) is forward-only, as in the JAX "
            "package: do not differentiate through it")
    return flash_attention_fwd_cuda(q, k, v, causal=causal, scale=scale)


flash_attention.launches = 0
flash_attention.unaligned_launches = 0


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Naive O(S^2)-memory attention in the input dtype — the port of the
    JAX package's correctness oracle."""
    scale = _scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        s = s.masked_fill(_causal_mask(q.shape[1], k.shape[1], q.device),
                          NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)
