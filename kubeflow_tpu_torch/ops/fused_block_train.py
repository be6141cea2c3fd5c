"""Fused ResNet bottleneck block, training mode: ghost-BN forward and
backward as hand-written CUDA kernels for Hopper (K4).

The counterpart of ``kubeflow_tpu/ops/fused_block_train.py``. One
stride-1 bottleneck,

    conv1x1 → BN → relu → conv3x3 → BN → relu → conv1x1 → BN
    → (+ residual | BN(conv_proj)) → relu

with **ghost BatchNorm**: statistics are taken per batch tile of
``tile_bt`` images, not over the whole batch. The tile is part of the
function (a different tile gives a different output), so this module
keeps the JAX package's VMEM working-set model verbatim
(``VMEM_BUDGET_BYTES``, ``_per_image_bytes``, ``default_tile_bt``) as the
definition of the ghost batch; the CUDA kernels' own block tiling is a
separate, free choice. Running statistics are updated with the
tile-averaged ghost moments.

- :func:`fused_bottleneck_train` is the public block: ``(out, ghost stats
  by BatchNorm name)``. It runs a ``torch.autograd.Function`` whose forward
  is :func:`fused_block_train_fwd` and whose backward is
  :func:`fused_block_train_bwd`; the forward returns its per-ghost means
  and rsqrt(var + eps) of the four BatchNorms (a few hundred KB a block,
  never the interiors), and the backward takes them, recomputes
  the interiors from x without recomputing the statistics, returns dx and
  every weight gradient (in the weights' dtype) and drops the cotangent of
  the ghost statistics, as the JAX ``_fused_bwd`` does. Given no saved
  statistics, the backward recomputes them with the forward's own
  launches, bit for bit the same.
- A CUDA tensor launches the kernels of ``csrc/fused_block_train.cu``
  (built with nvcc at first use, ops/_build.py) or raises. Nothing falls
  back. A CPU tensor runs the plain version,
  :func:`reference_bottleneck_train`, and its autograd gradients; the
  tests compare it with the JAX package, and ``chip_smoke.py`` compares the
  kernels with it on the card.
- ``fused_block_train_fwd.launches`` and ``fused_block_train_bwd.launches``
  count kernel calls: one a block a direction, whatever number of CUDA
  launches the call makes.

Weights follow the port's naming (the flax path joined with dots):
``block_weights`` reads ``Conv_0.kernel`` … ``norm_proj.bias`` from one
block's params and returns the kernel's positional tuple (conv kernels as
[Cin, Cmid], [3, 3, Cmid, Cmid], [Cmid, Cout], [Cin, Cout]).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from . import _build

__all__ = ["fused_bottleneck_train", "reference_bottleneck_train",
           "block_weights", "stats_to_tree", "default_tile_bt",
           "fits_vmem_budget", "VMEM_BUDGET_BYTES",
           "fused_block_train_fwd", "fused_block_train_bwd"]

_KERNEL = "fused_block_train"


# -----------------------------------------------------------------------------
# weight plumbing: one block's params ↔ a flat tuple
# -----------------------------------------------------------------------------

def block_weights(params: dict) -> tuple:
    """One BottleneckBlock's params (dotted names relative to the block)
    as the kernel's positional weight tuple. Projection blocks
    (``conv_proj``/``norm_proj`` present) append 3 more entries."""
    w = (params["Conv_0.kernel"][0, 0],
         params["BatchNorm_0.scale"], params["BatchNorm_0.bias"],
         params["Conv_1.kernel"],
         params["BatchNorm_1.scale"], params["BatchNorm_1.bias"],
         params["Conv_2.kernel"][0, 0],
         params["BatchNorm_2.scale"], params["BatchNorm_2.bias"])
    if "conv_proj.kernel" in params:
        w += (params["conv_proj.kernel"][0, 0],
              params["norm_proj.scale"], params["norm_proj.bias"])
    return w


def stats_to_tree(stats: tuple, has_proj: bool) -> dict:
    """Tile-averaged ghost moments by batch_stats name (mean/var per
    BatchNorm) for the running-stat EMA update."""
    m1, v1, m2, v2, m3, v3, mp, vp = stats
    tree = {"BatchNorm_0.mean": m1, "BatchNorm_0.var": v1,
            "BatchNorm_1.mean": m2, "BatchNorm_1.var": v2,
            "BatchNorm_2.mean": m3, "BatchNorm_2.var": v3}
    if has_proj:
        tree["norm_proj.mean"] = mp
        tree["norm_proj.var"] = vp
    return tree


# The ghost-batch definition, kept verbatim from the JAX package: the TPU
# kernel's VMEM working-set model decides over which samples BN takes its
# statistics, so changing it would change the function, not its speed.
VMEM_BUDGET_BYTES = 7 * 2 ** 20


def _per_image_bytes(h: int, w: int, cin: int, cmid: int, cout: int) -> int:
    """Backward working-set estimate per image (the heavier direction):
    x + g + dx tiles, bf16 interiors (h1, h2, x̂3, gz, da3), f32 (M,Cmid)
    temporaries and one f32 (M,Cout) temporary."""
    return h * w * (cin * 2 * 2 + cout * 2 * 4 + cout * 4
                    + cmid * (2 * 2 + 4 * 4))


def fits_vmem_budget(h: int, w: int, cin: int, cmid: int,
                     cout: int) -> bool:
    """Whether a one-image batch tile of this block's backward working
    set fits the budget; blocks that do not route to the spatial
    variant (ops/fused_block_train_spatial.py) or to plain ops."""
    return _per_image_bytes(h, w, cin, cmid, cout) <= VMEM_BUDGET_BYTES


def default_tile_bt(n: int, h: int, w: int, cin: int, cmid: int,
                    cout: int) -> int:
    """Largest batch tile whose working set fits the budget, lowered
    until it divides the batch; clamps to 1 even when one image busts
    the budget (callers check fits_vmem_budget first)."""
    per_image = _per_image_bytes(h, w, cin, cmid, cout)
    bt = max(1, int(VMEM_BUDGET_BYTES // max(per_image, 1)))
    while n % bt:
        bt -= 1
    return bt


# -----------------------------------------------------------------------------
# the plain version (differentiable): what the kernels must match
# -----------------------------------------------------------------------------

def _mm(a: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``a @ w.astype(dt)`` with f32 accumulation (the JAX einsum with
    ``preferred_element_type=f32``): products of dt values, summed in f32."""
    return torch.matmul(a.float(), w.to(dt).float())


def reference_bottleneck_train(x: torch.Tensor, weights: tuple, *,
                               tile_bt: int, eps: float = 1e-5
                               ) -> tuple[torch.Tensor, tuple]:
    """Ghost-BN bottleneck forward in plain PyTorch, tiled like the kernel
    grid ((n // tile_bt) ghost batches). Differentiable: its autograd
    gradients are the golden gradients for the backward kernel."""
    has_proj = len(weights) == 12
    w1, g1, b1, w2, g2, b2, w3, g3, b3 = weights[:9]
    n, h, w_, cin = x.shape
    t = n // tile_bt
    dt = x.dtype

    def gbn(a, g, b):
        # a: (T, M, C) f32; ghost stats over axis 1
        m = a.mean(dim=1, keepdim=True)
        v = (a * a).mean(dim=1, keepdim=True) - m * m
        xh = (a - m) * torch.rsqrt(v + eps)
        return g * xh + b, m[:, 0], v[:, 0]

    xm = x.reshape(t, tile_bt * h * w_, cin)
    a1 = _mm(xm, w1, dt)
    y1, m1, v1 = gbn(a1, g1, b1)
    h1 = torch.relu(y1).to(dt).reshape(t * tile_bt, h, w_, -1)
    cmid = h1.shape[-1]
    pad = torch.nn.functional.pad(h1, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((t, tile_bt * h * w_, cmid), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            sh = pad[:, dy:dy + h, dx:dx + w_, :].reshape(
                t, tile_bt * h * w_, cmid)
            acc = acc + _mm(sh, w2[dy, dx], dt)
    y2, m2, v2 = gbn(acc, g2, b2)
    h2 = torch.relu(y2).to(dt)
    a3 = _mm(h2, w3, dt)
    y3, m3, v3 = gbn(a3, g3, b3)
    if has_proj:
        wp, gp, bp = weights[9:12]
        r, mp, vp = gbn(_mm(xm, wp, dt), gp, bp)
    else:
        r = xm.float()
        mp = vp = torch.zeros((t, 1), dtype=torch.float32, device=x.device)
    out = torch.relu(y3 + r).to(dt)
    cout = out.shape[-1]
    stats = tuple(s.mean(dim=0) for s in (m1, v1, m2, v2, m3, v3, mp, vp))
    return out.reshape(n, h, w_, cout), stats


def autograd_backward(reference: Callable, x: torch.Tensor, g: torch.Tensor,
                      weights: tuple, **tiles) -> tuple[torch.Tensor, tuple]:
    """(dx, weight gradients) of ``sum(out * g)`` through the plain
    version's autograd: the backward's plain version."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_(True)
        ws = [w.detach().requires_grad_(True) for w in weights]
        out, _ = reference(xs, tuple(ws), **tiles)
        grads = torch.autograd.grad(out, [xs, *ws], g)
    return grads[0], tuple(grads[1:])


# -----------------------------------------------------------------------------
# the CUDA kernels (csrc/fused_block_train.cu), shared with the spatial
# variant: K4 is its single-strip, no-halo case
# -----------------------------------------------------------------------------

_DIMS = ("N", "H", "W", "Cin", "Cmid", "Cout", "bt", "th", "hal", "proj")
_PTRS = ("x", "g", "w1", "w2", "w3", "wp", "g1", "b1", "g2", "b2", "g3",
         "b3", "gp", "bp", "out", "m1", "v1", "m2", "v2", "m3", "v3", "mp",
         "vp", "dx", "dxt", "dxb", "dw1", "dg1", "db1", "dw2", "dg2", "db2",
         "dw3", "dg3", "db3", "dwp", "dgp", "dbp", "workspace", "ghost")


class BlockArgs(ctypes.Structure):
    """``KftpuBlockArgs`` of the CUDA source: every field 8 bytes."""
    _fields_ = ([(d, ctypes.c_int64) for d in _DIMS]
                + [("eps", ctypes.c_double)]
                + [(p, ctypes.c_void_p) for p in _PTRS])


def _library() -> ctypes.CDLL:
    lib = _build.load_library(_KERNEL)
    if lib.kftpu_block_train_fwd.argtypes is None:
        args = ctypes.POINTER(BlockArgs)
        lib.kftpu_block_train_workspace.restype = ctypes.c_int64
        lib.kftpu_block_train_workspace.argtypes = [args, ctypes.c_int]
        for fn in (lib.kftpu_block_train_fwd, lib.kftpu_block_train_bwd):
            fn.restype = ctypes.c_int
            fn.argtypes = [args, ctypes.c_void_p]
    return lib


def _check_inputs(x: torch.Tensor, weights: tuple, tile_bt: int,
                  tile_h: int) -> tuple[int, int, int, bool]:
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}; the kernel takes CUDA tensors")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x dtype {x.dtype}: the kernel takes bfloat16")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x {tuple(x.shape)} must be a contiguous NHWC "
                         f"tensor")
    n, h, w_, cin = x.shape
    has_proj = len(weights) == 12
    cmid, cout = weights[0].shape[-1], weights[6].shape[-1]
    if n % tile_bt or h % tile_h:
        raise ValueError(f"tile ({tile_bt}, {tile_h}) must divide (batch, "
                         f"height) ({n}, {h})")
    if cin % 8 or cmid % 8 or cout % 8:
        raise ValueError(f"channels ({cin}, {cmid}, {cout}) must be "
                         f"multiples of 8")
    shapes = [(cin, cmid), (cmid,), (cmid,), (3, 3, cmid, cmid), (cmid,),
              (cmid,), (cmid, cout), (cout,), (cout,)]
    if has_proj:
        shapes += [(cin, cout), (cout,), (cout,)]
    elif cin != cout:
        raise ValueError(f"Cin {cin} != Cout {cout} needs a projection")
    for i, (wi, sh) in enumerate(zip(weights, shapes)):
        if tuple(wi.shape) != sh or wi.device != x.device:
            raise ValueError(f"weight {i}: {tuple(wi.shape)} on {wi.device}, "
                             f"expected {sh} on {x.device}")
    return cin, cmid, cout, has_proj


def _kernel_weights(weights: tuple) -> list[torch.Tensor]:
    """Conv weights in bf16, BN scale and bias in f32, all contiguous (the
    JAX ``_padded_weights`` casts)."""
    conv = {0, 3, 6, 9}
    return [(w.to(torch.bfloat16) if k in conv else w.float()).contiguous()
            for k, w in enumerate(weights)]


def ghost_numel(n: int, h: int, cmid: int, cout: int, tile_bt: int,
                tile_h: int) -> int:
    """Floats of the saved per-ghost statistics: m1, rs1, m2, rs2 [G,
    Cmid], then m3, rs3, mp, rsp [G, Cout], for the G = (n / tile_bt) x (h
    / tile_h) ghosts, ghost g = t * S + s (mp and rsp are not written
    without a projection)."""
    return (n // tile_bt) * (h // tile_h) * 4 * (cmid + cout)


def launch_block(x: torch.Tensor, weights: tuple, tile_bt: int, tile_h: int,
                 eps: float, g: Optional[torch.Tensor] = None,
                 ghost: Optional[torch.Tensor] = None):
    """One call of the CUDA block on the current stream: the forward
    ``(out, 8 stats, ghost)`` without ``g`` (``ghost`` the per-ghost
    statistics, :func:`ghost_numel`), the backward ``(dx, grads)`` with it
    (grads: 9, or 12 with proj, f32), from the forward's ``ghost`` or, when
    it is None, from statistics it recomputes. ``tile_h == h`` is the
    batch-tiled K4; a smaller ``tile_h`` the spatial K5 with a 1-row
    halo."""
    cin, cmid, cout, has_proj = _check_inputs(x, weights, tile_bt, tile_h)
    n, h, w_, _ = x.shape
    s_count = h // tile_h
    kw = _kernel_weights(weights)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    a = BlockArgs(N=n, H=h, W=w_, Cin=cin, Cmid=cmid, Cout=cout, bt=tile_bt,
                  th=tile_h, hal=int(s_count > 1), proj=int(has_proj),
                  eps=float(eps))
    a.x = x.data_ptr()
    for name, t in zip(("w1", "g1", "b1", "w2", "g2", "b2", "w3", "g3",
                        "b3", "wp", "gp", "bp"), kw):
        setattr(a, name, t.data_ptr())
    lib = _library()
    backward = g is not None
    numel = ghost_numel(n, h, cmid, cout, tile_bt, tile_h)
    if backward:
        if ghost is not None:
            if ghost.shape != (numel,) or ghost.dtype != torch.float32 or \
                    ghost.device != dev or not ghost.is_contiguous():
                raise ValueError(f"ghost {tuple(ghost.shape)} {ghost.dtype} "
                                 f"on {ghost.device} must be contiguous f32 "
                                 f"({numel},) on {dev}")
            a.ghost = ghost.data_ptr()
        if g.shape != (n, h, w_, cout) or g.dtype != x.dtype or \
                g.device != dev or not g.is_contiguous():
            raise ValueError(f"g {tuple(g.shape)} {g.dtype} must be a "
                             f"contiguous bf16 [{n}, {h}, {w_}, {cout}]")
        a.g = g.data_ptr()
        dx = torch.empty_like(x)
        seams = [torch.empty((n, s_count, w_, cin), dtype=x.dtype,
                             device=dev) for _ in range(2)]
        grads = [torch.empty(tuple(w.shape), **f32) for w in kw]
        a.dx, a.dxt, a.dxb = (t.data_ptr() for t in (dx, *seams))
        for name, t in zip(("dw1", "dg1", "db1", "dw2", "dg2", "db2", "dw3",
                            "dg3", "db3", "dwp", "dgp", "dbp"), grads):
            setattr(a, name, t.data_ptr())
    else:
        out = torch.empty((n, h, w_, cout), dtype=x.dtype, device=dev)
        stats = [torch.empty((c,), **f32) for c in
                 (cmid, cmid, cmid, cmid, cout, cout)]
        stats += [torch.empty((cout,), **f32) if has_proj else
                  torch.zeros((1,), **f32) for _ in range(2)]
        ghost = torch.empty((numel,), **f32)
        a.out, a.ghost = out.data_ptr(), ghost.data_ptr()
        for name, t in zip(("m1", "v1", "m2", "v2", "m3", "v3", "mp", "vp"),
                           stats if has_proj else stats[:6]):
            setattr(a, name, t.data_ptr())
    nbytes = lib.kftpu_block_train_workspace(ctypes.byref(a), int(backward))
    ws = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    a.workspace = ws.data_ptr()
    launcher = lib.kftpu_block_train_bwd if backward else \
        lib.kftpu_block_train_fwd
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launcher(ctypes.byref(a), stream)
    _build.check(lib, err, "fused_block_train " +
                 ("backward" if backward else "forward"))
    if backward:
        return dx, tuple(grads if has_proj else grads[:9])
    return out, tuple(stats), ghost


# -----------------------------------------------------------------------------
# dispatch: the kernel for CUDA tensors, the plain version for CPU tensors
# -----------------------------------------------------------------------------

def fused_block_train_fwd(x: torch.Tensor, weights: tuple, tile_bt: int,
                          eps: float = 1e-5) -> tuple:
    """The block's forward: (out, 8 tile-averaged statistics, the per-ghost
    statistics the backward takes). The plain version gives None for the
    last: its autograd backward recomputes them."""
    if x.device.type == "cpu":
        return (*reference_bottleneck_train(x, weights, tile_bt=tile_bt,
                                            eps=eps), None)
    res = launch_block(x, weights, tile_bt, x.shape[1], eps)
    fused_block_train_fwd.launches += 1
    return res


def fused_block_train_bwd(x: torch.Tensor, g: torch.Tensor, weights: tuple,
                          tile_bt: int, eps: float = 1e-5,
                          ghost: Optional[torch.Tensor] = None
                          ) -> tuple[torch.Tensor, tuple]:
    """The block's backward: (dx, f32 weight gradients) from x, the
    output's gradient g, the weights and the forward's per-ghost
    statistics (recomputed when ``ghost`` is None)."""
    if x.device.type == "cpu":
        return autograd_backward(reference_bottleneck_train, x, g, weights,
                                 tile_bt=tile_bt, eps=eps)
    res = launch_block(x, weights, tile_bt, x.shape[1], eps, g=g,
                       ghost=ghost)
    fused_block_train_bwd.launches += 1
    return res


fused_block_train_fwd.launches = 0
fused_block_train_bwd.launches = 0


class FusedBlock(torch.autograd.Function):
    """``(out, *stats) = fwd(x, weights, *tiles, eps)`` with ``bwd`` as
    its backward, which takes the forward's per-ghost statistics. The
    statistics carry no gradient: they feed the running-stat EMA only,
    which is stop-gradient in flax's BatchNorm as well."""

    @staticmethod
    def forward(ctx, fwd, bwd, tiles, eps, x, *weights):
        out, stats, ghost = fwd(x, weights, *tiles, eps)
        ctx.save_for_backward(x, *weights)
        ctx.bwd, ctx.tiles, ctx.eps, ctx.ghost = bwd, tiles, eps, ghost
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, g_out, *g_stats):
        x, *weights = ctx.saved_tensors
        dx, grads = ctx.bwd(x, g_out.to(x.dtype).contiguous(), tuple(weights),
                            *ctx.tiles, ctx.eps, ghost=ctx.ghost)
        return (None, None, None, None, dx,
                *(gi.to(wi.dtype) for gi, wi in zip(grads, weights)))


def fused_bottleneck_train(x: torch.Tensor, params: dict, *,
                           tile_bt: Optional[int] = None,
                           eps: float = 1e-5) -> tuple[torch.Tensor, dict]:
    """The fused ghost-BN training block: (out, ghost stats by name).

    ``params`` is one BottleneckBlock's params (dotted names relative to
    the block); stride-1 blocks only (callers route strided blocks to
    plain ops). The stats hold the tile-averaged batch moments per
    BatchNorm, named for the running EMA update."""
    weights = block_weights(params)
    has_proj = len(weights) == 12
    n, h, w_, cin = x.shape
    cmid = weights[0].shape[-1]
    cout = weights[6].shape[-1]
    if not has_proj and cin != cout:
        raise ValueError(f"Cin {cin} != Cout {cout} needs a projection")
    if tile_bt is None:
        tile_bt = default_tile_bt(n, h, w_, cin, cmid, cout)
    elif n % tile_bt:
        raise ValueError(f"tile_bt {tile_bt} must divide batch {n}")
    out, *stats = FusedBlock.apply(fused_block_train_fwd,
                                   fused_block_train_bwd, (tile_bt,), eps,
                                   x, *weights)
    return out, stats_to_tree(tuple(stats), has_proj)
