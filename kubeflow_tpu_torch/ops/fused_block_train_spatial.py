"""Spatially-tiled fused ResNet bottleneck, training mode (K5): ghost-BN
over (batch tile × row strip) tiles with a 1-row halo.

The counterpart of ``kubeflow_tpu/ops/fused_block_train_spatial.py``, the
variant that takes the stride-1 blocks whose one-image working set busts
the batch-tiled kernel's budget (ResNet-50's 56² and 28² stages at 224
px). The image's H rows split into strips of ``tile_h`` rows; each ghost
is (``tile_bt`` images × one strip), and the 3x3 conv reads one halo row
above and below from the neighbouring strips, so it is exact at strip
seams; rows outside the image are zero (SAME padding).

**Ghost-BN semantics (per batch × strip ghost):** statistics are taken
over the strip's interior samples (tile_bt·tile_h·W per channel); halo
rows are normalised with those interior statistics (they only feed the
3x3). In the backward, halo samples contribute to dγ/dβ and to the
statistic-correction sums, but the divisor is the interior count and the
correction applies to interior rows only — the autograd gradient of
:func:`reference_bottleneck_train_spatial`, which is the tested definition
of the semantics. Seam-row gradients come back as thin ``[N, S, W, Cin]``
arrays, rounded to the input dtype, that are added into dx in that dtype.

- :func:`fused_bottleneck_train_spatial` is the public block. A CUDA
  tensor runs the kernels of ``csrc/fused_block_train.cu`` (the batch-tiled
  K4 is their single-strip case) or raises; a CPU tensor runs the plain
  version and its autograd gradients.
- ``fused_block_train_spatial_fwd.launches`` and
  ``fused_block_train_spatial_bwd.launches`` count kernel calls, one a
  block a direction.
- ``default_tile_h`` and the budget are the JAX package's, verbatim: the
  strip height defines the ghost batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from .fused_block_train import (VMEM_BUDGET_BYTES, FusedBlock, _mm,
                                _per_image_bytes, autograd_backward,
                                block_weights, launch_block,
                                stats_to_tree)

__all__ = ["fused_bottleneck_train_spatial",
           "reference_bottleneck_train_spatial", "default_tile_h",
           "fits_vmem_budget_spatial", "make_strips", "backward_plain",
           "ghost_stats_plain", "fused_block_train_spatial_fwd",
           "fused_block_train_spatial_bwd"]


def _strip_bytes(tile_h: int, w: int, cin: int, cmid: int,
                 cout: int) -> int:
    """Working-set estimate per image for one haloed strip."""
    return _per_image_bytes(tile_h + 2, w, cin, cmid, cout)


def fits_vmem_budget_spatial(tile_h: int, w: int, cin: int, cmid: int,
                             cout: int) -> bool:
    return _strip_bytes(tile_h, w, cin, cmid, cout) <= VMEM_BUDGET_BYTES


def default_tile_h(h: int, w: int, cin: int, cmid: int,
                   cout: int) -> Optional[int]:
    """Largest strip height dividing h whose haloed working set fits the
    budget at tile_bt=1; None when even a 1-row strip cannot fit."""
    for th in range(h, 0, -1):
        if h % th == 0 and fits_vmem_budget_spatial(th, w, cin, cmid,
                                                    cout):
            return th
    return None


# -----------------------------------------------------------------------------
# the plain version (differentiable)
# -----------------------------------------------------------------------------

def make_strips(x: torch.Tensor, tile_h: int) -> torch.Tensor:
    """(n, h, w, c) -> (S, n, tile_h+2, w, c) haloed row strips; the halo
    is the neighbour strip's edge row, zeros at image edges."""
    n, h, w, c = x.shape
    s_count = h // tile_h
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
    return torch.stack([xp[:, s * tile_h:s * tile_h + tile_h + 2]
                        for s in range(s_count)])


def _edge_mask(bt: int, th2: int, w: int, is_top: bool,
               is_bottom: bool, device=None) -> torch.Tensor:
    """1 everywhere except image-edge halo rows (SAME-conv zero padding of
    h1: a BN with bias would otherwise turn the zero input rows into
    nonzero h1 padding). Shape (bt, th2, w, 1)."""
    rows = torch.arange(th2, device=device).view(1, th2, 1, 1).expand(
        bt, th2, w, 1)
    top = (rows == 0) & is_top
    bot = (rows == th2 - 1) & is_bottom
    return 1.0 - (top | bot).float()


def _strip_forward(xt: torch.Tensor, weights: tuple, eps: float,
                   is_top: bool, is_bottom: bool):
    """The (T, tile_bt, tile_h+2, w, cin) haloed strips of one strip row
    through the block, one ghost per leading index. Returns (out (T,
    tile_bt, tile_h, w, cout), stats tuple of (T, C) moments)."""
    has_proj = len(weights) == 12
    w1, g1, b1, w2, g2, b2, w3, g3, b3 = weights[:9]
    dt = xt.dtype
    t, bt, th2, w_, cin = xt.shape
    th = th2 - 2
    cmid = w1.shape[-1]

    def moments(a):          # (T, M, C) -> (T, 1, C) mean and var
        m = a.mean(dim=1, keepdim=True)
        return m, (a * a).mean(dim=1, keepdim=True) - m * m

    def norm(a, m, v, g, b):
        return g * ((a - m) * torch.rsqrt(v + eps)) + b

    xm = xt.reshape(t, -1, cin)
    a1 = _mm(xm, w1, dt)
    a1i = a1.reshape(t, bt, th2, w_, cmid)[:, :, 1:th + 1].reshape(
        t, -1, cmid)
    m1, v1 = moments(a1i)
    h1 = torch.relu(norm(a1, m1, v1, g1, b1)).to(dt).reshape(
        t, bt, th2, w_, cmid)
    h1 = (h1 * _edge_mask(bt, th2, w_, is_top, is_bottom, xt.device)
          ).to(dt)
    pad = torch.nn.functional.pad(h1, (0, 0, 1, 1))
    acc = torch.zeros((t, bt * th * w_, cmid), dtype=torch.float32,
                      device=xt.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + _mm(pad[:, :, dy:dy + th, dx:dx + w_, :].reshape(
                t, -1, cmid), w2[dy, dx], dt)
    m2, v2 = moments(acc)
    h2 = torch.relu(norm(acc, m2, v2, g2, b2)).to(dt)
    a3 = _mm(h2, w3, dt)
    m3, v3 = moments(a3)
    y3 = norm(a3, m3, v3, g3, b3)

    xi = xt[:, :, 1:th + 1].reshape(t, -1, cin)
    if has_proj:
        wp, gp, bp = weights[9:12]
        ap = _mm(xi, wp, dt)
        mp, vp = moments(ap)
        r = norm(ap, mp, vp, gp, bp)
        mp, vp = mp[:, 0], vp[:, 0]
    else:
        r = xi.float()
        mp = vp = torch.zeros((t, 1), dtype=torch.float32, device=xt.device)
    out = torch.relu(y3 + r).to(dt).reshape(t, bt, th, w_, -1)
    stats = tuple(s[:, 0] for s in (m1, v1, m2, v2, m3, v3)) + (mp, vp)
    return out, stats


def reference_bottleneck_train_spatial(x: torch.Tensor, weights: tuple, *,
                                       tile_bt: int, tile_h: int,
                                       eps: float = 1e-5):
    """Ghost-BN bottleneck forward tiled like the spatial kernel grid
    ((n // tile_bt) x (h // tile_h) ghosts), in plain PyTorch.
    Differentiable: its autograd gradients are the golden gradients for
    the backward kernel."""
    n, h, w_, cin = x.shape
    t_count, s_count = n // tile_bt, h // tile_h
    xs = make_strips(x, tile_h)
    out_rows = []
    stats = None
    for s in range(s_count):
        xt = xs[s].reshape(t_count, tile_bt, tile_h + 2, w_, cin)
        o, st = _strip_forward(xt, weights, eps, is_top=(s == 0),
                               is_bottom=(s == s_count - 1))
        out_rows.append(o.reshape(n, tile_h, w_, -1))
        st = tuple(v.sum(dim=0) for v in st)
        stats = st if stats is None else \
            tuple(a + b for a, b in zip(stats, st))
    out = torch.cat(out_rows, dim=1)
    inv = 1.0 / (t_count * s_count)
    return out, tuple(s * inv for s in stats)


def backward_plain(x: torch.Tensor, g: torch.Tensor, weights: tuple, *,
                   tile_bt: int, tile_h: int, eps: float = 1e-5
                   ) -> tuple[torch.Tensor, tuple]:
    """The backward kernels' own formula in plain PyTorch, for K5 and for
    K4 (``tile_h == h``): the interior recomputed from x, ``da1``,
    ``da2``, ``da3`` and ``dap`` rounded to x's dtype before their
    products, ``dh1``, ``dh2`` and ``dx`` accumulated in f32, the halo
    rows of BN1 in its sums but not in its correction, seam rows added
    into the rounded dx in x's dtype, top seams first (the JAX
    ``_bwd_kernel``s and ``_pallas_bwd``). Returns (dx, f32 weight
    gradients). It rounds where the kernels round, so it holds them to a
    closer bar than the autograd gradients of the plain forward can."""
    return _backward_plain(x, g, weights, tile_bt, tile_h, eps)


def ghost_stats_plain(x: torch.Tensor, weights: tuple, *, tile_bt: int,
                      tile_h: int, eps: float = 1e-5) -> torch.Tensor:
    """The per-ghost statistics the forward kernel saves for the backward,
    in plain PyTorch: f32 m1, rs1, m2, rs2 [G, Cmid] then m3, rs3, mp, rsp
    [G, Cout] flattened, ghost g = t * S + s (mp and rsp zero without a
    projection); rs = rsqrt(var + eps)."""
    return _backward_plain(x, None, weights, tile_bt, tile_h, eps)


def _backward_plain(x, g, weights, tile_bt, tile_h, eps):
    """backward_plain, or with ``g`` None the statistics it uses."""
    has_proj = len(weights) == 12
    w1, g1, b1, w2, g2, b2, w3, g3, b3 = weights[:9]
    n, h, w_, cin = x.shape
    dt = x.dtype
    t_count, s_count = n // tile_bt, h // tile_h
    th, hal = tile_h, int(s_count > 1)
    th2 = th + 2 * hal
    ghosts = (t_count, s_count, tile_bt)
    red = (2, 3, 4)                      # a ghost's (bt, rows, w) axes
    count = tile_bt * th * w_

    def mm(a, wt):
        return torch.matmul(a.float(), wt.to(dt).float())

    def to_ghosts(a, rows):              # (n, S·rows, w, c) -> (T, S, bt,..)
        return a.reshape(t_count, tile_bt, s_count, rows, w_, -1) \
            .permute(0, 2, 1, 3, 4, 5)

    def from_ghosts(a):                  # (T, S, bt, rows, w, c) -> (n, ..)
        return a.permute(0, 2, 1, 3, 4, 5).reshape(n, -1, w_, a.shape[-1])

    def moments(a):
        m = a.mean(dim=red, keepdim=True)
        return m, torch.rsqrt((a * a).mean(dim=red, keepdim=True) - m * m
                              + eps)

    def csum(a):                         # over every axis but channels
        return a.reshape(-1, a.shape[-1]).sum(dim=0)

    def wsum(a, b):                      # sum over samples of a^T b
        return torch.matmul(a.reshape(-1, a.shape[-1]).float().T,
                            b.reshape(-1, b.shape[-1]).float())

    def bn_bwd(dy, xh, gam, s):
        dxh = dy * gam
        da = s * (dxh - dxh.sum(dim=red, keepdim=True) / count
                  - xh * ((dxh * xh).sum(dim=red, keepdim=True) / count))
        return da.to(dt), csum(dy * xh), csum(dy)

    # haloed strips: the neighbours' edge rows, clamped at the image edge
    rows = torch.arange(th2, device=x.device) + \
        (torch.arange(s_count, device=x.device) * th - hal)[:, None]
    inside = ((rows >= 0) & (rows < h)).float()[None, :, None, :, None,
                                                 None]
    xs = to_ghosts(x[:, rows.clamp(0, h - 1).reshape(-1)], th2)
    interior = slice(hal, hal + th)
    a1 = mm(xs, w1)
    m1, s1 = moments(a1[:, :, :, interior])
    xh1 = (a1 - m1) * s1
    y1 = g1 * xh1 + b1
    h1 = (torch.relu(y1) * inside).to(dt)
    h1p = torch.nn.functional.pad(h1, (0, 0, 1, 1, 1 - hal, 1 - hal))
    taps = [(dy, dx) for dy in range(3) for dx in range(3)]
    acc2 = sum(mm(h1p[:, :, :, dy:dy + th, dx:dx + w_], w2[dy, dx])
               for dy, dx in taps)
    m2, s2 = moments(acc2)
    xh2 = (acc2 - m2) * s2
    y2 = g2 * xh2 + b2
    h2 = torch.relu(y2).to(dt)
    a3 = mm(h2, w3)
    m3, s3 = moments(a3)
    xh3 = (a3 - m3) * s3
    xi = xs[:, :, :, interior]
    if has_proj:
        wp, gp, bp = weights[9:12]
        ap = mm(xi, wp)
        mp, sp = moments(ap)
        xhp = (ap - mp) * sp
        r = gp * xhp + bp
    else:
        r = xi.float()
        mp = sp = torch.zeros_like(m3)
    if g is None:
        return torch.cat([v.reshape(-1) for v in
                          (m1, s1, m2, s2, m3, s3, mp, sp)])

    gz = torch.where(g3 * xh3 + b3 + r > 0, to_ghosts(g, th).float(), 0.0)
    da3, dg3, db3 = bn_bwd(gz, xh3, g3, s3)
    dw3 = wsum(h2, da3)
    dh2 = mm(da3, w3.T)
    da2, dg2, db2 = bn_bwd(torch.where(y2 > 0, dh2, 0.0), xh2, g2, s2)
    dw2 = torch.stack([wsum(h1p[:, :, :, dy:dy + th, dx:dx + w_], da2)
                       for dy, dx in taps]).reshape(3, 3, *w2.shape[2:])
    da2p = torch.nn.functional.pad(da2, (0, 0, 1, 1, 1 + hal, 1 + hal))
    dh1 = sum(mm(da2p[:, :, :, 2 - dy:2 - dy + th2, 2 - dx:2 - dx + w_],
                 w2[dy, dx].T) for dy, dx in taps)
    dz1 = torch.where(y1 > 0, dh1 * inside, 0.0)
    dxh1 = dz1 * g1
    corr = dxh1.sum(dim=red, keepdim=True) / count + \
        xh1 * ((dxh1 * xh1).sum(dim=red, keepdim=True) / count)
    imask = torch.zeros(th2, device=x.device)
    imask[interior] = 1.0
    da1 = (s1 * (dxh1 - imask[:, None, None] * corr)).to(dt)
    grads = [wsum(xs, da1), csum(dz1 * xh1), csum(dz1), dw2, dg2, db2,
             dw3, dg3, db3]
    dxh = mm(da1, w1.T)
    if has_proj:
        dap, dgp, dbp = bn_bwd(gz, xhp, gp, sp)
        grads += [wsum(xi, dap), dgp, dbp]
        dres = mm(dap, wp.T)
    else:
        dres = gz
    dxh[:, :, :, interior] += dres
    dxh = dxh.to(dt)
    dx = from_ghosts(dxh[:, :, :, interior])
    if s_count > 1:
        # strip s's top halo is row s·th − 1 (s ≥ 1), its bottom halo row
        # (s + 1)·th (s ≤ S − 2); the image-edge ones are zero
        top = from_ghosts(dxh[:, 1:, :, :1])
        dx[:, th - 1:h - 1:th] = (dx[:, th - 1:h - 1:th].float()
                                  + top.float()).to(dt)
        bot = from_ghosts(dxh[:, :-1, :, th2 - 1:])
        dx[:, th:h:th] = (dx[:, th:h:th].float() + bot.float()).to(dt)
    return dx, tuple(grads)


# -----------------------------------------------------------------------------
# dispatch: the kernel for CUDA tensors, the plain version for CPU tensors
# -----------------------------------------------------------------------------

def fused_block_train_spatial_fwd(x: torch.Tensor, weights: tuple,
                                  tile_bt: int, tile_h: int,
                                  eps: float = 1e-5):
    """The spatial block's forward: (out, 8 ghost-averaged statistics, the
    per-ghost statistics the backward takes; None from the plain
    version, whose autograd backward recomputes them)."""
    if x.device.type == "cpu":
        return (*reference_bottleneck_train_spatial(
            x, weights, tile_bt=tile_bt, tile_h=tile_h, eps=eps), None)
    res = launch_block(x, weights, tile_bt, tile_h, eps)
    fused_block_train_spatial_fwd.launches += 1
    return res


def fused_block_train_spatial_bwd(x: torch.Tensor, g: torch.Tensor,
                                  weights: tuple, tile_bt: int, tile_h: int,
                                  eps: float = 1e-5,
                                  ghost: Optional[torch.Tensor] = None):
    """The spatial block's backward: (dx, f32 weight gradients), from the
    forward's per-ghost statistics (recomputed when ``ghost`` is None)."""
    if x.device.type == "cpu":
        return autograd_backward(reference_bottleneck_train_spatial, x, g,
                                 weights, tile_bt=tile_bt, tile_h=tile_h,
                                 eps=eps)
    res = launch_block(x, weights, tile_bt, tile_h, eps, g=g, ghost=ghost)
    fused_block_train_spatial_bwd.launches += 1
    return res


fused_block_train_spatial_fwd.launches = 0
fused_block_train_spatial_bwd.launches = 0


def fused_bottleneck_train_spatial(x: torch.Tensor, params: dict, *,
                                   tile_bt: int = 1,
                                   tile_h: Optional[int] = None,
                                   eps: float = 1e-5
                                   ) -> tuple[torch.Tensor, dict]:
    """The spatially-tiled fused ghost-BN training block:
    (out, ghost stats by name). Stride-1 blocks only."""
    weights = block_weights(params)
    has_proj = len(weights) == 12
    n, h, w_, cin = x.shape
    cmid = weights[0].shape[-1]
    cout = weights[6].shape[-1]
    if not has_proj and cin != cout:
        raise ValueError(f"Cin {cin} != Cout {cout} needs a projection")
    if n % tile_bt:
        raise ValueError(f"tile_bt {tile_bt} must divide batch {n}")
    if tile_h is None:
        tile_h = default_tile_h(h, w_, cin, cmid, cout)
        if tile_h is None:
            raise ValueError("no strip height fits the VMEM budget")
    elif h % tile_h:
        raise ValueError(f"tile_h {tile_h} must divide height {h}")
    out, *stats = FusedBlock.apply(
        fused_block_train_spatial_fwd, fused_block_train_spatial_bwd,
        (tile_bt, tile_h), eps, x, *weights)
    return out, stats_to_tree(tuple(stats), has_proj)
