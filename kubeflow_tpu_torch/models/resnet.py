"""ResNet, the port of ``kubeflow_tpu/models/resnet.py``: the exact-BN
default path and the fused ghost-BN training path.

Parameters keep the shapes flax gives them and are named by their flax
path joined with dots, as the LM's are (models/transformer.py): conv
kernels HWIO (``stage1_block1.Conv_0.kernel`` [1, 1, 64, 64]), BatchNorm
``scale``/``bias`` [C], the head ``head.kernel`` [C, classes] and
``head.bias``. ``variables["batch_stats"]`` uses the same names
(``stage1_block1.BatchNorm_0.mean`` / ``.var``). Tensors are NHWC.

**Default path** (:class:`ResNet`, the flax module's ``apply``): convs run
through ``F.conv2d`` with the kernel permuted at call time and flax's
``padding="SAME"`` applied explicitly (``before = total // 2``, so a 7x7/s2
conv on an even size pads (2, 3), not torch's symmetric 3); the max-pool
pads with −inf. BatchNorm follows ``flax.linen.BatchNorm``: statistics in
f32 as E[x²] − E[x]² clamped at 0, the biased variance into the running
average ``0.9·ra + 0.1·batch``, and ``(x − m)·(rsqrt(v + eps)·scale) +
bias`` cast to the compute dtype. The global mean-pool runs on the
compute dtype and rounds to it; the head is f32.

**Fused path** (:func:`fused_train_apply`, ``--fused-blocks``): every
stride-1 bottleneck runs as one ghost-BN block through the hand-written
CUDA kernels (ops/fused_block_train.py K4, ops/fused_block_train_spatial.py
K5), routed by :func:`_fused_route` — the JAX package's VMEM model, kept
verbatim because the tile it picks defines the ghost batch. The stem, the
strided blocks (:func:`_xla_block_train`) and the head stay PyTorch ops,
as the JAX package leaves them to XLA; the global pool runs in f32.
Running statistics are EMA-updated from the tile-averaged ghost moments.

**Fused inference path** (:func:`fused_eval_apply`): the eval forward with
every BatchNorm folded to an affine and every stride-1 bottleneck as one
call of the hand-written CUDA kernel K6 (ops/fused_block.py); the stem, the
strided blocks (:func:`_xla_block_eval`) and the head stay PyTorch ops. It
computes what ``ResNet.apply(train=False)`` computes, rounded at other
places; the servables serve ``apply``, as the JAX package's do.

**Data parallel** (a ``parallel/mesh.py`` mesh with more than one
replica; each rank runs its rows of the global batch): the default path's
BatchNorm takes its statistics over the global batch, as pjit computes
them, through ``parallel/collectives.py`` ``global_sum`` (the sums of x
and x² all-reduced in the forward, the two gradient sums in the
backward), still flax's f32 E[x²] − E[x]² clamped at 0. The fused path
keeps each rank's statistics its own (the ghost tiles, the stem and the
strided blocks over the rank's rows: the JAX package's ``shard_map``
semantics) and all-reduces the batch moments to their mean before the
running-stat EMA, as its ``pmean`` does.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops import fused_block as _fb
from ..ops import fused_block_train as _fbt
from ..ops import fused_block_train_spatial as _fbts
from ..parallel import collectives
from ..parallel.mesh import replica_degree
from . import RESNET_DEPTHS

STAGE_SIZES = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}
assert set(STAGE_SIZES) == set(RESNET_DEPTHS)

BN_EPS = 1e-5
_BN_MOMENTUM = 0.9  # flax's momentum: ra = 0.9·ra + 0.1·batch


# -----------------------------------------------------------------------------
# flax's SAME padding and ops in NHWC
# -----------------------------------------------------------------------------

def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """flax/lax SAME: out = ceil(size / s), total pad split low-first."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, kernel: torch.Tensor, stride: int,
         dtype: torch.dtype) -> torch.Tensor:
    """``lax.conv_general_dilated(x, kernel, stride, "SAME")`` for NHWC x
    and an HWIO kernel, in ``dtype`` (f32 accumulation)."""
    kh, kw = kernel.shape[:2]
    ph = _same_pads(x.shape[1], kh, stride)
    pw = _same_pads(x.shape[2], kw, stride)
    xc = x.to(dtype).permute(0, 3, 1, 2)
    if any(ph + pw):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, kernel.to(dtype).permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: −inf padding."""
    ph = _same_pads(x.shape[1], k, s)
    pw = _same_pads(x.shape[2], k, s)
    xc = x.permute(0, 3, 1, 2)
    if any(ph + pw):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(xc, k, s).permute(0, 2, 3, 1)


@dataclass
class _Run:
    """One apply: the params and running stats it reads, train or eval,
    and the updated running stats it collects."""
    params: dict
    stats: dict
    train: bool
    dtype: torch.dtype
    group: object = None       # the replicas' process group, or None
    updated: dict = field(default_factory=dict)

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` on NHWC x; with
        a group, its statistics over the global batch."""
        if self.train:
            xf = x.float()
            if self.group is None:
                mean = xf.mean(dim=(0, 1, 2))
                ex2 = (xf * xf).mean(dim=(0, 1, 2))
            else:
                n = xf[..., 0].numel() * \
                    dist.get_world_size(self.group)
                sums = collectives.global_sum(torch.stack(
                    [xf.sum(dim=(0, 1, 2)), (xf * xf).sum(dim=(0, 1, 2))]),
                    self.group)
                mean, ex2 = sums[0] / n, sums[1] / n
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            for key, v in (("mean", mean), ("var", var)):
                ra = self.stats[f"{name}.{key}"]
                self.updated[f"{name}.{key}"] = (
                    _BN_MOMENTUM * ra + (1.0 - _BN_MOMENTUM) * v).detach()
        else:
            mean, var = self.stats[f"{name}.mean"], self.stats[f"{name}.var"]
        mul = torch.rsqrt(var + BN_EPS) * self.params[f"{name}.scale"]
        y = (x.float() - mean) * mul + self.params[f"{name}.bias"]
        return y.to(self.dtype)

    def conv(self, name: str, x: torch.Tensor, stride: int = 1
             ) -> torch.Tensor:
        return conv(x, self.params[f"{name}.kernel"], stride, self.dtype)


@dataclass(frozen=True)
class BottleneckBlock:
    filters: int
    strides: int
    name: str

    def __call__(self, run: _Run, x: torch.Tensor) -> torch.Tensor:
        p = self.name
        residual = x
        y = torch.relu(run.bn(f"{p}.BatchNorm_0", run.conv(f"{p}.Conv_0", x)))
        y = torch.relu(run.bn(f"{p}.BatchNorm_1",
                              run.conv(f"{p}.Conv_1", y, self.strides)))
        y = run.bn(f"{p}.BatchNorm_2", run.conv(f"{p}.Conv_2", y))
        if residual.shape != y.shape:
            residual = run.bn(f"{p}.norm_proj", run.conv(
                f"{p}.conv_proj", residual, self.strides))
        return torch.relu(residual + y)

    def shapes(self, cin: int) -> tuple[dict, dict]:
        """(param name → kernel shape, BatchNorm name → channels)."""
        f, p = self.filters, self.name
        s = {f"{p}.Conv_0.kernel": (1, 1, cin, f),
             f"{p}.Conv_1.kernel": (3, 3, f, f),
             f"{p}.Conv_2.kernel": (1, 1, f, 4 * f)}
        norms = {"BatchNorm_0": f, "BatchNorm_1": f, "BatchNorm_2": 4 * f}
        if cin != 4 * f or self.strides != 1:
            s[f"{p}.conv_proj.kernel"] = (1, 1, cin, 4 * f)
            norms["norm_proj"] = 4 * f
        return s, {f"{p}.{n}": c for n, c in norms.items()}


@dataclass(frozen=True)
class BasicBlock:
    filters: int
    strides: int
    name: str

    def __call__(self, run: _Run, x: torch.Tensor) -> torch.Tensor:
        p = self.name
        residual = x
        y = torch.relu(run.bn(f"{p}.BatchNorm_0",
                              run.conv(f"{p}.Conv_0", x, self.strides)))
        y = run.bn(f"{p}.BatchNorm_1", run.conv(f"{p}.Conv_1", y))
        if residual.shape != y.shape:
            residual = run.bn(f"{p}.norm_proj", run.conv(
                f"{p}.conv_proj", residual, self.strides))
        return torch.relu(residual + y)

    def shapes(self, cin: int) -> tuple[dict, dict]:
        f, p = self.filters, self.name
        s = {f"{p}.Conv_0.kernel": (3, 3, cin, f),
             f"{p}.Conv_1.kernel": (3, 3, f, f)}
        norms = {"BatchNorm_0": f, "BatchNorm_1": f}
        if cin != f or self.strides != 1:
            s[f"{p}.conv_proj.kernel"] = (1, 1, cin, f)
            norms["norm_proj"] = f
        return s, {f"{p}.{n}": c for n, c in norms.items()}


# the BatchNorm whose scale flax initialises to zero, per block kind
_ZERO_SCALE = {BottleneckBlock: "BatchNorm_2", BasicBlock: "BatchNorm_1"}


@dataclass(frozen=True)
class ResNet:
    num_classes: int = 1000
    depth: int = 50
    width: int = 64
    dtype: torch.dtype = torch.bfloat16

    def blocks(self) -> list:
        kind = BottleneckBlock if self.depth >= 50 else BasicBlock
        return [kind(self.width * 2 ** i, 2 if i > 0 and j == 0 else 1,
                     f"stage{i + 1}_block{j + 1}")
                for i, n_blocks in enumerate(STAGE_SIZES[self.depth])
                for j in range(n_blocks)]

    def apply(self, params: dict, batch_stats: dict, x: torch.Tensor,
              train: bool = True, group=None):
        """Logits [B, classes] f32; in train mode also the updated running
        statistics (detached), as flax's ``mutable=["batch_stats"]``.
        ``group``: the replicas' process group, whose ranks' rows make the
        global batch the statistics are taken over."""
        run = _Run(params, batch_stats, train, self.dtype, group)
        x = x.to(self.dtype)
        x = torch.relu(run.bn("bn_init", run.conv("conv_init", x, 2)))
        x = max_pool_same(x)
        for block in self.blocks():
            x = block(run, x)
        x = x.float().mean(dim=(1, 2)).to(self.dtype)
        logits = x.float() @ params["head.kernel"] + params["head.bias"]
        return (logits, run.updated) if train else logits

    def shapes(self) -> tuple[dict, dict]:
        """(param name → shape, BatchNorm name → channels)."""
        params = {"conv_init.kernel": (7, 7, 3, self.width)}
        norms = {"bn_init": self.width}
        cin = self.width
        for block in self.blocks():
            p, n = block.shapes(cin)
            params.update(p)
            norms.update(n)
            cin = block.filters * (4 if isinstance(block, BottleneckBlock)
                                   else 1)
        for name, c in norms.items():
            params[f"{name}.scale"] = (c,)
            params[f"{name}.bias"] = (c,)
        params["head.kernel"] = (cin, self.num_classes)
        params["head.bias"] = (self.num_classes,)
        return params, norms

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> tuple[dict, dict]:
        """Random weights from ``generator``, of the kinds flax's
        initialisers draw (truncated lecun-normal conv and dense kernels,
        unit BN scales with the last BN of each block at zero, zero biases,
        running mean 0 and var 1), not the same bits. Returns (params,
        {"batch_stats": ...}) as f32 CPU tensors."""
        shapes, norms = self.shapes()
        zero = {f"{b.name}.{_ZERO_SCALE[type(b)]}.scale"
                for b in self.blocks()}
        params = {}
        for name, shape in shapes.items():
            if name.endswith("kernel"):
                params[name] = _truncated_normal(shape, 1.0, generator)
            elif name.endswith("scale") and name not in zero:
                params[name] = torch.ones(shape)
            else:
                params[name] = torch.zeros(shape)
        stats = {}
        for name, c in norms.items():
            stats[f"{name}.mean"] = torch.zeros(c)
            stats[f"{name}.var"] = torch.ones(c)
        return params, {"batch_stats": stats}


def _truncated_normal(shape, scale: float, generator) -> torch.Tensor:
    """flax variance_scaling(scale, "fan_in", "truncated_normal"): lecun
    normal at scale 1, He at 2."""
    fan_in = math.prod(shape[:-1])
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                generator=generator)
    return t


def make_resnet(depth: int, num_classes: int = 1000, **kw) -> ResNet:
    """The tf_cnn_benchmarks --model family: resnet{18,34,50,101,152}
    (BasicBlock below depth 50, bottleneck at and above)."""
    if depth not in STAGE_SIZES:
        raise ValueError(f"unsupported ResNet depth {depth}; "
                         f"one of {sorted(STAGE_SIZES)}")
    return ResNet(num_classes=num_classes, depth=depth, **kw)


def resnet18(num_classes: int = 1000, **kw) -> ResNet:
    return make_resnet(18, num_classes, **kw)


def resnet34(num_classes: int = 1000, **kw) -> ResNet:
    return make_resnet(34, num_classes, **kw)


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    return make_resnet(50, num_classes, **kw)


def resnet101(num_classes: int = 1000, **kw) -> ResNet:
    return make_resnet(101, num_classes, **kw)


def resnet152(num_classes: int = 1000, **kw) -> ResNet:
    return make_resnet(152, num_classes, **kw)


# -----------------------------------------------------------------------------
# loss, eval, init, data
# -----------------------------------------------------------------------------

def per_row_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    n = logits.shape[-1]
    onehot = F.one_hot(labels.long(), n).to(logits.dtype)
    if label_smoothing:
        # the tf_cnn_benchmarks/ResNet recipe regularizer
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / n
    return -(onehot * F.log_softmax(logits, dim=-1)).sum(dim=-1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    return per_row_cross_entropy(logits, labels, label_smoothing).mean()


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels.long()).float().mean()


def replica_group(mesh):
    """The process group of ``mesh``'s replicas, or None for one
    replica (no mesh)."""
    return None if mesh is None or replica_degree(mesh) <= 1 \
        else mesh.group


def make_loss_fn(model: ResNet, label_smoothing: float = 0.0,
                 mesh=None) -> Callable:
    """Loss fn in the TrainStepBuilder signature; threads batch_stats.
    Over a mesh, BatchNorm takes the global batch's statistics."""
    group = replica_group(mesh)

    def loss_fn(params, variables, batch, rng):
        images, labels = batch["images"], batch["labels"]
        logits, updated = model.apply(params, variables["batch_stats"],
                                      images, train=True, group=group)
        loss = cross_entropy_loss(logits, labels, label_smoothing)
        return loss, {"accuracy": _accuracy(logits, labels),
                      "variables": {"batch_stats": updated}}

    return loss_fn


def make_eval_fn(model: ResNet) -> Callable:
    """Eval pass: running-stats forward (train=False), top-1/top-5. An
    optional ``batch["weight"]`` (float (B,), 0/1) masks rows out of every
    metric."""

    def eval_fn(params, variables, batch):
        images, labels = batch["images"], batch["labels"].long()
        logits = model.apply(params, variables["batch_stats"], images,
                             train=False)
        w = batch.get("weight")
        if w is None:
            w = torch.ones(labels.shape[0], device=logits.device)
        denom = torch.clamp(w.sum(), min=1.0)
        loss = (per_row_cross_entropy(logits, labels) * w).sum() / denom
        top1 = ((logits.argmax(-1) == labels).float() * w).sum() / denom
        top5_idx = torch.topk(logits, 5, dim=-1).indices
        top5 = ((top5_idx == labels[:, None]).any(dim=-1).float()
                * w).sum() / denom
        return {"eval_loss": loss, "top1": top1, "top5": top5}

    return eval_fn


def init_fn(model: ResNet) -> Callable:
    """``init(rng) -> (params, variables)`` from a ``torch.Generator``;
    the shapes do not depend on the image size."""
    return model.init


def synthetic_batch(rng: torch.Generator, batch_size: int,
                    image_size: int = 224, num_classes: int = 1000) -> dict:
    """Synthetic ImageNet-shaped data on the CPU: f32 normal images
    [B, S, S, 3] and int32 labels."""
    return {
        "images": torch.randn((batch_size, image_size, image_size, 3),
                              generator=rng),
        "labels": torch.randint(0, num_classes, (batch_size,),
                                generator=rng, dtype=torch.int32),
    }


# -----------------------------------------------------------------------------
# the fused inference path (ops/fused_block.py, K6)
# -----------------------------------------------------------------------------

def _affine(params: dict, stats: dict, name: str,
            eps: float = BN_EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm ``name`` folded to (scale, shift) in f32, by the one
    folding formula of ops/fused_block.py."""
    return _fb._fold_bn(params, stats, name, eps)


def _xla_block_eval(x: torch.Tensor, params: dict, stats: dict,
                    strides: int,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Strided bottleneck block at eval through PyTorch convs and folded
    BN (the blocks the fused kernel does not cover); ``params`` and
    ``stats`` by names relative to the block. Conv outputs round to
    ``dtype`` before their affine; the residual adds the two ``dtype``
    branches in f32 and rounds."""
    def bn_relu(h, name, relu=True):
        s, b = _affine(params, stats, name)
        h = h.float() * s + b
        return (torch.relu(h) if relu else h).to(dtype)

    y = bn_relu(conv(x, params["Conv_0.kernel"], 1, dtype), "BatchNorm_0")
    y = bn_relu(conv(y, params["Conv_1.kernel"], strides, dtype),
                "BatchNorm_1")
    y = bn_relu(conv(y, params["Conv_2.kernel"], 1, dtype), "BatchNorm_2",
                relu=False)
    if "conv_proj.kernel" in params:
        res = bn_relu(conv(x, params["conv_proj.kernel"], strides, dtype),
                      "norm_proj", relu=False)
    else:
        res = x
    return torch.relu(res.float() + y.float()).to(dtype)


def fused_eval_apply(variables: dict, images: torch.Tensor, *,
                     depth: int = 50, dtype: torch.dtype = torch.bfloat16,
                     block_bt: Optional[int] = None) -> torch.Tensor:
    """Inference forward with every stride-1 bottleneck running as one call
    of K6 (ops/fused_block.py): logits [B, classes] f32 from
    ``{"params", "batch_stats"}``. The same computation as
    ``ResNet.apply(train=False)`` (running statistics fold to exact
    affines), rounded at other places; the global pool stays f32. Not the
    serving default, as in the JAX package. Bottleneck depths only
    (>= 50)."""
    if depth < 50:
        raise ValueError("fused_eval_apply supports bottleneck depths "
                         "(>= 50); BasicBlock models have no Conv_2")
    params, stats = variables["params"], variables["batch_stats"]
    x = conv(images.to(dtype), params["conv_init.kernel"], 2, dtype)
    s, b = _affine(params, stats, "bn_init")
    x = torch.relu(x.float() * s + b).to(dtype)
    x = max_pool_same(x)

    for i, n_blocks in enumerate(STAGE_SIZES[depth]):
        for j in range(n_blocks):
            name = f"stage{i + 1}_block{j + 1}"
            strides = 2 if i > 0 and j == 0 else 1
            bp, bs = _block_params(params, name), _block_params(stats, name)
            if strides == 1:
                x = _fb.fused_bottleneck_eval(
                    x.contiguous(), _fb.fold_block(bp, bs),
                    block_bt=block_bt)
            else:
                x = _xla_block_eval(x, bp, bs, strides, dtype=dtype)
    x = x.float().mean(dim=(1, 2))
    return x @ params["head.kernel"].float() + params["head.bias"]


# -----------------------------------------------------------------------------
# the fused ghost-BN training path
# -----------------------------------------------------------------------------

def _bn_train(a: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = BN_EPS):
    """Train-mode BatchNorm over the whole batch, for the blocks the fused
    kernels do not cover. Returns (y in a's dtype, batch mean, batch
    var)."""
    af = a.float()
    m = af.mean(dim=(0, 1, 2))
    v = (af * af).mean(dim=(0, 1, 2)) - m * m
    xh = (af - m) * torch.rsqrt(v + eps)
    return (scale * xh + bias).to(a.dtype), m, v


def _xla_block_train(x: torch.Tensor, params: dict, strides: int,
                     dtype: torch.dtype = torch.bfloat16,
                     eps: float = BN_EPS):
    """Strided bottleneck block, train mode, through PyTorch convs and
    :func:`_bn_train` (the fused kernels cover stride-1 blocks only).
    ``params`` by names relative to the block. Returns (out, batch
    moments by name)."""
    stats = {}

    def bn(h, name, relu=True):
        y, m, v = _bn_train(h, params[f"{name}.scale"],
                            params[f"{name}.bias"], eps)
        stats[f"{name}.mean"] = m
        stats[f"{name}.var"] = v
        return torch.relu(y) if relu else y

    y = bn(conv(x, params["Conv_0.kernel"], 1, dtype), "BatchNorm_0")
    y = bn(conv(y, params["Conv_1.kernel"], strides, dtype), "BatchNorm_1")
    y = bn(conv(y, params["Conv_2.kernel"], 1, dtype), "BatchNorm_2",
           relu=False)
    if "conv_proj.kernel" in params:
        res = bn(conv(x, params["conv_proj.kernel"], strides, dtype),
                 "norm_proj", relu=False)
    else:
        res = x
    out = torch.relu(res.float() + y.float()).to(dtype)
    return out, stats


def geometry_key(h: int, w: int, cin: int, cmid: int, cout: int) -> str:
    """Stable key for one bottleneck geometry: the lookup key of the
    measured routing table (KFTPU_FUSED_ROUTING_TABLE)."""
    return f"{h}x{w}_{cin}_{cmid}_{cout}"


def _measured_routing_table() -> Optional[dict]:
    """Per-geometry kernel routing, loaded once per process from the JSON
    file named by KFTPU_FUSED_ROUTING_TABLE: geometry_key → "xla" |
    "batch" | "spatial:<tile_h>"."""
    path = os.environ.get("KFTPU_FUSED_ROUTING_TABLE")
    if not path:
        return None
    cached = _measured_routing_table.__dict__.get("cache")
    if cached is not None and cached[0] == path:
        return cached[1]
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError) as e:
        raise RuntimeError(
            f"KFTPU_FUSED_ROUTING_TABLE={path!r}: cannot load measured "
            f"routing table ({type(e).__name__}: {e}); fix or unset the "
            "env var") from e
    routes = table.get("routes", table)   # accept bare or wrapped
    _measured_routing_table.cache = (path, routes)
    return routes


def _fused_route(h: int, w: int, cin: int, cmid: int,
                 cout: int) -> tuple:
    """Kernel choice for one stride-1 bottleneck: ("batch", None) when one
    image's working set fits the budget, ("spatial", tile_h) when a halo
    strip does, ("xla", None) otherwise. A measured table
    (KFTPU_FUSED_ROUTING_TABLE) overrides the model for the geometries it
    names; KFTPU_FUSED_DISABLE_SPATIAL=1 turns the spatial branch off and
    outranks the table."""
    spatial_disabled = os.environ.get(
        "KFTPU_FUSED_DISABLE_SPATIAL", "").lower() in ("1", "true", "yes")
    table = _measured_routing_table()
    if table is not None:
        route = table.get(geometry_key(h, w, cin, cmid, cout))
        if route == "xla":
            return ("xla", None)
        if route == "batch":
            return ("batch", None)
        if isinstance(route, str) and route.startswith("spatial:"):
            return ("xla", None) if spatial_disabled else \
                ("spatial", int(route.split(":", 1)[1]))
    if _fbt.fits_vmem_budget(h, w, cin, cmid, cout):
        return ("batch", None)
    if spatial_disabled:
        return ("xla", None)
    th = _fbts.default_tile_h(h, w, cin, cmid, cout)
    return ("spatial", th) if th is not None else ("xla", None)


def _block_walk(depth: int, image_size: int):
    """Every bottleneck block's geometry in model order (SAME-padding
    ceil division: conv_init s2 + maxpool s2, then 64·2^stage widths,
    stride 2 at each later stage head): {name, h, cin, cmid, cout,
    strides}."""
    if depth < 50:
        raise ValueError("fused paths cover bottleneck depths (>= 50)")

    def ceil_half(n: int) -> int:
        return -(-n // 2)

    h = ceil_half(ceil_half(image_size))
    cin = 64
    for i, n_blocks in enumerate(STAGE_SIZES[depth]):
        cmid = 64 * 2 ** i
        cout = cmid * 4
        for j in range(n_blocks):
            strides = 2 if i > 0 and j == 0 else 1
            if strides == 2:
                h = ceil_half(h)
            yield {"name": f"stage{i + 1}_block{j + 1}", "h": h,
                   "cin": cin, "cmid": cmid, "cout": cout,
                   "strides": strides}
            cin = cout


def fused_block_routing(depth: int = 50,
                        image_size: int = 224) -> dict[str, str]:
    """block name → kernel route for the fused training path: the
    decision :func:`fused_train_apply` executes, over the same walk."""
    routes = {}
    for b in _block_walk(depth, image_size):
        if b["strides"] != 1:
            routes[b["name"]] = "xla-strided"
        else:
            kind, th = _fused_route(b["h"], b["h"], b["cin"], b["cmid"],
                                    b["cout"])
            routes[b["name"]] = {"batch": "fused-batch",
                                 "xla": "xla"}.get(
                kind, f"fused-spatial(th={th})")
    return routes


def stride1_geometries(depth: int = 50,
                       image_size: int = 224) -> list[dict]:
    """The distinct stride-1 bottleneck geometries of one model config,
    with multiplicity: {key, h, cin, cmid, cout, proj, count}."""
    geoms: dict[str, dict] = {}
    for b in _block_walk(depth, image_size):
        if b["strides"] != 1:
            continue
        key = geometry_key(b["h"], b["h"], b["cin"], b["cmid"], b["cout"])
        g = geoms.setdefault(key, {
            "key": key, "h": b["h"], "cin": b["cin"], "cmid": b["cmid"],
            "cout": b["cout"], "proj": b["cin"] != b["cout"], "count": 0})
        g["count"] += 1
    return list(geoms.values())


def random_block_params(generator: torch.Generator, cin: int, cmid: int,
                        cout: int, proj: bool) -> dict:
    """He-init params for one bottleneck block at any geometry, by names
    relative to the block (the model-free block constructor)."""
    def he(shape):
        return _truncated_normal(shape, 2.0, generator)

    def bn(name, c):
        return {f"{name}.scale": torch.ones(c), f"{name}.bias": torch.zeros(c)}

    p = {"Conv_0.kernel": he((1, 1, cin, cmid)), **bn("BatchNorm_0", cmid),
         "Conv_1.kernel": he((3, 3, cmid, cmid)), **bn("BatchNorm_1", cmid),
         "Conv_2.kernel": he((1, 1, cmid, cout)), **bn("BatchNorm_2", cout)}
    if proj:
        p["conv_proj.kernel"] = he((1, 1, cin, cout))
        p.update(bn("norm_proj", cout))
    return p


def _block_params(params: dict, name: str) -> dict:
    prefix = f"{name}."
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def fused_train_apply(variables: dict, images: torch.Tensor, *,
                      depth: int = 50, tile_bt: Optional[int] = None,
                      dtype: torch.dtype = torch.bfloat16,
                      eps: float = BN_EPS,
                      group=None) -> tuple[torch.Tensor, dict]:
    """Training forward with every stride-1 bottleneck running as one
    fused ghost-BN block (K4 or K5, by :func:`_fused_route`). Returns
    (logits, new batch_stats): the running statistics EMA-updated from
    the tile-averaged ghost moments, detached. With ``group`` (the
    replicas' process group; ``images`` are this rank's rows) the batch
    moments are all-reduced to their mean over the ranks first, in one
    call."""
    if depth < 50:
        raise ValueError("fused_train_apply supports bottleneck depths "
                         "(>= 50); BasicBlock models have no Conv_2")
    params, stats = variables["params"], variables["batch_stats"]
    moments: dict = {}
    x = conv(images.to(dtype), params["conv_init.kernel"], 2, dtype)
    y, m, v = _bn_train(x, params["bn_init.scale"], params["bn_init.bias"],
                        eps)
    moments["bn_init.mean"], moments["bn_init.var"] = m, v
    x = max_pool_same(torch.relu(y))

    for i, n_blocks in enumerate(STAGE_SIZES[depth]):
        for j in range(n_blocks):
            name = f"stage{i + 1}_block{j + 1}"
            strides = 2 if i > 0 and j == 0 else 1
            bp = _block_params(params, name)
            _, h, w_, cin = x.shape
            cmid = bp["Conv_0.kernel"].shape[-1]
            cout = bp["Conv_2.kernel"].shape[-1]
            kind, th = ("xla", None) if strides != 1 else \
                _fused_route(h, w_, cin, cmid, cout)
            if kind == "batch":
                x, bstats = _fbt.fused_bottleneck_train(
                    x.contiguous(), bp, tile_bt=tile_bt, eps=eps)
            elif kind == "spatial":
                x, bstats = _fbts.fused_bottleneck_train_spatial(
                    x.contiguous(), bp, tile_h=th, eps=eps)
            else:
                x, bstats = _xla_block_train(x, bp, strides, dtype=dtype,
                                             eps=eps)
            for k, val in bstats.items():
                moments[f"{name}.{k}"] = val

    x = x.float().mean(dim=(1, 2))
    logits = x @ params["head.kernel"].float() + params["head.bias"]
    if group is not None:
        keys = sorted(moments)
        flat = torch.cat([moments[k].detach().float().reshape(-1)
                          for k in keys])
        collectives.all_reduce_(flat, group)
        flat = flat / dist.get_world_size(group)
        moments = dict(zip(keys, flat.split(
            [moments[k].numel() for k in keys])))
    # running-stat EMA, flax semantics: ra = m·ra + (1−m)·batch
    new_stats = {k: (_BN_MOMENTUM * ra + (1.0 - _BN_MOMENTUM)
                     * moments[k]).detach() for k, ra in stats.items()}
    return logits, new_stats


def make_fused_loss_fn(model: ResNet, label_smoothing: float = 0.0,
                       tile_bt: Optional[int] = None, mesh=None) -> Callable:
    """Loss fn (TrainStepBuilder signature) over
    :func:`fused_train_apply`. Over a mesh with more than one replica each
    rank runs the fused blocks on its own rows (per-rank ghost BN, the JAX
    package's ``shard_map`` over the data axes) and the batch moments are
    averaged over the ranks before the EMA; the train step averages the
    gradients."""
    if model.depth < 50:
        raise ValueError("fused blocks require a bottleneck ResNet "
                         "(depth >= 50)")
    group = replica_group(mesh)

    def loss_fn(params, variables, batch, rng):
        logits, new_stats = fused_train_apply(
            {"params": params, **variables}, batch["images"],
            depth=model.depth, tile_bt=tile_bt, dtype=model.dtype,
            group=group)
        labels = batch["labels"]
        loss = cross_entropy_loss(logits, labels, label_smoothing)
        return loss, {"accuracy": _accuracy(logits, labels),
                      "variables": {"batch_stats": new_stats}}

    return loss_fn


def workload_spec(image_size: int = 224, num_classes: int = 1000,
                  depth: int = 50, label_smoothing: float = 0.0,
                  fused: bool = False, fused_tile_bt: Optional[int] = None,
                  mesh=None):
    """WorkloadSpec factory for runtime.worker: the exact-BN default path,
    or with ``fused`` the ghost-BN fused-block variant (per-tile BN
    statistics, one K4/K5 call per stride-1 bottleneck a direction)."""
    from ..runtime.worker import WorkloadSpec
    model = make_resnet(depth, num_classes=num_classes)
    if fused:
        loss_fn = make_fused_loss_fn(model, label_smoothing=label_smoothing,
                                     tile_bt=fused_tile_bt, mesh=mesh)
    else:
        loss_fn = make_loss_fn(model, label_smoothing=label_smoothing,
                               mesh=mesh)
    return WorkloadSpec(
        name=f"resnet{depth}" + ("-fused" if fused else ""),
        init_fn=init_fn(model),
        loss_fn=loss_fn,
        batch_fn=lambda rng, bs: synthetic_batch(rng, bs, image_size,
                                                 num_classes),
        eval_fn=make_eval_fn(model),
    )
