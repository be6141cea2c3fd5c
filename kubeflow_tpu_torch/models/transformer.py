"""Decoder-only Transformer LM, the port of ``kubeflow_tpu/models/transformer.py``.

Parameters keep the shapes the flax tree gives them, and the state-dict
keys are the flax paths joined with dots (``layer0.attn.qkv.kernel``), so
the weight converter (models/convert.py) is a name map and int8
quantization's per-last-axis scales match the JAX package's:

- ``attn.qkv.kernel`` [E, 3, H, D], ``attn.out.kernel`` [H, D, E];
- Dense kernels [in, out]; embeddings [V, E] and [S, E];
- LayerNorm ``scale`` and ``bias`` [E].

Precision follows the flax modules layer by layer: params are f32 and
cast to the activation dtype per matmul, activations are ``cfg.dtype``
(bf16 by default), every LayerNorm computes in f32 with eps 1e-6, the
MLP uses the tanh-approximated gelu, and the head runs in f32, so the
logits are f32. The two attention paths scale differently, as in the
JAX package: ``einsum`` divides q by sqrt(D) in the activation dtype and
masks with that dtype's lowest value; ``flash`` scales inside the kernel
in f32 (ops/flash_attention.py), and trains through its backward kernels.

The training surface mirrors the JAX module's: ``next_token_loss``,
``make_loss_fn`` / ``make_eval_fn`` (functions of a params dict, run
through ``torch.func.functional_call`` on a parameterless copy of the
model on the ``meta`` device), ``init_fn``, ``synthetic_batch`` (from a
``torch.Generator``), ``logical_axes`` and ``workload_spec`` for
runtime/worker.py.

- ``num_experts > 0`` swaps each block's MLP for ``MoEMLP``
  (models/moe.py) under the name ``moe``; each block returns its weighted
  aux loss, and ``make_loss_fn`` adds their sum to the loss and reports
  it as ``moe_aux_loss`` (the eval function ignores it, as the JAX
  package's does).
- ``remat`` runs each block under ``torch.utils.checkpoint`` (non-
  reentrant): the backward recomputes the block's forward, K1 included.
- Model parallelism (``mesh`` with fsdp, tensor or expert above 1): the
  loss function sees this rank's block of each param, cut by
  ``TRANSFORMER_RULES`` from ``logical_axes``. Each fsdp-sharded leaf is
  gathered whole before the forward (its gradient reduce-scattered into
  the block). Over ``tensor`` the blocks run Megatron's pattern: ``qkv``
  split by heads (the attention on the local heads), ``attn.out`` and
  ``mlp.wo`` row-parallel (all-reduced forward), the inputs of the
  column-parallel products all-reduced backward, ``tok_embed`` split
  over the vocabulary (a masked lookup, all-reduced), and the head
  column-parallel with its logits gathered over the vocabulary.
- Sequence parallelism (``mesh`` with sequence above 1): a rank holds
  its chunk of every sequence, ``S/n`` positions from
  ``mesh.chunk_offset``; its position embeddings and causal mask rows
  start there. ``attention="ring"`` runs ``ops/ring_attention.py`` over
  the sequence group. ``einsum`` and ``flash`` run as the JAX package's
  GSPMD runs them there (a ``pallas_call`` has no partitioning rule, so
  XLA gathers its operands): :class:`_SequenceGathered` all-gathers Q, K
  and V, runs the whole sequence's attention (K1 for flash) and keeps
  this rank's rows; its backward all-gathers dO, runs the whole
  backward (K2a and K2b) and keeps this rank's chunk of dq, dk and dv.
  The loss's target of a chunk's last position is the next chunk's first
  token (``next_tokens``, which runtime/trainstep.py places beside the
  chunk), and the loss is the global sum over the global count,
  summed over the sequence ranks forward and identity backward, so the
  train step's gradient sum over the axis gives the whole sequence's
  gradient. With experts each chunk routes as the whole sequence routes
  (models/moe.py); the aux loss, whole and the same on every sequence
  rank, enters the loss counted once over the axis
  (``collectives.once_over``). The stacked LM runs the same blocks on
  its chunks, its GPipe hops in the pipeline group of the rank's own
  sequence coordinate.
- The stacked LM of pipeline parallelism (:class:`PipelinedTransformerLM`,
  ``pipelined_logical_axes``, ``pipelined_workload_spec``, and
  ``multislice_stage_fns`` for the MPMD engine): every block param
  carries a leading layers dimension, which the ``pipeline`` axis splits
  into stages (parallel/pipeline.py, parallel/multislice.py). MoE is
  refused there, in the JAX package's words.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, replace
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from ..ops.ring_attention import ring_attention
from ..parallel import collectives
from ..parallel.sharding_rules import TRANSFORMER_RULES, entry_axes


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    embed_dim: int = 768
    num_heads: int = 12
    head_dim: int = 64
    mlp_dim: int = 3072
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False          # checkpoint each block (memory for FLOPs)
    # "einsum" (plain PyTorch), "flash" (the CUDA kernel,
    # ops/flash_attention) or "ring" (ops/ring_attention over the mesh's
    # sequence axis; the flash kernel without one)
    attention: str = "einsum"
    # mixture-of-experts: num_experts > 0 swaps the dense MLP for MoEMLP
    # (models/moe.py), its expert weights over the mesh axis "expert"
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        valid = ("einsum", "flash", "ring")
        if self.attention not in valid:
            raise ValueError(
                f"attention={self.attention!r} not in {valid}")

    @classmethod
    def tiny(cls) -> "TransformerConfig":
        return cls(vocab_size=256, num_layers=2, embed_dim=64, num_heads=4,
                   head_dim=16, mlp_dim=128, max_seq_len=128)


def _param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=torch.float32))


class _Kernel(nn.Module):
    """A bias-free Dense/DenseGeneral: one f32 ``kernel`` in flax's shape."""

    def __init__(self, *shape: int):
        super().__init__()
        self.kernel = _param(*shape)


class _Embed(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = _param(num, dim)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: statistics and output in f32,
    variance as E[x²] − E[x]² clamped at 0, eps 1e-6."""

    eps = 1e-6

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale \
            + self.bias


def _tensor_group(mesh) -> Optional[object]:
    return None if mesh is None else mesh.group_of("tensor")


def _seq_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get("sequence", 1)


def _einsum_attention(q, k, v, cfg: "TransformerConfig") -> torch.Tensor:
    """The plain causal attention of the JAX module's einsum path: q
    divided by sqrt(D) in the activation dtype, masked with its lowest
    value, softmax in f32."""
    dt = cfg.dtype
    s = q.shape[1]
    q = q / torch.tensor(math.sqrt(cfg.head_dim), dtype=dt)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, torch.finfo(dt).min)
    probs = torch.softmax(logits.float(), dim=-1).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _gather_seq(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' chunks of ``t`` [B, S_local, ...] in sequence order:
    [B, S, ...]."""
    return collectives.all_gather(t.movedim(1, 0), group).movedim(
        0, 1).contiguous()


class _SequenceGathered(torch.autograd.Function):
    """Whole-sequence attention on a rank's chunks: the forward gathers
    Q, K and V over the sequence group, runs ``attend`` on the whole
    sequence and returns this rank's rows; the backward gathers dO, runs
    ``attend``'s backward on the whole sequence (every rank's rows
    depend on every rank's K and V) and returns this rank's chunk of dq,
    dk and dv. Every rank computes the same whole attention, so the
    gathered dO is the whole output's cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, attend, group, index):
        full = [_gather_seq(t, group) for t in (q, k, v)]
        n = q.shape[1]
        ctx.n, ctx.index, ctx.group = n, index, group
        if any(ctx.needs_input_grad[:3]):
            with torch.enable_grad():
                ctx.leaves = [t.requires_grad_() for t in full]
                ctx.out = attend(*ctx.leaves)
            out = ctx.out.detach()
        else:
            out = attend(*full)
        return out.narrow(1, index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        grads = torch.autograd.grad(ctx.out, ctx.leaves,
                                    _gather_seq(g, ctx.group))
        del ctx.out, ctx.leaves
        return tuple(x.narrow(1, ctx.index * ctx.n, ctx.n)
                     for x in grads) + (None, None, None)


class Attention(nn.Module):
    """Over ``tensor`` the params are this rank's heads: ``qkv`` [E, 3,
    H/t, D] and ``out`` [H/t, D, E], row-parallel."""

    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        e, h, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim
        self.qkv = _Kernel(e, 3, h, d)
        self.out = _Kernel(h, d, e)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        tg = _tensor_group(self.mesh)
        qkv = torch.einsum("bse,ethd->bsthd",
                           collectives.copy_to(x.to(dt), tg),
                           self.qkv.kernel.to(dt))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cfg.attention == "ring":
            out = ring_attention(q, k, v, mesh=self.mesh, causal=True)
        else:
            if cfg.attention == "flash":
                def attend(q, k, v):
                    return flash_attention(q, k, v, causal=True)
            else:
                def attend(q, k, v):
                    return _einsum_attention(q, k, v, cfg)
            if _seq_size(self.mesh) > 1:
                # K1 masks top-left: right only because Q is whole
                out = _SequenceGathered.apply(
                    q, k, v, attend, self.mesh.group_of("sequence"),
                    self.mesh.coords["sequence"])
            else:
                out = attend(q, k, v)
        out = torch.einsum("bshd,hde->bse", out, self.out.kernel.to(dt))
        return collectives.reduce_from(out, tg)


class MLP(nn.Module):
    """Over ``tensor``: ``wi`` [E, F/t] column- and ``wo`` [F/t, E]
    row-parallel."""

    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.wi = _Kernel(cfg.embed_dim, cfg.mlp_dim)
        self.wo = _Kernel(cfg.mlp_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        tg = _tensor_group(self.mesh)
        h = collectives.copy_to(x.to(dt), tg) @ self.wi.kernel.to(dt)
        h = F.gelu(h, approximate="tanh")   # flax nn.gelu's default
        return collectives.reduce_from(h @ self.wo.kernel.to(dt), tg)


class Block(nn.Module):
    """``x -> (x', aux)``: aux is the MoE layer's weighted aux loss (None
    for the dense MLP)."""

    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = LayerNorm(cfg.embed_dim)
        self.attn = Attention(cfg, mesh)
        self.ln2 = LayerNorm(cfg.embed_dim)
        if cfg.num_experts > 0:
            from .moe import MoEMLP
            self.moe = MoEMLP(cfg.num_experts, cfg.embed_dim, cfg.mlp_dim,
                              top_k=cfg.moe_top_k,
                              capacity_factor=cfg.moe_capacity_factor,
                              aux_loss_weight=cfg.moe_aux_weight,
                              dtype=cfg.dtype, mesh=mesh)
        else:
            self.mlp = MLP(cfg, mesh)

    def forward(self, x: torch.Tensor
                ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = x + self.attn(self.ln1(x))
        y = self.ln2(x)
        if self.cfg.num_experts > 0:
            ff, aux = self.moe(y)
        else:
            ff, aux = self.mlp(y), None
        return x + ff, aux


def _get(module: nn.Module, name: str) -> torch.Tensor:
    """The tensor at a dotted name (under ``functional_call``, the one
    swapped in)."""
    for part in name.split("."):
        module = getattr(module, part)
    return module


def _lookup(table: torch.Tensor, tokens: torch.Tensor, mesh
            ) -> torch.Tensor:
    """The token lookup; over ``tensor`` the table is this rank's rows of
    the vocabulary: a masked lookup, summed over the ranks."""
    tg = _tensor_group(mesh)
    ids = tokens.long()
    if tg is None:
        return F.embedding(ids, table)
    rows = table.shape[0]
    local = ids - mesh.coords["tensor"] * rows
    hit = (local >= 0) & (local < rows)
    x = F.embedding(local.clamp(0, rows - 1), table) * hit[..., None]
    return collectives.reduce_from(x, tg)


def _head_logits(ln_f: LayerNorm, kernel: torch.Tensor, x: torch.Tensor,
                 mesh) -> torch.Tensor:
    """ln_f then the f32 vocabulary product (column-parallel over
    ``tensor``, its logits gathered)."""
    tg = _tensor_group(mesh)
    logits = collectives.copy_to(ln_f(x), tg) @ kernel
    return collectives.gather_from(logits, tg, -1)


def _positions(table: torch.Tensor, length: int, mesh) -> torch.Tensor:
    """The position embeddings of this rank's ``length`` positions: from
    its chunk's offset on a sequence mesh."""
    start = 0 if mesh is None else mesh.chunk_offset(length)
    return table[start:start + length]


def _remat_call(block: nn.Module, params: dict, x: torch.Tensor) -> tuple:
    """``block(x)`` on ``params`` (name -> tensor) under the non-reentrant
    checkpoint; the params go in as inputs, so the backward's recompute
    (after ``functional_call`` has returned) sees the same tensors."""
    names = list(params)

    def run(h, *ps):
        return functional_call(block, dict(zip(names, ps)), (h,))

    # the blocks draw no random numbers: no RNG state to replay, and
    # none to read inside a CUDA graph capture
    return checkpoint(run, x, *params.values(), use_reentrant=False,
                      preserve_rng_state=False)


class TransformerLM(nn.Module):
    """tokens [B, S] int → logits [B, S, V] f32 (with ``with_aux``,
    ``(logits, the summed MoE aux loss or None)``). ``mesh``: the params
    are this rank's blocks (the module docstring)."""

    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.tok_embed = _Embed(cfg.vocab_size, cfg.embed_dim)
        self.pos_embed = _Embed(cfg.max_seq_len, cfg.embed_dim)
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", Block(cfg, mesh))
        self.ln_f = LayerNorm(cfg.embed_dim)
        self.head = _Kernel(cfg.embed_dim, cfg.vocab_size)

    def blocks(self) -> list[Block]:
        return [getattr(self, f"layer{i}")
                for i in range(self.cfg.num_layers)]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return _lookup(self.tok_embed.embedding, tokens, self.mesh)

    def _remat(self, block: Block, x: torch.Tensor) -> tuple:
        return _remat_call(block, {n: _get(block, n) for n, _ in
                                   block.named_parameters()}, x)

    def forward(self, tokens: torch.Tensor, with_aux: bool = False):
        dt = self.cfg.dtype
        x = self._embed(tokens).to(dt)
        pos = _positions(self.pos_embed.embedding, tokens.shape[1],
                         self.mesh).to(dt)
        x = x + pos[None]
        aux = None
        for block in self.blocks():
            x, a = self._remat(block, x) if self.cfg.remat else block(x)
            if a is not None:
                aux = a if aux is None else aux + a
        logits = _head_logits(self.ln_f, self.head.kernel, x, self.mesh)
        return (logits, aux) if with_aux else logits

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TransformerLM":
        """Random weights from ``generator``, of the kinds flax's
        initialisers draw (truncated lecun-normal kernels, unit-variance
        fan-in embeddings, unit LayerNorm), not the same bits."""
        for name, p in self.named_parameters():
            if name.endswith(("scale", "bias")):
                continue
            if name.endswith("embedding"):
                fan_in = p.shape[1]
            elif name.endswith("attn.out.kernel"):     # [H, D, E]
                fan_in = p.shape[0] * p.shape[1]
            elif name.endswith(("moe.wi", "moe.wo")):  # [E, in, out]
                fan_in = p.shape[0] * p.shape[1]
            else:                                      # [in, ...]
                fan_in = p.shape[0]
            std = 1.0 / math.sqrt(fan_in)
            t = torch.empty(p.shape, dtype=torch.float32)
            nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            p.copy_(t)
        return self


_MOE_REFUSAL = ("MoE (num_experts>0) is not supported on the pipelined path "
                "yet; use the non-pipelined transformer workload for EP")


class _Embedder(nn.Module):
    """Token + position embedding (the pre-pipeline stage-0 prologue)."""

    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.tok_embed = _Embed(cfg.vocab_size, cfg.embed_dim)
        self.pos_embed = _Embed(cfg.max_seq_len, cfg.embed_dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = _lookup(self.tok_embed.embedding, tokens, self.mesh).to(dt)
        return x + _positions(self.pos_embed.embedding, tokens.shape[1],
                              self.mesh).to(dt)[None]


class _LMHead(nn.Module):
    """Final layernorm + vocab projection (the post-pipeline epilogue)."""

    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.ln_f = LayerNorm(cfg.embed_dim)
        self.head = _Kernel(cfg.embed_dim, cfg.vocab_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _head_logits(self.ln_f, self.head.kernel, x, self.mesh)


class PipelinedTransformerLM(nn.Module):
    """The stacked-layer LM of pipeline parallelism: ``embed``
    (:class:`_Embedder`), ``blocks`` (one :class:`Block` whose every
    parameter carries a leading ``[L]`` layers dimension: state-dict
    names ``blocks.attn.qkv.kernel`` [L, E, 3, H, D] and so on, the flax
    tree of the JAX package's ``PipelinedTransformerLM`` flattened) and
    ``head`` (:class:`_LMHead`). tokens [B, S] → logits [B, S, V] f32.

    The blocks apply one layer at a time through ``functional_call`` on
    the layer's slices (checkpointed under ``cfg.remat``), routed
    through ``parallel/pipeline.py`` ``pipeline_apply``: the GPipe
    schedule over the mesh's pipeline axis, whose rank holds its stage's
    layers, or the layers in order without one; the same numbers either
    way. ``mesh`` also splits the blocks, the embedding and the head over
    ``tensor``, and the positions over ``sequence``, as
    :class:`TransformerLM`'s."""

    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        if cfg.num_experts > 0:
            # the block scan carries no aux loss out: refuse rather than
            # train a collapsed router
            raise NotImplementedError(_MOE_REFUSAL)
        self.cfg = cfg
        self.mesh = mesh
        self.embed = _Embedder(cfg, mesh)
        self.blocks = Block(cfg, mesh)
        for name, p in list(self.blocks.named_parameters()):
            owner, leaf = name.rsplit(".", 1)
            setattr(_get(self.blocks, owner), leaf, nn.Parameter(
                p.detach().unsqueeze(0).repeat(
                    (cfg.num_layers,) + (1,) * p.dim())))
        self.head = _LMHead(cfg, mesh)

    def block_fn(self, layer: dict, h: torch.Tensor) -> torch.Tensor:
        """One block on one layer's params (name -> tensor, the names
        under ``blocks.``)."""
        if self.cfg.remat:
            return _remat_call(self.blocks, layer, h)[0]
        return functional_call(self.blocks, layer, (h,))[0]

    def stacked(self) -> dict:
        """The stacked block params (under ``functional_call``, those
        swapped in: this rank's stage on a pipeline mesh)."""
        return {n: _get(self.blocks, n)
                for n, _ in self.blocks.named_parameters()}

    def forward(self, tokens: torch.Tensor,
                num_microbatches: int = 1) -> torch.Tensor:
        from ..parallel.pipeline import pipeline_apply
        x = self.embed(tokens)
        x = pipeline_apply(self.block_fn, self.stacked(), x, mesh=self.mesh,
                           num_microbatches=num_microbatches,
                           num_layers=self.cfg.num_layers)
        return self.head(x)


def _targets(tokens: torch.Tensor, next_tokens, mesh) -> tuple:
    """``(targets [B, S_local] long, the number of leading positions
    that have one, the global count B·(S−1))``: shift-left targets
    (``roll(-1)``) with the global last position masked. On a sequence
    mesh ``tokens`` is this rank's chunk and ``next_tokens`` [B, 1] the
    next chunk's first column, the target of the chunk's last position;
    only the last rank's last position has none."""
    b, s = tokens.shape
    n = _seq_size(mesh)
    if n == 1:
        return torch.roll(tokens, -1, dims=1).long(), s - 1, b * (s - 1)
    if next_tokens is None:
        raise ValueError("on a sequence mesh the loss needs the next "
                         "chunk's first tokens (batch['next_tokens'], "
                         "placed by TrainStepBuilder.place_batch)")
    targets = torch.cat([tokens[:, 1:], next_tokens.reshape(b, 1).to(
        tokens.dtype)], dim=1).long()
    last = mesh.coords["sequence"] == n - 1
    return targets, s - 1 if last else s, b * (n * s - 1)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    next_tokens: Optional[torch.Tensor] = None,
                    mesh=None) -> tuple:
    """Next-token loss with full-length input and shift-left targets
    (``roll(-1)``); the final position has no target and is masked out,
    so the loss is the mean over B·(S−1) positions. Returns (loss,
    {"perplexity": exp(loss)}). On a sequence mesh (``mesh``) ``tokens``
    is this rank's chunk and ``next_tokens`` the next chunk's first
    column: the loss is this rank's sum over the global count, summed
    over the sequence ranks forward and identity backward, so every rank
    reports the global loss and its gradient is its own term's."""
    b, s, v = logits.shape
    targets, valid, count = _targets(tokens, next_tokens, mesh)
    nll = F.cross_entropy(logits.reshape(b * s, v), targets.reshape(b * s),
                          reduction="none").view(b, s)
    loss = nll[:, :valid].sum() / count
    if _seq_size(mesh) > 1:
        loss = collectives.reduce_from(loss, mesh.group_of("sequence"))
    return loss, {"perplexity": torch.exp(loss)}


def gather_params(params: dict, dims: Optional[dict], group) -> dict:
    """Each fsdp-sharded block in ``params`` gathered whole along its
    dimension (``dims``: name -> dimension); the gradient of a gathered
    leaf reduce-scatters into its block."""
    if not dims:
        return params
    return {n: collectives.gather_shards(p, group, dims[n])
            if n in dims else p for n, p in params.items()}


def make_loss_fn(model: TransformerLM,
                 fsdp_dims: Optional[dict] = None) -> Callable:
    """``loss_fn(params, variables, batch, rng) -> (loss, aux)`` over a
    params dict keyed like the model's state dict (this rank's blocks
    under a mesh; ``fsdp_dims`` the dimension of each fsdp-sharded
    leaf). With experts, the loss includes the summed aux loss, reported
    as ``moe_aux_loss``; on a sequence mesh every rank computes it whole,
    so its gradient enters once over the axis."""
    mesh = model.mesh
    group = None if mesh is None else mesh.group_of("fsdp")
    seq = None if mesh is None else mesh.group_of("sequence")

    def loss_fn(params, variables, batch, rng):
        tokens = batch["tokens"]
        logits, aux = functional_call(
            model, gather_params(params, fsdp_dims, group), (tokens,),
            {"with_aux": True})
        loss, metrics = next_token_loss(logits, tokens,
                                        batch.get("next_tokens"), model.mesh)
        if aux is None:
            return loss, metrics
        metrics["moe_aux_loss"] = aux
        return loss + collectives.once_over(aux, seq), metrics

    return loss_fn


def make_eval_fn(model: TransformerLM,
                 fsdp_dims: Optional[dict] = None) -> Callable:
    """Held-out eval: next-token loss / perplexity / token accuracy."""
    group = None if model.mesh is None else model.mesh.group_of("fsdp")

    def eval_fn(params, variables, batch):
        tokens = batch["tokens"]
        nxt = batch.get("next_tokens")
        logits = functional_call(
            model, gather_params(params, fsdp_dims, group), (tokens,))
        loss, _ = next_token_loss(logits, tokens, nxt, model.mesh)
        targets, valid, count = _targets(tokens, nxt, model.mesh)
        hits = (logits[:, :valid].argmax(-1) == targets[:, :valid]).float()
        if _seq_size(model.mesh) == 1:
            accuracy = hits.mean()
        else:
            accuracy = collectives.reduce_from(
                hits.sum() / count, model.mesh.group_of("sequence"))
        return {"eval_loss": loss,
                "eval_perplexity": torch.exp(loss),
                "eval_token_accuracy": accuracy}

    return eval_fn


def init_fn(model: TransformerLM) -> Callable:
    """``init(rng) -> (params, variables)``: random weights from the
    ``torch.Generator`` (``TransformerLM.init_weights``) as a dict of f32
    CPU tensors; the LM has no mutable variables."""

    def _init(rng: torch.Generator):
        real = TransformerLM(model.cfg).init_weights(rng)
        return dict(real.state_dict()), {}

    return _init


def synthetic_batch(rng: torch.Generator, batch_size: int, seq_len: int,
                    vocab_size: int) -> dict:
    """Uniform random tokens [batch_size, seq_len] int32 on the CPU."""
    return {"tokens": torch.randint(0, vocab_size, (batch_size, seq_len),
                                    generator=rng, dtype=torch.int32)}


# Param name → logical axes, the JAX package's table over the flax paths
# ("/"-joined; the port's dotted names are matched with "/" for ".").
# Order matters: the first match wins.
_LOGICAL_PATTERNS: list[tuple[str, tuple]] = [
    # "vocab_table", not "vocab": the table is gather-indexed on this
    # dimension (a masked lookup over tensor); the head's "vocab" is the
    # column-parallel product
    (r"tok_embed.*embedding", ("vocab_table", "embed")),
    (r"pos_embed.*embedding", (None, "embed")),
    (r"attn/qkv.*kernel", ("embed", None, "heads", "head_dim")),
    (r"attn/out.*kernel", ("heads", "head_dim", "embed")),
    (r"mlp/wi.*kernel", ("embed", "mlp")),
    (r"mlp/wo.*kernel", ("mlp", "embed")),
    (r"moe/router", ("embed", None)),
    (r"moe/wi", ("expert", "embed", "mlp")),
    (r"moe/wo", ("expert", "mlp", "embed")),
    (r"head.*kernel", ("embed", "vocab")),
    (r"(ln\d*|ln_f)/(scale|bias)", ("embed",)),
]


def logical_axes(params: dict) -> dict:
    """Name → logical-axis tuple for a state dict (or any name → tensor
    or shape map), by the first matching pattern; unmatched leaves are
    replicated."""
    out = {}
    for name, leaf in params.items():
        ndim = len(leaf) if isinstance(leaf, (tuple, list, torch.Size)) \
            else leaf.dim()
        path = name.replace(".", "/")
        for pat, axes in _LOGICAL_PATTERNS:
            if re.search(pat, path):
                if len(axes) != ndim:
                    raise ValueError(f"{name}: {axes} vs rank {ndim}")
                out[name] = axes
                break
        else:
            out[name] = (None,) * ndim
    return out


def fsdp_dims(axes: dict, rules, mesh) -> dict:
    """Name → the dimension the fsdp axis shards, for every leaf it
    shards on ``mesh``."""
    out = {}
    if mesh is None:
        return out
    for name, ax in axes.items():
        spec = rules.spec_for(ax, mesh.shape)
        for d, entry in enumerate(spec):
            if "fsdp" in entry_axes(entry):
                if entry_axes(entry) != ("fsdp",):
                    raise NotImplementedError(
                        f"{name}: dimension {d} over {entry}; an fsdp "
                        f"gather of a dimension split over several axes "
                        f"is not ported")
                out[name] = d
    return out


def workload_spec(cfg: Optional[TransformerConfig] = None,
                  seq_len: Optional[int] = None, mesh=None):
    """WorkloadSpec factory for runtime.worker, annotated for the fsdp,
    tensor and expert axes (``rules``, ``param_logical_axes``). Under a
    ``mesh`` the loss and eval functions take this rank's blocks
    (TrainStepBuilder cuts them by the same rules) and run the mesh's
    collectives; an axis of size 1 has none, so a data-only mesh runs
    only the MoE aux loss's sums over the global batch."""
    from ..runtime.worker import WorkloadSpec
    cfg = cfg or TransformerConfig.tiny()
    seq_len = seq_len or cfg.max_seq_len
    # the module without storage: the loss and eval functions take their
    # parameters from a params dict (functional_call)
    with torch.device("meta"):
        model = TransformerLM(cfg, mesh)
        axes = logical_axes(dict(TransformerLM(cfg).state_dict()))
    dims = fsdp_dims(axes, TRANSFORMER_RULES, mesh)
    return WorkloadSpec(
        name="transformer",
        init_fn=init_fn(model),
        loss_fn=make_loss_fn(model, dims),
        batch_fn=lambda rng, bs: synthetic_batch(rng, bs, seq_len,
                                                 cfg.vocab_size),
        rules=TRANSFORMER_RULES,
        param_logical_axes=axes,
        eval_fn=make_eval_fn(model, dims),
    )


def pipelined_logical_axes(params: dict) -> dict:
    """Name → logical axes for the stacked
    :class:`PipelinedTransformerLM` state dict: the block leaves
    (``blocks.*``) gain a leading "layers" axis (→ mesh axis
    "pipeline")."""
    out = {}
    for name, leaf in params.items():
        ndim = len(leaf) if isinstance(leaf, (tuple, list, torch.Size)) \
            else leaf.dim()
        stacked = name.startswith("blocks.")
        path = name.replace(".", "/")
        for pat, axes in _LOGICAL_PATTERNS:
            if re.search(pat, path):
                break
        else:
            axes = (None,) * (ndim - (1 if stacked else 0))
        axes = ("layers",) + axes if stacked else axes
        if len(axes) != ndim:
            raise ValueError(f"{name}: {axes} vs rank {ndim}")
        out[name] = axes
    return out


def pipelined_init_fn(cfg: TransformerConfig) -> Callable:
    """``init(rng) -> (params, variables)``: :class:`TransformerLM`'s
    random weights from the same ``torch.Generator``, stacked
    (models/convert.py ``stack_blocks``), so the pipelined LM starts from
    the per-layer LM's weights at the same seed."""
    from .convert import stack_blocks

    def _init(rng: torch.Generator):
        real = TransformerLM(replace(cfg, num_experts=0)).init_weights(rng)
        return stack_blocks(dict(real.state_dict()), cfg.num_layers), {}

    return _init


def pipelined_workload_spec(cfg: Optional[TransformerConfig] = None,
                            seq_len: Optional[int] = None, mesh=None,
                            num_microbatches: int = 1):
    """WorkloadSpec for the stacked LM (``ShardingSpec.pipeline > 1``):
    under a ``mesh`` the loss function takes this rank's blocks (its
    stage's layers, cut by ``("layers", "pipeline")``) and runs the GPipe
    schedule with ``num_microbatches``; on a sequence mesh over this
    rank's chunk, its loss with the next chunk's first tokens."""
    from ..runtime.worker import WorkloadSpec
    cfg = cfg or TransformerConfig.tiny()
    if cfg.num_experts > 0:
        raise NotImplementedError(_MOE_REFUSAL)
    seq_len = seq_len or cfg.max_seq_len
    with torch.device("meta"):
        model = PipelinedTransformerLM(cfg, mesh)
        axes = pipelined_logical_axes(
            dict(PipelinedTransformerLM(cfg).state_dict()))
    dims = fsdp_dims(axes, TRANSFORMER_RULES, mesh)
    group = None if mesh is None else mesh.group_of("fsdp")

    def loss_fn(params, variables, batch, rng):
        tokens = batch["tokens"]
        logits = functional_call(
            model, gather_params(params, dims, group), (tokens,),
            {"num_microbatches": num_microbatches})
        return next_token_loss(logits, tokens, batch.get("next_tokens"),
                               model.mesh)

    return WorkloadSpec(
        name="transformer-pipelined",
        init_fn=pipelined_init_fn(cfg),
        loss_fn=loss_fn,
        batch_fn=lambda rng, bs: synthetic_batch(rng, bs, seq_len,
                                                 cfg.vocab_size),
        rules=TRANSFORMER_RULES,
        param_logical_axes=axes,
    )


def multislice_stage_fns(cfg: TransformerConfig) -> tuple:
    """The MPMD engine's stage contract (parallel/multislice.py) for the
    pipelined LM: ``(init_fn, embed_fn, block_fn, head_loss_fn)``.
    ``init_fn`` is the whole :class:`PipelinedTransformerLM` init (the
    same generator gives the single-program arm's weights); the stage
    functions run the modules the GPipe path applies, on params keyed by
    the names under ``embed.``, ``blocks.`` and ``head.``."""
    if cfg.num_experts > 0:
        raise NotImplementedError(
            "MoE is not supported on the MPMD multislice path yet "
            "(same limit as the single-program pipelined workload)")
    with torch.device("meta"):
        model = PipelinedTransformerLM(cfg)
    init = pipelined_init_fn(cfg)

    def init_fn(rng: torch.Generator) -> dict:
        return init(rng)[0]

    def embed_fn(embed_params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return functional_call(model.embed, embed_params, (tokens,))

    def head_loss_fn(head_params: dict, h: torch.Tensor,
                     tokens: torch.Tensor) -> tuple:
        return next_token_loss(
            functional_call(model.head, head_params, (h,)), tokens)

    return init_fn, embed_fn, model.block_fn, head_loss_fn
