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
``torch.Generator``) and ``workload_spec`` for runtime/worker.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..ops.flash_attention import flash_attention

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
    # "einsum" (plain PyTorch) or "flash" (the CUDA kernel,
    # ops/flash_attention); "ring" is a later slice
    attention: str = "einsum"
    num_experts: int = 0

    def __post_init__(self):
        valid = ("einsum", "flash", "ring")
        if self.attention not in valid:
            raise ValueError(
                f"attention={self.attention!r} not in {valid}")
        if self.attention == "ring":
            raise NotImplementedError(
                "attention='ring' (ops/ring_attention.py) is not yet ported")
        if self.num_experts > 0:
            raise NotImplementedError(
                "mixture-of-experts (num_experts > 0, models/moe.py) is not "
                "yet ported")

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


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        e, h, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim
        self.qkv = _Kernel(e, 3, h, d)
        self.out = _Kernel(h, d, e)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        qkv = torch.einsum("bse,ethd->bsthd", x.to(dt),
                           self.qkv.kernel.to(dt))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cfg.attention == "flash":
            out = flash_attention(q, k, v, causal=True)
        else:
            s = q.shape[1]
            q = q / torch.tensor(math.sqrt(cfg.head_dim), dtype=dt)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
            mask = torch.ones((s, s), dtype=torch.bool,
                              device=x.device).tril()
            logits = logits.masked_fill(~mask, torch.finfo(dt).min)
            probs = torch.softmax(logits.float(), dim=-1).to(dt)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return torch.einsum("bshd,hde->bse", out, self.out.kernel.to(dt))


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.wi = _Kernel(cfg.embed_dim, cfg.mlp_dim)
        self.wo = _Kernel(cfg.mlp_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        h = x.to(dt) @ self.wi.kernel.to(dt)
        h = F.gelu(h, approximate="tanh")   # flax nn.gelu's default
        return h @ self.wo.kernel.to(dt)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = LayerNorm(cfg.embed_dim)
        self.attn = Attention(cfg)
        self.ln2 = LayerNorm(cfg.embed_dim)
        self.mlp = MLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class TransformerLM(nn.Module):
    """tokens [B, S] int → logits [B, S, V] f32."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = _Embed(cfg.vocab_size, cfg.embed_dim)
        self.pos_embed = _Embed(cfg.max_seq_len, cfg.embed_dim)
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", Block(cfg))
        self.ln_f = LayerNorm(cfg.embed_dim)
        self.head = _Kernel(cfg.embed_dim, cfg.vocab_size)

    def blocks(self) -> list[Block]:
        return [getattr(self, f"layer{i}")
                for i in range(self.cfg.num_layers)]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = F.embedding(tokens.long(), self.tok_embed.embedding).to(dt)
        pos = self.pos_embed.embedding[:tokens.shape[1]].to(dt)
        x = x + pos[None]
        for block in self.blocks():
            x = block(x)
        return self.ln_f(x) @ self.head.kernel

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
            else:                                      # [in, ...]
                fan_in = p.shape[0]
            std = 1.0 / math.sqrt(fan_in)
            t = torch.empty(p.shape, dtype=torch.float32)
            nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            p.copy_(t)
        return self


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> tuple:
    """Next-token loss with full-length input and shift-left targets
    (``roll(-1)``); the final position has no target and is masked out,
    so the loss is the mean over B·(S−1) positions. Returns (loss,
    {"perplexity": exp(loss)})."""
    b, s, v = logits.shape
    targets = torch.roll(tokens, -1, dims=1).long()
    nll = F.cross_entropy(logits.reshape(b * s, v), targets.reshape(b * s),
                          reduction="none").view(b, s)
    loss = nll[:, :-1].sum() / (b * (s - 1))
    return loss, {"perplexity": torch.exp(loss)}


def make_loss_fn(model: TransformerLM) -> Callable:
    """``loss_fn(params, variables, batch, rng) -> (loss, aux)`` over a
    params dict keyed like the model's state dict."""

    def loss_fn(params, variables, batch, rng):
        tokens = batch["tokens"]
        logits = functional_call(model, params, (tokens,))
        return next_token_loss(logits, tokens)

    return loss_fn


def make_eval_fn(model: TransformerLM) -> Callable:
    """Held-out eval: next-token loss / perplexity / token accuracy."""

    def eval_fn(params, variables, batch):
        tokens = batch["tokens"]
        logits = functional_call(model, params, (tokens,))
        loss, _ = next_token_loss(logits, tokens)
        preds = logits[:, :-1].argmax(-1)
        return {"eval_loss": loss,
                "eval_perplexity": torch.exp(loss),
                "eval_token_accuracy":
                    (preds == tokens[:, 1:].long()).float().mean()}

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


def workload_spec(cfg: Optional[TransformerConfig] = None,
                  seq_len: Optional[int] = None):
    """WorkloadSpec factory for runtime.worker. The sharding annotations
    (``rules``, ``param_logical_axes``) stay None until sharding is
    ported (ROADMAP Queue 1 item 3)."""
    from ..runtime.worker import WorkloadSpec
    cfg = cfg or TransformerConfig.tiny()
    seq_len = seq_len or cfg.max_seq_len
    # the module without storage: the loss and eval functions take their
    # parameters from a params dict (functional_call)
    with torch.device("meta"):
        model = TransformerLM(cfg)
    return WorkloadSpec(
        name="transformer",
        init_fn=init_fn(model),
        loss_fn=make_loss_fn(model),
        batch_fn=lambda rng, bs: synthetic_batch(rng, bs, seq_len,
                                                 cfg.vocab_size),
        eval_fn=make_eval_fn(model),
    )
