"""Mixture-of-experts MLP, the port of ``kubeflow_tpu/models/moe.py``.

The GShard / Switch formulation as the JAX package writes it, with every
numeric choice kept:

- the router runs in f32 on ``x`` cast to f32 and picks top-k experts per
  token (``argmax`` ties take the first index), under a capacity of
  ``max(1, ceil(K·S·cf/E))`` tokens per expert and batch row;
- in GShard order each k-th choice queues behind all (k−1)-th choices,
  counted per batch row; a token past capacity is dropped (its combine
  weight is zero; the residual carries it);
- for K > 1 the surviving gates are renormalised where their sum is > 0;
  for K == 1 the raw probability is kept, so the router gets a gradient
  from the task loss;
- ``dispatch = (combine > 0)`` and ``combine`` (cast after the
  renormalisation) in the activation dtype; the expert FFN uses the tanh
  gelu;
- the Switch auxiliary loss ``weight · E · Σ f·P``, ``f`` from the top-1
  index (no gradient through it), ``P`` the mean router probability.

Dispatch and combine are the JAX package's einsums over ``[B, S, E, C]``
one-hot tensors (plain products outside any kernel). Every one-hot is
built by comparison (:func:`_one_hot`), as ``jax.nn.one_hot`` is: an
overflowed position gives an all-zero row where
``torch.nn.functional.one_hot`` would raise, and no host sync breaks a
CUDA graph capture of the step.

Under a mesh (``mesh``, parallel/mesh.py) each rank holds the experts of
its ``expert`` coordinate (``wi``/``wo`` blocks along dim 0) and their
``mlp`` columns of its ``tensor`` coordinate; the router is replicated.
Routing runs whole on every rank; each rank computes its experts' share
of the output and the partial sums are all-reduced over ``("expert",
"tensor")``; the combine weights and the expert input take that group's
gradient sum in the backward, so the router's and ``x``'s gradients are
whole and equal on every rank of it. The aux loss's ``f`` and ``P`` are
taken over the global batch (sums over the replica axes and the sequence
axis), as GSPMD computes the JAX function.

On a sequence mesh ``x`` is this rank's chunk of ``S/n`` positions, and
it routes exactly as the whole sequence routes in the JAX function:

- the capacity comes from the whole sequence's length, ``n·S/n``;
- one all-gather a layer of every chunk's per-row, per-level, per-expert
  choice counts (``[K, B, E]`` int32) gives each level's positions their
  start after the same rows' choices on the earlier chunks, and the
  queue of level j its start after every level-<j choice of the whole
  sequence;
- each token takes its own slot, so the expert products need no
  exchange over the axis: a chunk's ``[E, B, C, M]`` expert input holds
  its own tokens' slots, the others' zero.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel import collectives


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: row i is 1 at ``idx[i]``, all zero where
    ``idx`` is outside ``[0, n)``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k_mask(gates: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token top-k expert assignment, one level at a time: (indices
    [k, B, S], gate values [k, B, S])."""
    idxs, vals = [], []
    masked = gates
    for _ in range(k):
        idx = masked.argmax(-1)
        val = masked.gather(-1, idx[..., None])[..., 0]
        idxs.append(idx)
        vals.append(val)
        masked = masked * (1.0 - _one_hot(idx, gates.shape[-1],
                                          gates.dtype))
    return torch.stack(idxs), torch.stack(vals)


def load_balancing_loss(router_probs: torch.Tensor,
                        expert_index: torch.Tensor,
                        group: Any = None) -> torch.Tensor:
    """Switch-Transformer auxiliary loss: E · Σ_e f_e · P_e, in f32.
    f_e = share of tokens whose top-1 choice is e, P_e = mean router
    probability on e; over the global batch when ``group`` (the replica
    axes and the sequence axis) splits its tokens."""
    e = router_probs.shape[-1]
    oh = _one_hot(expert_index, e, torch.float32)
    probs = router_probs.float()
    if group is None:
        f, p = oh.mean((0, 1)), probs.mean((0, 1))
    else:
        # every rank holds the same number of rows and positions
        n = oh.shape[0] * oh.shape[1] * dist.get_world_size(group)
        f = collectives.global_sum(oh.sum((0, 1)), group) / n
        p = collectives.global_sum(probs.sum((0, 1)), group) / n
    return e * torch.sum(f * p)


class MoEMLP(nn.Module):
    """Drop-in replacement for the dense MLP block: ``x [B, S, M] ->
    (out [B, S, M], weighted aux loss)``. Params in flax's shapes:
    ``router`` [M, E], ``wi`` [E, M, H], ``wo`` [E, H, M], f32."""

    def __init__(self, num_experts: int, embed_dim: int, mlp_dim: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 aux_loss_weight: float = 0.01,
                 dtype: torch.dtype = torch.bfloat16, mesh=None):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.dtype = dtype
        self.mesh = mesh
        e, m, h = num_experts, embed_dim, mlp_dim
        self.router = nn.Parameter(torch.empty(m, e))
        self.wi = nn.Parameter(torch.empty(e, m, h))
        self.wo = nn.Parameter(torch.empty(e, h, m))

    def _groups(self) -> tuple[Any, Any, Any]:
        """(the combine's partial-sum group, the aux statistics' group:
        the replica axes and the sequence axis, the sequence group)."""
        m = self.mesh
        if m is None:
            return None, None, None
        return (m.group_of(("expert", "tensor")),
                m.group_of(("data", "fsdp", "sequence")),
                m.group_of("sequence"))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor,
                                                 torch.Tensor]:
        b, s, _ = x.shape
        e, k = self.num_experts, self.top_k
        if not 1 <= k <= e:
            raise ValueError(f"top_k={k} must be in [1, num_experts={e}]")
        part, stats, seq = self._groups()
        # the whole sequence's length: a chunk's capacity is the JAX
        # function's
        s_all = s * (1 if seq is None else dist.get_world_size(seq))
        capacity = max(1, int(math.ceil(k * s_all * self.capacity_factor
                                        / e)))
        dt = self.dtype

        # the router in f32: a small product, numerically load-bearing
        logits = torch.einsum("bsm,me->bse", x.float(), self.router)
        probs = torch.softmax(logits, dim=-1)
        idx, gate = _top_k_mask(probs, k)                     # [K, B, S]
        aux = self.aux_loss_weight * load_balancing_loss(probs, idx[0],
                                                         stats)

        # capacity: k-th choices queue behind all (k-1)-th choices, the
        # position a running count per expert along each batch row
        onehots = _one_hot(idx, e, torch.int32)               # [K,B,S,E]
        counts = onehots.sum(2, dtype=torch.int32)[None]      # [1,K,B,E]
        if seq is not None:
            # every chunk's counts, in sequence order: [n, K, B, E]
            counts = collectives.all_gather(counts, seq)
        # each level's choices on the earlier chunks, and on all of them
        coord = 0 if seq is None else self.mesh.coords["sequence"]
        before = counts[:coord].sum(0)                        # [K, B, E]
        total = counts.sum(0)
        prev = torch.zeros((b, 1, e), dtype=torch.int32, device=x.device)
        gate_sum = torch.zeros((b, s), device=x.device)
        combine: Optional[torch.Tensor] = None
        for j in range(k):
            oh = onehots[j]                                   # [B, S, E]
            pos = torch.cumsum(oh, dim=1) - oh + prev + before[j][:, None]
            prev = prev + total[j][:, None]
            pos_tok = (pos * oh).sum(-1)                      # [B, S]
            keep = (pos_tok < capacity).float()
            g = gate[j] * keep
            gate_sum = gate_sum + g
            # an overflowed position is an all-zero row
            cap_oh = _one_hot(pos_tok, capacity, torch.float32)  # [B,S,C]
            layer = g[..., None, None] * oh.float()[..., None] \
                * cap_oh[:, :, None, :]                       # [B,S,E,C]
            combine = layer if combine is None else combine + layer
        if k > 1:
            # surviving gates renormalised to sum 1 per token; for k == 1
            # the raw probability stays (Switch): a renormalised top-1
            # gate is 1.0 and gives the router no task gradient
            denom = torch.where(gate_sum > 0, gate_sum,
                                torch.ones_like(gate_sum))
            combine = combine / denom[..., None, None]
        dispatch = (combine > 0).to(dt)
        combine = combine.to(dt)

        # this rank's experts; their gradient summed over the group
        el = self.wi.shape[0]
        lo = 0 if self.mesh is None else self.mesh.coords["expert"] * el
        combine = collectives.copy_to(combine, part)[:, :, lo:lo + el]
        dispatch = dispatch[:, :, lo:lo + el]
        xd = collectives.copy_to(x.to(dt), part)
        expert_in = torch.einsum("bsec,bsm->ebcm", dispatch, xd)
        h = F.gelu(torch.einsum("ebcm,emh->ebch", expert_in,
                                self.wi.to(dt)), approximate="tanh")
        expert_out = torch.einsum("ebch,ehm->ebcm", h, self.wo.to(dt))
        out = torch.einsum("bsec,ebcm->bsm", combine, expert_out)
        return collectives.reduce_from(out, part), aux
