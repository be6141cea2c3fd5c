"""Ring attention: sequence-parallel attention over a ring of ranks.

The port of ``kubeflow_tpu/ops/ring_attention.py``, what the
``sequence`` axis of a ``ShardingSpec`` lowers to for
``attention="ring"``. The mesh's sequence axis splits Q, K and V along
their sequence dimension, a chunk of ``S_local`` positions a rank. Each
rank computes block attention of its Q chunk against the K/V chunk it
holds, then passes K/V one hop along the ring (rank i to i + 1); after
``n`` steps every Q chunk has met every K/V chunk, with O(S/n) live K/V.

- **Step 0 is the rank's own chunk**, and step s holds the chunk that
  started on rank ``i - s`` (:func:`ring_sources`). Under the causal
  mask every row's own chunk holds its diagonal, so the running max is
  finite after step 0: a chunk that is fully masked for the rank (one
  from a later rank) then adds exp(-1e30 - m) = 0. Were a fully masked
  chunk first, the max would stay at -1e30 and every p would be 1 until
  a later chunk's rescale erased them.
- **Global positions.** A score's row is ``i·S_local + r`` and its
  column ``src·S_local + c`` (:func:`chunk_scores`), masked to
  ``NEG_INF`` = -1e30 where the column is above the row.
- **The merge** is the online softmax in f32: the running max ``m``, sum
  ``l`` and output ``acc`` are rescaled by exp(m - m_new) at each step,
  so the result does not depend on the ring's order; at the end
  ``l = max(l, 1e-30)`` and the output is cast back to q's dtype.
- **Transport**: one ``parallel/collectives.py`` ``ppermute`` a step (K
  and V stacked into one tensor), n - 1 hops a call (the reference's
  last hop returns the chunks to where they started, and its result is
  unused). The hop's backward sends the cotangent the other way, so
  each rank's K and V get the gradient of every rank's rows; an order
  tensor from :func:`~kubeflow_tpu_torch.parallel.collectives.
  start_order` waits for the backward's sends.
- **Memory**: each step runs under ``torch.utils.checkpoint`` (the
  reference's ``jax.checkpoint``): the backward recomputes the step's
  [B, H, Sq, Sk] probabilities instead of keeping n of them.

The per-step blocks are plain PyTorch (f32 einsums), as the reference
computes them in plain ``jnp``: no Pallas kernel is on this path, and a
flash kernel with a query offset for them is a later speed step (ROADMAP
Queue 1 item 18). A ring of size 1 is the flash kernel itself (K1 and its
backward, ``ops/flash_attention.py``), as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel import collectives
from .flash_attention import flash_attention

NEG_INF = -1e30


def ring_sources(my_idx: int, n: int) -> list[int]:
    """The ring position each step's K/V chunk started on, for the rank
    at ``my_idx`` of a ring of ``n``: its own first, then one hop back
    per step (the chunks move from i to i + 1)."""
    return [(my_idx - s) % n for s in range(n)]


def chunk_scores(q: torch.Tensor, k: torch.Tensor, scale: float,
                 my_idx: int, src_idx: int, causal: bool) -> torch.Tensor:
    """Masked f32 scores of the local q chunk against the chunk that
    started at ring position ``src_idx``: [B,Sq,H,D] x [B,Sk,H,D] ->
    [B,H,Sq,Sk], by global row and column."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if not causal:
        return s
    sq, sk = q.shape[1], k.shape[1]
    rows = my_idx * sq + torch.arange(sq, device=q.device)[:, None]
    cols = src_idx * sk + torch.arange(sk, device=q.device)[None, :]
    return s.masked_fill(cols > rows, NEG_INF)


def ring_step(qf: torch.Tensor, kv: torch.Tensor, acc: torch.Tensor,
              m: torch.Tensor, l: torch.Tensor, my_idx: int, src_idx: int,
              causal: bool, scale: float) -> tuple:
    """One ring step: the f32 scores against the held chunk ``kv``
    ([2, B, Sk, H, D], K and V), then the online-softmax update of
    ``acc`` [B,Sq,H,D], ``m`` and ``l`` [B,H,Sq,1]."""
    s = chunk_scores(qf, kv[0].float(), scale, my_idx, src_idx, causal)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1, keepdim=True)
    acc = acc * alpha.permute(0, 2, 1, 3) + torch.einsum(
        "bhqk,bkhd->bqhd", p, kv[1].float())
    return acc, m_new, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis: str = "sequence", causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel attention. q, k, v: this rank's chunks [batch,
    S_local, heads, head_dim] of a sequence split over ``mesh``'s
    ``axis`` (``parallel/mesh.py`` ``Mesh``; None or an axis of size 1:
    the whole sequence, through the flash kernel). Returns this rank's
    chunk of the output in q's dtype, differentiable."""
    d = q.shape[-1]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    n = 1 if mesh is None else mesh.shape.get(axis, 1)
    if n <= 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    group = mesh.group_of(axis)
    my = mesh.coords[axis]
    b, sq, h, _ = q.shape
    qf = q.float()
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    kv = torch.stack((k, v))
    order = collectives.start_order(kv)
    for s, src in enumerate(ring_sources(my, n)):
        acc, m, l = checkpoint(ring_step, qf, kv, acc, m, l, my, src,
                               causal, scale, use_reentrant=False,
                               preserve_rng_state=False)
        if s + 1 < n:
            pairs = [(i, (i + 1) % n, 2 * s) for i in range(n)]
            kv, order = collectives.ppermute(kv, order, group, pairs, kv)
    collectives.wait_sends()
    l = torch.clamp(l, min=1e-30)
    return (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
