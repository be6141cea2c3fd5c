"""Pipeline parallelism: GPipe-style microbatched stage execution.

The port of ``kubeflow_tpu/parallel/pipeline.py``, the engine behind
``ShardingSpec.pipeline > 1``. Layers are stacked: every block parameter
carries a leading ``layers`` dimension that the ``pipeline`` mesh axis
splits into contiguous stages (rule ``("layers", "pipeline")``), so each
rank holds its stage's ``L/S`` layers and nothing of the others'.

The JAX package runs the schedule as one ``lax.scan`` over ``M + S - 1``
ticks under a partial-manual ``shard_map``: at tick t stage s runs
microbatch t - s and hands its output to s + 1 by ``ppermute``; the
ticks outside a stage's window compute on zeros that never reach the
output. Here each rank runs only its ``M`` valid ticks, in microbatch
order: it receives microbatch k from s - 1, runs its layers, and sends
the result to s + 1, one point-to-point hop per tick
(``parallel/collectives.py`` ``ppermute``, tagged by microbatch and
direction; over gloo a CUDA tensor is staged through host memory). The
skipped ticks change no number, and a rank launches its layers'
kernels ``M·L/S`` times a forward.

The backward is autograd's, as the JAX package's is its transpose: each
hop's backward is the inverse hop (the received activation's gradient
goes back to its sender), and an order tensor threaded through the hops
makes every rank run them in reverse. The input is replicated over the
pipeline ranks, so its gradient is the sum over them (only stage 0's is
nonzero), taken once the hops are done. The last stage's outputs are
replicated to every pipeline rank in f32 (a broadcast; the JAX package's
``psum`` of the outputs masked to the last stage) and cast back, so the
head and the loss run the same on every rank; the replication's
backward hands each rank the cotangent it already holds, and only the
last stage's reaches a block.

On a mesh with a sequence axis (the JAX package's partial-manual
``shard_map`` over ``pipeline`` leaves ``sequence`` to GSPMD) ``x`` is
this rank's chunk, so a microbatch is ``[B/M, S/n, ...]``. Every
exchange here runs in the pipeline group of the rank's own sequence
coordinate (``mesh.group_of("pipeline")``): the hops, the output
broadcast and the input's gradient sum over the stages. The groups of
two coordinates share no rank, so their tags cannot meet; the blocks'
own exchanges over ``sequence`` (the gathered attention) run between
ranks of one stage, which run the same ticks in the same order.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import collectives

# block_fn(per_layer_params, activations) -> activations (same shape)
BlockFn = Callable[[dict, torch.Tensor], torch.Tensor]

PIPELINE_AXIS = "pipeline"


def apply_layers(block_fn: BlockFn, stacked_params: dict,
                 x: torch.Tensor) -> torch.Tensor:
    """``block_fn`` over the stacked layers in order (one stage). The
    layers are ``unbind``'s views: the backward stacks their gradients
    once a leaf, where indexing would fill a zero tensor of the whole
    stack for each layer."""
    layers = {k: v.unbind(0) for k, v in stacked_params.items()}
    for i in range(len(next(iter(layers.values())))):
        x = block_fn({k: v[i] for k, v in layers.items()}, x)
    return x


class _Replicate(torch.autograd.Function):
    """The last stage's f32 outputs broadcast to every pipeline rank;
    backward, each rank's own cotangent (identity)."""

    @staticmethod
    def forward(ctx, out, order, group, src):
        with collectives.phase("pipeline"):
            return collectives.broadcast_(out.clone(), group, src)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros((), device=g.device), None, None


def pipeline_apply(block_fn: BlockFn, stacked_params: dict, x: torch.Tensor,
                   *, mesh, num_microbatches: int,
                   num_layers: Optional[int] = None,
                   axis: str = PIPELINE_AXIS) -> torch.Tensor:
    """Apply the stacked blocks to ``x`` through the pipeline.

    Args:
      block_fn: applies ONE block: ``(layer_params, h) -> h`` (same shape).
      stacked_params: name -> leaf with a leading layers dimension: this
        rank's stage (its ``L/S`` contiguous layers: the leading
        dimension over the pipeline axis, as the train step's rules cut
        it) under a pipeline axis, every layer without one.
      x: activations ``[batch, ...]``; the batch must divide by
        ``num_microbatches``.
      mesh: ``parallel/mesh.py`` ``Mesh`` (None: no pipeline axis).
      num_microbatches: GPipe M; 1 runs the stages one after another.
      num_layers: the model's layer count, checked against the stages
        (default: the stage's layers times the stages).

    Returns activations of ``x``'s shape and dtype, the same on every
    pipeline rank."""
    n_stages = mesh.shape.get(axis, 1) if mesh is not None else 1
    if n_stages <= 1:
        return apply_layers(block_fn, stacked_params, x)
    batch = x.shape[0]
    if batch % num_microbatches:
        raise ValueError(
            f"batch {batch} not divisible by microbatches {num_microbatches}")
    local = next(iter(stacked_params.values())).shape[0]
    num_layers = local * n_stages if num_layers is None else num_layers
    if num_layers % n_stages or local * n_stages != num_layers:
        raise ValueError(
            f"{num_layers} layers not divisible by {n_stages} stages "
            f"into stages of {local}")
    group = mesh.group_of(axis)
    s = mesh.coords[axis]
    last = s == n_stages - 1
    mb = batch // num_microbatches
    dtype = x.dtype
    # the input is replicated over the pipeline: its gradient is the sum
    # over the stages, stage 0's the only nonzero term
    x = collectives.copy_to(x, group)
    order = collectives.start_order(x)
    feed = x.split(mb)
    like = feed[0]

    def hop(h_out, k: int):
        """Send microbatch k's output to s + 1 and receive microbatch
        k + 1 from s - 1, where each exists."""
        pairs = []
        if h_out is not None and not last:
            pairs.append((s, s + 1, 2 * k))
        if s > 0 and k + 1 < num_microbatches:
            pairs.append((s - 1, s, 2 * (k + 1)))
        if not pairs:
            return None
        nonlocal order
        with collectives.phase("pipeline"):
            got, order = collectives.ppermute(h_out, order, group, pairs,
                                              like)
        return got

    h_in = hop(None, -1)
    outs = []
    for k in range(num_microbatches):
        h = feed[k] if s == 0 else h_in
        h = apply_layers(block_fn, stacked_params, h)
        if last:
            outs.append(h)
        h_in = hop(h, k)
    collectives.wait_sends()
    if last:
        out = torch.cat(outs).float()
    else:
        out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    out = _Replicate.apply(out, order, group, n_stages - 1)
    return out.to(dtype)
