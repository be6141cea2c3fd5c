"""The collectives of the data-parallel step, on any backend.

Every cross-rank exchange of the port goes through these functions: the
gradient all-reduce or reduce-scatter, the all-gather of the new params,
the cross-rank sums of the global norm, of LARS's per-tensor norms and of
the BatchNorm statistics, the broadcast of the initial state. ``group``
is a ``torch.distributed`` process group (``parallel/mesh.py``
``Mesh.group``); a collective over None is not called by the port (one
process has nothing to exchange).

- NCCL takes CUDA tensors as they are. A **gloo** group given a CUDA
  tensor (ranks that share one card, where NCCL refuses a second rank)
  stages it through host memory: a synchronous copy out, the collective
  on the host copy, a copy back. Each such call counts in
  ``host_staged[op]``; ``calls[op]`` counts every call. An NCCL group
  never stages.
- A failed collective raises; nothing retries or falls back.
- ``record_events(True)`` brackets each call on a CUDA tensor with CUDA
  events (staging included) until ``record_events(False)``;
  ``events_ms()`` sums their device time by op.

``global_sum`` is the differentiable cross-rank sum: the forward
all-reduces its input and the backward all-reduces the gradient, so a
loss written over the rank's rows that takes a statistic over the global
batch (a BatchNorm's sums, a global mean) gets the gradient of the
global-batch function.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

OPS = ("all_reduce", "reduce_scatter", "all_gather", "broadcast")
calls = dict.fromkeys(OPS, 0)
host_staged = dict.fromkeys(OPS, 0)
_events: list = []          # (op, start event, end event)
_recording = False


def reset_counts() -> None:
    for op in OPS:
        calls[op] = 0
        host_staged[op] = 0


def record_events(on: bool) -> None:
    """Start recording CUDA event pairs around each collective on a CUDA
    tensor (clearing what was recorded), or stop (keeping it)."""
    global _recording
    if on:
        _events.clear()
    _recording = on


def events_ms() -> dict:
    """Device milliseconds of the recorded collectives, summed by op
    (synchronizes on the last event)."""
    out = dict.fromkeys(OPS, 0.0)
    for op, start, end in _events:
        end.synchronize()
        out[op] += start.elapsed_time(end)
    return out


def host_staging(t: torch.Tensor, group: Any) -> bool:
    """Whether a collective on ``t`` over ``group`` stages through host
    memory: a CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _run(op: str, t: torch.Tensor, group: Any,
         fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``fn`` on ``t`` (or its host copy), counted, timed when recording;
    returns fn's result on t's device."""
    calls[op] += 1
    timed = _recording and t.is_cuda
    if timed:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    if host_staging(t, group):
        host_staged[op] += 1
        out = fn(t.detach().cpu()).to(t.device)
    else:
        out = fn(t)
    if timed:
        end.record()
        _events.append((op, start, end))
    return out


def all_reduce_(t: torch.Tensor, group: Any) -> torch.Tensor:
    """Sum over the ranks, in place; returns ``t``."""
    def fn(x):
        dist.all_reduce(x, group=group)
        return x

    out = _run("all_reduce", t, group, fn)
    if out is not t:
        t.copy_(out)
    return t


def reduce_scatter(t: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum over the ranks of ``t`` [n·b, ...], block ``rank`` of its
    first dimension: [b, ...] (``psum_scatter(..., tiled=True)``)."""
    n = dist.get_world_size(group)
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter of dim 0 = {t.shape[0]} over "
                         f"{n} ranks")
    t = t.contiguous()

    def fn(x):
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=group)
        return out

    return _run("reduce_scatter", t, group, fn)


def all_gather(t: torch.Tensor, group: Any) -> torch.Tensor:
    """Every rank's ``t`` [b, ...] concatenated in rank order: [n·b, ...]."""
    n = dist.get_world_size(group)
    t = t.contiguous()

    def fn(x):
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    return _run("all_gather", t, group, fn)


def broadcast_(t: torch.Tensor, group: Any, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s contiguous ``t`` on every rank, in place; returns
    ``t``."""
    def fn(x):
        dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
        return x

    out = _run("broadcast", t, group, fn)
    if out is not t:
        t.copy_(out)
    return t


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(
            torch.clone(x, memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(torch.clone(
            g, memory_format=torch.contiguous_format), ctx.group), None


def global_sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable (the
    gradient of each rank's input is the sum of the ranks' output
    gradients); ``x`` itself when ``group`` is None."""
    return x if group is None else _GlobalSum.apply(x, group)
