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
- ``bytes_moved[op]`` counts the bytes each op's calls handed over
  (the input's bytes; a receive's, the message's).
- ``record_events(True)`` brackets each call on a CUDA tensor with CUDA
  events (staging included) until ``record_events(False)``;
  ``events_ms()`` sums their device time by op.
- ``recording()`` keeps, while it is open, one entry per call: the op,
  its bytes, the group's global ranks, the peer of a send or receive and
  the phase (``phase()``: "model" unless the caller names "update" or
  "pipeline"); obs/collectives.py builds the step's comm profile from
  it. Closed, a call pays one ``is None`` test.

``global_sum`` is the differentiable cross-rank sum: the forward
all-reduces its input and the backward all-reduces the gradient, so a
loss written over the rank's rows that takes a statistic over the global
batch (a BatchNorm's sums, a global mean) gets the gradient of the
global-batch function.

``once_over`` enters a term that every rank of a group computes alike
(ResNet's loss on a sequence mesh, the MoE aux loss over the global
batch) once into the objective the train step sums over the group: the
identity forward, the gradient divided by the group's size backward.

The model-parallel step's differentiable exchanges (Megatron's
operators; each is the identity over a None group):

- ``copy_to``: identity forward, the gradient all-reduced backward (the
  input of a product whose weight is split over the group);
- ``reduce_from``: the partial sums all-reduced forward, identity
  backward (the output of a row-parallel product);
- ``gather_from``: the ranks' blocks concatenated along a dimension
  forward, this rank's block of the gradient backward (column-parallel
  logits);
- ``gather_shards``: the same forward, the gradient reduce-scattered
  backward (an fsdp-sharded param, gathered for its use: each rank's
  block gets the sum of the ranks' gradients).

Sums of a floating tensor narrower than f32 run in f32 and round once.

Point to point (the pipeline's stage hops, ``parallel/pipeline.py``):
``send`` starts a tagged send and returns at once (``wait_sends`` waits
for every send started), ``recv`` blocks for a tagged message; a gloo
group stages a CUDA tensor through host memory both ways, counted like
the collectives. ``ppermute`` is the differentiable hop: this rank sends
along the pairs it is the source of and returns what arrives along the
pair it is the destination of; its backward is the inverse permutation
(each tag's direction bit flipped), so the gradient of a received
activation goes back to its sender and the sender's input receives its
gradient. A 0-d ``order`` tensor threads through consecutive hops so
that autograd runs their backwards in reverse order on every rank, and
reaches every hop, one that only sends included.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

OPS = ("all_reduce", "reduce_scatter", "all_gather", "broadcast", "send",
       "recv")
calls = dict.fromkeys(OPS, 0)
host_staged = dict.fromkeys(OPS, 0)
bytes_moved = dict.fromkeys(OPS, 0)
_events: list = []          # (op, start event, end event)
_recording = False
_sends: list = []           # (work, the tensor it sends) until waited
# the step's phases (obs/collectives.py's PHASE_* vocabulary)
PHASES = ("model", "update", "pipeline")
_phase = "model"
_record: Optional[list] = None    # CallRecord entries while recording


@dataclass
class CallRecord:
    """One collective call: ``op`` (of OPS), ``nbytes`` (as
    ``bytes_moved`` counts it) and the shape of the tensor handed over,
    the global ranks of its group in group order, this process's global
    rank, the peer's global rank for a send or receive, and the phase it
    ran in."""

    op: str
    nbytes: int
    shape: tuple
    ranks: tuple
    rank: int
    peer: Optional[int]
    phase: str


@dataclass
class Recording:
    """What :func:`recording` saw: each call, how the counters moved
    (``calls``, ``bytes``, ``host_staged`` by op) over the same span and,
    when asked, the CUDA-event ms of its calls by op."""

    entries: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)
    events_ms: dict = field(default_factory=dict)


@contextlib.contextmanager
def phase(name: str):
    """Attribute the collectives called inside to ``name`` (one of
    PHASES)."""
    global _phase
    if name not in PHASES:
        raise ValueError(f"phase {name!r} not one of {PHASES}")
    prev, _phase = _phase, name
    try:
        yield
    finally:
        _phase = prev


@contextlib.contextmanager
def recording(events: bool = False):
    """Record every call made inside (one :class:`CallRecord` each) into
    the yielded :class:`Recording`, with the counters' movement; with
    ``events`` also the calls' CUDA-event ms (synchronizing on the last
    event at the exit), leaving :func:`record_events`' own state as it
    was."""
    global _record, _recording
    rec = Recording()
    before = (dict(calls), dict(bytes_moved), dict(host_staged))
    prev, _record = _record, rec.entries
    was_on, n0 = _recording, len(_events)
    _recording = was_on or events
    try:
        yield rec
    finally:
        _record = prev
        _recording = was_on
        rec.counts = {
            key: {op: now[op] - was[op] for op in OPS}
            for key, now, was in zip(
                ("calls", "bytes", "host_staged"),
                (calls, bytes_moved, host_staged), before)}
        if events:
            rec.events_ms = dict.fromkeys(OPS, 0.0)
            for op, start, end in _events[n0:]:
                end.synchronize()
                rec.events_ms[op] += start.elapsed_time(end)
            if not was_on:
                del _events[n0:]


def _note(op: str, t: torch.Tensor, group: Any,
          peer: Optional[int] = None) -> None:
    if _record is not None:
        _record.append(CallRecord(
            op=op, nbytes=t.numel() * t.element_size(),
            shape=tuple(t.shape),
            ranks=tuple(dist.get_process_group_ranks(group)),
            rank=dist.get_rank(), peer=peer, phase=_phase))


def reset_counts() -> None:
    for op in OPS:
        calls[op] = 0
        host_staged[op] = 0
        bytes_moved[op] = 0


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
    bytes_moved[op] += t.numel() * t.element_size()
    _note(op, t, group)
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


def send(t: torch.Tensor, dst: int, group: Any, tag: int) -> None:
    """Start sending ``t`` to group rank ``dst`` under ``tag`` and return
    at once; the send (and the tensor it holds) lives until
    :func:`wait_sends`."""
    x = t.detach().contiguous()
    calls["send"] += 1
    bytes_moved["send"] += x.numel() * x.element_size()
    _note("send", x, group, dist.get_global_rank(group, dst))
    if host_staging(x, group):
        host_staged["send"] += 1
        x = x.cpu()
    work = dist.isend(x, dist.get_global_rank(group, dst), group=group,
                      tag=tag)
    _sends.append((work, x))


def recv(like: torch.Tensor, src: int, group: Any, tag: int
         ) -> torch.Tensor:
    """The message from group rank ``src`` under ``tag``: a new tensor of
    ``like``'s shape, dtype and device (blocks until it arrives)."""
    calls["recv"] += 1
    bytes_moved["recv"] += like.numel() * like.element_size()
    _note("recv", like, group, dist.get_global_rank(group, src))
    staged = host_staging(like, group)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if staged else like.device)
    if staged:
        host_staged["recv"] += 1
    dist.recv(buf, dist.get_global_rank(group, src), group=group, tag=tag)
    return buf.to(like.device) if staged else buf


def wait_sends() -> None:
    """Wait for every send started (each completes when its destination
    has received it)."""
    while _sends:
        work, _ = _sends.pop(0)
        work.wait()


def _exchange(x, group: Any, pairs, like: torch.Tensor):
    """Send ``x`` along each ``(src, dst, tag)`` whose src is this rank,
    then receive along the one whose dst is this rank (a tensor like
    ``like``; None when there is none)."""
    me = dist.get_rank(group)
    for src, dst, tag in pairs:
        if src == me:
            send(x, dst, group, tag)
    got = None
    for src, dst, tag in pairs:
        if dst == me:
            got = recv(like, src, group, tag)
    return got


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, order, group, pairs, like):
        ctx.group, ctx.pairs, ctx.phase = group, pairs, _phase
        ctx.x = None if x is None else (x.shape, x.dtype, x.device)
        y = _exchange(x, group, pairs, like)
        ctx.y = None if y is None else (y.shape, y.dtype, y.device)
        return y, order.new_zeros(())

    @staticmethod
    def backward(ctx, gy, gorder):
        inverse = [(dst, src, tag ^ 1) for src, dst, tag in ctx.pairs]
        if ctx.y is not None and gy is None:
            shape, dtype, device = ctx.y
            gy = torch.zeros(shape, dtype=dtype, device=device)
        like = None
        if ctx.x is not None:
            shape, dtype, device = ctx.x
            like = torch.empty(shape, dtype=dtype, device=device)
        with phase(ctx.phase):     # the forward hop's
            gx = _exchange(gy, ctx.group, inverse, like)
        return gx, gorder, None, None, None


class _Order(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        wait_sends()
        return None


def start_order(x: torch.Tensor) -> torch.Tensor:
    """The first order tensor of a chain of hops, from their input
    ``x``: its backward runs after every hop's, and waits there for
    this rank's sends."""
    return _Order.apply(x)


def ppermute(x, order: torch.Tensor, group: Any, pairs, like: torch.Tensor
             ) -> tuple:
    """The differentiable point-to-point hop over ``group``: this rank
    sends ``x`` along each ``(src, dst, tag)`` of ``pairs`` whose src it
    is (tags even: bit 0 is the direction, set on the way back) and
    returns ``(what arrives along the pair whose dst it is, a tensor like
    like, or None; the next order tensor)``. The backward is the inverse
    permutation: the received tensor's gradient goes back to its source
    and ``x`` gets the gradient its destination sends. Pass the previous
    hop's order tensor (the first from anything in the graph): autograd
    then runs the hops' backwards in reverse order and reaches each."""
    return _PPermute.apply(x, order, group, tuple(pairs), like)


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


class _OnceOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def once_over(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``x``, the same on every rank of ``group``, counted once in a
    gradient that is summed over the group: identity forward, the
    gradient divided by the group's size backward; ``x`` itself when
    ``group`` is None."""
    return x if group is None else _OnceOver.apply(
        x, dist.get_world_size(group))


def _sum_(t: torch.Tensor, group: Any) -> torch.Tensor:
    """All-reduce ``t`` (a new tensor of t's dtype), in f32 for a
    narrower floating dtype."""
    if t.is_floating_point() and t.element_size() < 4:
        return all_reduce_(t.float(), group).to(t.dtype)
    return all_reduce_(t.clone(memory_format=torch.contiguous_format),
                       group)


def _gather_dim(t: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    return all_gather(t.movedim(dim, 0), group).movedim(0, dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.movedim(ctx.dim, 0)
        dt = g.dtype
        if g.is_floating_point() and g.element_size() < 4:
            g = g.float()
        out = reduce_scatter(g, ctx.group).movedim(0, ctx.dim)
        return out.to(dt), None, None


def copy_to(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum over ``group`` forward; identity backward."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order
    forward; this rank's block of the gradient backward."""
    return x if group is None else _GatherFrom.apply(x, group, dim)


def gather_shards(x: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` forward; the gradient
    reduce-scattered (summed, this rank's block) backward."""
    return x if group is None else _GatherShards.apply(x, group, dim)
