"""Device-side input prefetch: host batches staged on the card ``depth``
batches ahead of the consuming train step.

The port of ``kubeflow_tpu/data/device_prefetch.py``, with its contract:
depth-bounded (at most ``depth`` batches staged on the device, the only
extra device memory this holds), refill-first (the queue is topped up to
``depth`` BEFORE a batch is handed out, so every batch it returns had
its copy issued at least one call earlier: the lead that hides the
host→device copy under the step), ``close()`` drops the staged batches,
and consumed batches are handed off, never retained.

``jax.device_put`` is asynchronous by itself. A CUDA copy from pageable
host memory is not: CUDA stages it through a pinned buffer of its own and the
host waits. So on a CUDA device the prefetcher

- copies each host batch into a ring of ``depth + 1`` pinned host
  buffers, and refills a buffer only after the event of the copy that
  last read it has completed;
- calls ``place_fn`` on the pinned tensors inside a side
  ``torch.cuda.Stream``, so the copies (``non_blocking=True`` from
  pinned memory) overlap the step on the consumer's stream, and records
  one event per batch behind them;
- makes the consuming stream wait on that event when it hands the batch
  out, and calls ``record_stream`` on each of its device tensors: they
  were allocated on the side stream and are freed on the consumer's, and
  without it the caching allocator could give their memory to the next
  copy while the step still reads it.

A batch value that is not host memory (a CUDA tensor) raises: there is
nothing to stage. On a CPU device it is the plain queue around
``place_fn``. Each staged batch counts
``kftpu_input_batches_total{stage="device_put"}`` on the port's process
registry.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch


class _PinnedSlot:
    """One pinned host buffer per batch key, reallocated when a batch of
    another shape or dtype comes through (a short last batch)."""

    def __init__(self):
        self.bufs: dict[str, torch.Tensor] = {}
        self.event: Optional[torch.cuda.Event] = None

    def fill(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            if isinstance(v, torch.Tensor):
                if v.device.type != "cpu":
                    raise TypeError(
                        f"batch[{k!r}] lies on {v.device}: the prefetcher "
                        f"stages host batches only")
                src = v
            else:
                src = torch.from_numpy(np.ascontiguousarray(v))
            buf = self.bufs.get(k)
            if buf is None or buf.shape != src.shape or \
                    buf.dtype != src.dtype:
                buf = torch.empty(src.shape, dtype=src.dtype,
                                  pin_memory=True)
                self.bufs[k] = buf
            buf.copy_(src)
            out[k] = buf
        return out


class DevicePrefetcher:
    """Iterator of device-placed batches, ``depth`` ahead of the consumer.

    ``place_fn`` is typically ``TrainStepBuilder.place_batch``; whatever
    it returns is what the consumer sees. ``device`` is where it places:
    a CUDA device takes the staged path, anything else the plain
    queue."""

    def __init__(self, source: Iterable, place_fn: Callable[[Any], Any],
                 depth: int = 2, device: Any = "cpu"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._it = iter(source)
        self._place = place_fn
        self.depth = int(depth)
        self._buf: deque = deque()
        self._exhausted = False
        self.device = torch.device(device)
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._slots = [_PinnedSlot() for _ in range(self.depth + 1)]
            self._next_slot = 0
        # staging rate for the process registry: one inc per staged
        # batch (handle resolved once — _fill is per-batch)
        from ..obs import registry as obsreg
        self._obs_batches = obsreg.counter(
            "kftpu_input_batches_total",
            "batches delivered by each input-pipeline stage",
            labels=("stage",)).labels(stage="device_put")

    @property
    def in_flight(self) -> int:
        """Batches currently staged on device (≤ depth — the memory
        bound)."""
        return len(self._buf)

    def _stage(self, item) -> tuple:
        if self._stream is None:
            return self._place(item), None
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        if slot.event is not None:
            slot.event.synchronize()   # its last copy has read the buffer
        host = slot.fill(item)
        with torch.cuda.stream(self._stream):
            batch = self._place(host)
            event = torch.cuda.Event()
            event.record(self._stream)
        slot.event = event
        return batch, event

    def _fill(self) -> None:
        while not self._exhausted and len(self._buf) < self.depth:
            try:
                item = next(self._it)
            except StopIteration:
                self._exhausted = True
                return
            self._buf.append(self._stage(item))
            self._obs_batches.inc()

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Any:
        # fill-then-pop: topping up BEFORE yielding guarantees the
        # returned batch was staged at least one call earlier
        self._fill()
        if not self._buf:
            raise StopIteration
        batch, event = self._buf.popleft()
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in batch.values():
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    t.record_stream(consumer)
        return batch

    def close(self) -> None:
        """Drop the staged batches (releases their device memory) and
        stop pulling from the source — which its owner closes; an
        early-stopped run must not leave ``depth`` batches on the card or
        a producer feeding a dead consumer."""
        self._buf.clear()
        self._exhausted = True
