"""Pure-Python record pipeline (fallback + reference semantics).

The port's copy of ``kubeflow_tpu/data/pipeline.py``. Same contract as the native core (native/datapipe/datapipe.cc): fixed-size
records across shard files, seeded splitmix64 Fisher-Yates epoch shuffle,
threaded prefetch of whole batches, in-order delivery. The native core is
the production path; this one is the portable fallback and the executable
spec the native core is tested against (identical record order per seed).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

_MASK = (1 << 64) - 1


def _splitmix64(state: int) -> tuple[int, int]:
    state = (state + 0x9E3779B97F4A7C15) & _MASK
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31), state


def epoch_order(n: int, seed: int) -> np.ndarray:
    """The epoch's record permutation — bit-identical to the native core."""
    order = np.arange(n, dtype=np.int64)
    state = seed & _MASK
    for i in range(n - 1, 0, -1):
        r, state = _splitmix64(state)
        j = r % (i + 1)
        order[i], order[j] = order[j], order[i]
    return order


class PyRecordPipeline:
    """Threaded prefetching reader over fixed-size record shard files."""

    impl = "py"

    def __init__(self, paths: Sequence[str], record_bytes: int,
                 batch_records: int, *, queue_depth: int = 4,
                 seed: int = 0, drop_remainder: bool = True,
                 num_threads: int = 1):
        if record_bytes <= 0 or batch_records <= 0:
            raise ValueError("record_bytes and batch_records must be > 0")
        if not paths:
            raise ValueError("at least one shard file required")
        self.paths = list(paths)
        self.record_bytes = record_bytes
        self.batch_records = batch_records
        self.queue_depth = max(2, queue_depth)
        self.drop_remainder = drop_remainder
        self.num_threads = max(1, num_threads)  # parity with native arg

        self._spans: list[tuple[str, int, int]] = []  # path, first, records
        cursor = 0
        for p in self.paths:
            size = os.path.getsize(p)
            records = size // record_bytes
            self._spans.append((p, cursor, records))
            cursor += records
        self.total_records = cursor
        self._files = {p: open(p, "rb") for p in self.paths}
        self._file_lock = threading.Lock()
        self._epoch_state: Optional[tuple] = None
        self.reset(seed)

    @property
    def num_batches(self) -> int:
        if self.drop_remainder:
            return self.total_records // self.batch_records
        return -(-self.total_records // self.batch_records)

    def reset(self, seed: int) -> None:
        """New epoch: reshuffle and restart the prefetcher."""
        self._stop_prefetch()
        self.order = epoch_order(self.total_records, seed)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        self._stop = threading.Event()
        # producer outcome tracked outside the queue (the queued EOF /
        # exception can be lost to a stop-side drain): a consumer facing
        # a dead thread must distinguish clean EOF from a mid-epoch death
        # — and must never block forever on an empty queue
        self._finished = False
        self._error: "Exception | None" = None
        self._thread = threading.Thread(target=self._producer, daemon=True,
                                        name="py-datapipe")
        self._thread.start()

    def _stop_prefetch(self) -> None:
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)

    def _read_record(self, global_idx: int, out: memoryview) -> None:
        for path, first, records in self._spans:
            if first <= global_idx < first + records:
                with self._file_lock:
                    f = self._files[path]
                    f.seek((global_idx - first) * self.record_bytes)
                    data = f.read(self.record_bytes)
                out[:] = data
                return
        raise IndexError(f"record {global_idx} out of range")

    def _producer(self) -> None:
        try:
            for b in range(self.num_batches):
                if self._stop.is_set():
                    return
                start = b * self.batch_records
                end = min(start + self.batch_records, self.total_records)
                buf = np.empty(((end - start) * self.record_bytes,), np.uint8)
                view = memoryview(buf)
                for i, idx in enumerate(self.order[start:end]):
                    self._read_record(
                        int(idx),
                        view[i * self.record_bytes:(i + 1) * self.record_bytes])
                while not self._stop.is_set():
                    try:
                        self._q.put(buf, timeout=0.1)
                        break
                    except queue.Full:
                        continue
            self._finished = True
            if not self._stop.is_set():
                self._q.put(None)  # EOF
        except Exception as e:  # noqa: BLE001 - surfaced to the consumer
            self._error = e
            self._q.put(e)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            try:
                item = self._q.get(timeout=0.5)
            except queue.Empty:
                if not self._thread.is_alive():
                    if self._error is not None:
                        raise self._error   # queued copy lost to a drain
                    if not self._finished and not self._stop.is_set():
                        raise RuntimeError(
                            "record pipeline producer died without an "
                            "error or EOF — partial epoch")
                    return
                continue
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item.reshape(-1, self.record_bytes)

    def close(self) -> None:
        self._stop_prefetch()
        for f in self._files.values():
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def RecordPipeline(paths: Sequence[str], record_bytes: int,
                   batch_records: int, **kw):
    """Factory: native core when buildable, Python fallback otherwise."""
    from .native import NativeRecordPipeline, native_available
    if native_available():
        return NativeRecordPipeline(paths, record_bytes, batch_records, **kw)
    return PyRecordPipeline(paths, record_bytes, batch_records, **kw)
