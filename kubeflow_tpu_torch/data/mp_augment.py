"""Multi-process decode+augment stage over a shared-memory ring buffer.

The port of ``kubeflow_tpu/data/mp_augment.py``. Workers are spawned,
never forked: the parent may hold a CUDA context, and a forked child of
it cannot use (or safely inherit) one. They import
``kubeflow_tpu_torch.data.imagenet``, which imports numpy and not torch.
Each worker reports which augment implementation it ran, and the parent
counts it on the port's registry (``data/imagenet.py`` ``count_impl``).

The single prefetch thread that decodes+augments record batches is
GIL-bound where the numpy augment runs. This module fans the stage out
over spawned worker processes with ZERO per-batch pickling:

- one ``multiprocessing.shared_memory`` segment holds a ring of
  fixed-size slots, each sized for a full batch: a raw-record region the
  feeder memcpys into, and an output region (augmented images + labels)
  the worker writes through numpy views;
- the feeder thread (in the parent — the epoch shuffle order must come
  from the one shared record pipeline) takes a free slot, copies the raw
  slab, and enqueues a tiny (slot, seq, augment_base, n) task;
- workers decode+augment in place and post the slot back done;
- the consumer reassembles batches IN SUBMIT ORDER (determinism) and
  returns them as fresh arrays — ``torch.as_tensor`` aliases host
  memory on the CPU, and a ring view would be overwritten on slot
  reuse, so the one host memcpy per batch is the price of a provably
  safe ring.

Backpressure is the ring itself: with every slot in flight the feeder
blocks, so host memory is bounded at ``slots`` batches regardless of how
far the record reader could run ahead. Workers import only numpy + the
data layer.

Determinism: the augment RNG base is computed by the caller per
(seed, epoch, batch index) (imagenet.augment_base), so the output is
byte-identical to the single-thread path — restart/resume and chaos
parity ride on this, and tests pin it.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import queue as thqueue
import threading
import time
from multiprocessing import shared_memory
from typing import Iterable, Optional

import numpy as np

from .imagenet import count_impl

log = logging.getLogger(__name__)


def _attach_shm(name: str) -> shared_memory.SharedMemory:
    """Attach to the parent's segment WITHOUT registering it with the
    resource tracker: the parent owns and unlinks the ring (bpo-38119 —
    an attach re-registers the name, and since the tracker's cache is a
    set, sibling workers' registrations collapse and an exiting worker
    would unlink the ring under everyone else). Suppressing the
    registration beats unregistering after the fact, which double-removes
    across siblings."""
    from multiprocessing import resource_tracker
    orig_register = resource_tracker.register
    resource_tracker.register = lambda *a, **kw: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig_register


def _worker_main(shm_name: str, slot_bytes: int, batch_records: int,
                 record_bytes: int, image_size: int, output: str,
                 out_dtype_str: str, pad_px: int, do_augment: bool,
                 tasks, done) -> None:
    """Augment worker entrypoint (spawned; module-level so it pickles).

    Loops: take a task, decode the slot's raw region, augment into the
    slot's output region, post done. Exceptions are reported per task —
    the parent raises them to the consuming iterator (an augment crash
    must fail the run, never truncate the epoch). Exits on the ``None``
    sentinel or SIGTERM (default handler — the parent's close()
    terminates stragglers; the processes are daemonic so a dying parent
    reaps them either way)."""
    import signal
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # parent drives shutdown
    from .imagenet import augment_batch, augment_impl, decode_records
    out_dtype = np.dtype(out_dtype_str)
    hw3 = image_size * image_size * 3

    def process(shm, slot: int, base: int, n: int) -> None:
        # function-local views: they must all be released before the
        # final shm.close() (mmap refuses to close with exported buffers)
        off = slot * slot_bytes
        # private copy of the slab before the gather: the augment's
        # random-access reads are measurably slower against shm pages
        # the feeder's core just dirtied (cross-core coherence misses);
        # one sequential memcpy is cheaper than paying them per pixel
        raw = np.array(np.frombuffer(shm.buf, np.uint8, n * record_bytes,
                                     off).reshape(n, record_bytes))
        images, labels = decode_records(raw, image_size)
        out = augment_batch(images, base, pad_px,
                            do_flip=do_augment, do_crop=do_augment,
                            output=output, image_dtype=out_dtype)
        img_off = off + batch_records * record_bytes
        lab_off = img_off + batch_records * hw3 * out_dtype.itemsize
        np.frombuffer(shm.buf, out_dtype, n * hw3, img_off).reshape(
            n, image_size, image_size, 3)[:] = out
        np.frombuffer(shm.buf, np.int32, n, lab_off)[:] = labels

    shm = _attach_shm(shm_name)
    impl = augment_impl()
    try:
        while True:
            task = tasks.get()
            if task is None:
                return
            slot, seq, base, n = task
            try:
                process(shm, slot, base, n)
                done.put(("ok", slot, seq, n, impl))
            except Exception as e:  # noqa: BLE001 - surfaced to the consumer
                done.put(("error", slot, seq, f"{type(e).__name__}: {e}"))
    finally:
        shm.close()


class AugmentPool:
    """Bounded multi-process decode+augment pipeline (see module doc).

    Usage::

        pool = AugmentPool(workers=4, batch_records=B, record_bytes=R,
                           image_size=S, output="uint8")
        pool.start(gen)          # gen yields (raw_records, augment_base)
        for batch in pool:       # {"images": ..., "labels": ...} in order
            ...
        pool.close()

    The iterator raises the feeder's exception (after delivering every
    batch submitted before it), a worker task failure, or a
    RuntimeError when a worker process dies — a crashed stage must fail
    the run, never silently truncate it.
    """

    def __init__(self, *, workers: int, batch_records: int,
                 record_bytes: int, image_size: int,
                 output: str = "uint8", image_dtype=np.float32,
                 pad_px: int = 4, augment: bool = True,
                 slots: Optional[int] = None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.workers = int(workers)
        self.batch_records = int(batch_records)
        self.record_bytes = int(record_bytes)
        self.image_size = int(image_size)
        self.output = output
        self.out_dtype = np.dtype(np.uint8 if output == "uint8"
                                  else image_dtype)
        # ring depth = the backpressure bound: the feeder blocks once
        # every slot is in flight. workers+2 keeps each worker busy with
        # one slab queued and one finished batch awaiting the consumer.
        self.slots = int(slots) if slots else self.workers + 2
        if self.slots < 2:
            raise ValueError(f"slots must be >= 2, got {self.slots}")
        hw3 = self.image_size * self.image_size * 3
        self._raw_bytes = self.batch_records * self.record_bytes
        self._img_bytes = self.batch_records * hw3 * self.out_dtype.itemsize
        self._lab_bytes = self.batch_records * 4
        self.slot_bytes = self._raw_bytes + self._img_bytes + self._lab_bytes
        # everything close() touches exists BEFORE anything that can
        # fail mid-construction (shm create, worker spawn): a partial
        # __init__ must still tear down cleanly instead of leaking the
        # ring segment and already-started workers
        self._closed = False
        # input-stage rate for the shared registry (obs/registry.py):
        # handle resolved once — __next__ is the per-batch hot path
        from ..obs import registry as obsreg
        self._obs_batches = obsreg.counter(
            "kftpu_input_batches_total",
            "batches delivered by each input-pipeline stage",
            labels=("stage",)).labels(stage="augment")
        self._stop = threading.Event()
        self._feeder: Optional[threading.Thread] = None
        self._feed_error: Optional[BaseException] = None
        self._feed_total: Optional[int] = None
        self._ready: dict[int, tuple[int, int, str]] = {}
        self._next_seq = 0
        self._procs: list = []
        self._shm = None
        self._free: thqueue.Queue = thqueue.Queue()
        for s in range(self.slots):
            self._free.put(s)
        ctx = mp.get_context("spawn")   # never fork a CUDA-initialized parent
        self._tasks = ctx.Queue()
        self._done = ctx.Queue()
        try:
            self._shm = shared_memory.SharedMemory(
                create=True, size=self.slots * self.slot_bytes)
            self._procs = [
                ctx.Process(
                    target=_worker_main,
                    args=(self._shm.name, self.slot_bytes,
                          self.batch_records, self.record_bytes,
                          self.image_size, output, self.out_dtype.str,
                          pad_px, augment, self._tasks, self._done),
                    daemon=True, name=f"kftpu-augment-{i}")
                for i in range(self.workers)]
            for p in self._procs:
                p.start()
        except BaseException:
            self.close()
            raise

    # -- feeding ------------------------------------------------------------

    def start(self, source: Iterable) -> "AugmentPool":
        """Begin feeding from ``source``, which yields
        (raw_records (n, record_bytes) uint8, augment_base) pairs."""
        if self._feeder is not None:
            raise RuntimeError("AugmentPool already started")
        self._feeder = threading.Thread(target=self._feed, args=(source,),
                                        daemon=True,
                                        name="kftpu-augment-feed")
        self._feeder.start()
        return self

    def _feed(self, source) -> None:
        seq = 0
        try:
            for raw, base in source:
                slot = self._take_slot()
                if slot is None:
                    return          # closing
                raw = np.ascontiguousarray(raw, np.uint8)
                n = raw.shape[0]
                if n > self.batch_records:
                    raise ValueError(
                        f"batch of {n} records exceeds the ring's slab "
                        f"capacity {self.batch_records}")
                off = slot * self.slot_bytes
                np.frombuffer(self._shm.buf, np.uint8,
                              n * self.record_bytes, off)[:] = \
                    raw.reshape(-1)
                self._tasks.put((slot, seq, int(base), n))
                seq += 1
        except BaseException as e:  # noqa: BLE001 - surfaced to the consumer
            self._feed_error = e
        finally:
            self._feed_total = seq

    def _take_slot(self) -> Optional[int]:
        while not self._stop.is_set():
            try:
                return self._free.get(timeout=0.1)
            except thqueue.Empty:
                continue
        return None

    # -- consuming ----------------------------------------------------------

    def __iter__(self) -> "AugmentPool":
        return self

    def __next__(self) -> dict:
        if self._closed:
            raise RuntimeError("AugmentPool is closed")
        while True:
            if self._next_seq in self._ready:
                slot, n, impl = self._ready.pop(self._next_seq)
                batch = self._copy_out(slot, n)
                self._free.put(slot)
                self._next_seq += 1
                self._obs_batches.inc()
                count_impl("augment", impl)
                return batch
            total = self._feed_total
            if total is not None and self._next_seq >= total \
                    and not self._ready:
                # every submitted batch delivered; the feeder's outcome
                # decides between clean EOF and a propagated crash
                if self._feed_error is not None:
                    raise self._feed_error
                raise StopIteration
            try:
                msg = self._done.get(timeout=0.2)
            except thqueue.Empty:
                self._check_workers()
                continue
            if msg[0] == "ok":
                _, slot, seq, n, impl = msg
                self._ready[seq] = (slot, n, impl)
            else:
                _, _slot, seq, err = msg
                raise RuntimeError(
                    f"augment worker failed on batch {seq}: {err}")

    def _check_workers(self) -> None:
        for p in self._procs:
            if not p.is_alive():
                raise RuntimeError(
                    f"augment worker {p.name} died "
                    f"(exitcode {p.exitcode}) — input stage lost")

    def _copy_out(self, slot: int, n: int) -> dict:
        """Fresh arrays, not ring views: torch.as_tensor aliases host
        memory, and a view would be overwritten on slot reuse."""
        hw3 = self.image_size * self.image_size * 3
        off = slot * self.slot_bytes
        img_off = off + self._raw_bytes
        lab_off = img_off + self._img_bytes
        images = np.frombuffer(self._shm.buf, self.out_dtype, n * hw3,
                               img_off).reshape(
            n, self.image_size, self.image_size, 3).copy()
        labels = np.frombuffer(self._shm.buf, np.int32, n, lab_off).copy()
        return {"images": images, "labels": labels}

    # -- teardown -----------------------------------------------------------

    def close(self) -> None:
        """Idempotent teardown, safe from SIGTERM/preemption handling:
        stop the feeder, sentinel + join the workers (terminating
        stragglers), drain the queues so their flush threads exit, and
        unlink the shared-memory ring."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._feeder is not None:
            self._feeder.join(timeout=10)
            if self._feeder.is_alive():   # wedged in the record reader
                log.warning("augment feeder did not stop within 10s")
        for _ in self._procs:
            try:
                self._tasks.put(None)
            except (ValueError, OSError):
                break
        started = [p for p in self._procs if p.pid is not None]
        deadline = time.monotonic() + 5.0
        for p in started:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
        for p in started:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        try:
            while True:
                self._done.get_nowait()
        except (thqueue.Empty, ValueError, OSError):
            pass
        for q in (self._tasks, self._done):
            try:
                q.close()
                q.cancel_join_thread()
            except (ValueError, OSError):
                pass
        self._ready.clear()
        if self._shm is None:     # construction failed before the ring
            return
        try:
            self._shm.close()
        except BufferError:
            # a stray view still exports the mmap; unlink below still
            # releases the name, and the map goes with the process
            log.warning("shared-memory ring closed with live views")
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass

    def __enter__(self) -> "AugmentPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
