"""Micro-batching queue: concurrent requests → one device dispatch.

The port of ``kubeflow_tpu/serving/batcher.py``. Per-request dispatch
leaves the device underfed; the batcher coalesces concurrent requests
into a single padded batch, runs one forward, and fans results back out
to per-request futures. Two admission schedulers (``batching=``):

- ``continuous`` (default): in-flight batching. The moment the previous
  device dispatch returns, the next batch is formed greedily —
  oldest-first, everything already queued, up to ``max_batch`` — and
  dispatched immediately. Only when the device was IDLE (the queue was
  empty when the loop came back) does the first arrival wait, and then
  at most ``max_wait_ms``, as a coalescing bound so a lone request can
  pick up co-riders.
- ``window``: the fixed ``max_latency_ms`` collect window — first
  arrival opens a window, dispatch happens at the window edge or at
  ``max_batch``.

Each work item may carry a RequestTrace (serving/request_trace.py): the
batcher stamps its queue wait, batch-form share, H2D/device/pad-waste/
drain shares onto it, so one request's ledger partitions its
wall-clock. A bounded queue (``max_pending``) sheds load with an
explicit QueueFullError (HTTP 429) carrying a ``Retry-After`` hint from
the measured drain rate. Queue depth and oldest-waiting age are polled
by the replica registry at scrape time; an item leaves both gauges the
moment it is admitted to a forming cohort.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional

import numpy as np


class QueueFullError(RuntimeError):
    """The bounded batcher queue is at max_pending: shed this request
    (429 / RESOURCE_EXHAUSTED) rather than queue it unbounded.

    ``retry_after_s`` is the shed hint the HTTP layer surfaces as a
    ``Retry-After`` header: current queue depth over the measured
    dispatch drain rate (EWMA requests/s through the device), clamped
    to [1, 30] s — "come back when the backlog you were shed behind
    has drained", not a bare 429 the client can only guess at."""

    retry_after_s: float = 1.0


class BatcherClosedError(RuntimeError):
    """The batcher is draining or shut down: this replica is going
    away, not misbehaving. ``http_status = 503`` makes the HTTP layer
    answer retryable weather (the fleet router re-routes) instead of a
    non-retryable 400 — a request racing a graceful drain must never
    fail hard while N-1 healthy replicas could serve it."""

    http_status = 503


@dataclass
class _WorkItem:
    instances: np.ndarray
    future: Future
    ctx: Optional[object] = None      # RequestTrace (or None)
    t_enqueue: float = 0.0


class MicroBatcher:
    """Collects requests for one servable and dispatches merged batches."""

    BATCHING_MODES = ("continuous", "window")

    def __init__(self, servable, max_batch: int = 64,
                 max_latency_ms: float = 5.0, max_pending: int = 0,
                 batching: str = "continuous",
                 max_wait_ms: Optional[float] = None):
        if batching not in self.BATCHING_MODES:
            raise ValueError(
                f"batching must be one of {self.BATCHING_MODES}, "
                f"got {batching!r}")
        self.servable = servable
        self.max_batch = max_batch
        self.max_latency = max_latency_ms / 1000.0
        self.batching = batching
        # continuous mode's idle-device coalescing bound; defaults to
        # the window knob so one number tunes either scheduler
        self.max_wait = (max_latency_ms if max_wait_ms is None
                         else max_wait_ms) / 1000.0
        # 0 = unbounded (the legacy behavior); N = shed at N waiting
        self.max_pending = max(0, int(max_pending))
        # EWMA of requests/s through the device: the Retry-After hint's
        # denominator. Written only by the loop thread, read anywhere
        # (float store is atomic under the GIL).
        self._drain_rate = 0.0
        self._queue: "queue.Queue[_WorkItem]" = queue.Queue()
        self._stop = threading.Event()
        self._draining = False
        self._submit_lock = threading.Lock()
        # waiting-item enqueue times for the oldest-age gauge: keyed by
        # item id, removed when the loop collects the item
        self._waiting: dict[int, float] = {}
        self._batch_ids = itertools.count(1)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"batcher-{servable.name}")
        self._thread.start()

    # ------------------------------------------------------ queue telemetry

    def queue_depth(self) -> int:
        """Requests waiting (not yet pulled into a batch)."""
        with self._submit_lock:
            return len(self._waiting)

    def oldest_wait_s(self) -> float:
        """Age of the oldest waiting request; 0 when the queue is empty."""
        with self._submit_lock:
            if not self._waiting:
                return 0.0
            return max(0.0, time.time() - min(self._waiting.values()))

    def retry_after_s(self) -> float:
        """The shed hint: seconds until the current backlog drains at
        the measured dispatch rate, clamped to [1, 30]. 1 s when no
        rate has been measured yet (cold batcher)."""
        with self._submit_lock:
            depth = len(self._waiting)
        return self._retry_hint(depth)

    def _retry_hint(self, depth: int) -> float:
        rate = self._drain_rate
        if rate <= 0.0:
            return 1.0
        return min(30.0, max(1.0, depth / rate))

    # -------------------------------------------------------------- submit

    def submit(self, instances: np.ndarray,
               ctx: Optional[object] = None) -> Future:
        item = _WorkItem(np.asarray(instances), Future(), ctx=ctx)
        # Lock makes the stop-check + put atomic w.r.t. shutdown()'s
        # stop-set + drain, so no item can land after the final drain and
        # leave its future forever unresolved.
        with self._submit_lock:
            if self._stop.is_set():
                raise BatcherClosedError("batcher is shut down")
            if self._draining:
                # drain closed the door: the cohort already queued gets
                # flushed, but no new work may land behind it
                raise BatcherClosedError("batcher is draining")
            if self.max_pending and len(self._waiting) >= self.max_pending:
                err = QueueFullError(
                    f"batcher queue full ({self.max_pending} pending)")
                err.retry_after_s = self._retry_hint(len(self._waiting))
                raise err
            item.t_enqueue = time.time()
            self._waiting[id(item)] = item.t_enqueue
            self._queue.put(item)
        return item.future

    def predict(self, instances: np.ndarray, timeout: float = 30.0,
                ctx: Optional[object] = None):
        return self.submit(instances, ctx=ctx).result(timeout=timeout)

    def _take(self, timeout: Optional[float] = None) -> Optional[_WorkItem]:
        """Pull one queued item into the forming cohort. Admission is
        when it leaves the queue GAUGES (scrape-time depth/oldest-age
        must stop counting it immediately — admitted work is device
        backlog the autoscaler must not double-count as queue backlog),
        so ``_waiting`` is popped here, at pull time, not at dispatch.
        ``timeout=None`` means non-blocking."""
        try:
            item = (self._queue.get_nowait() if timeout is None
                    else self._queue.get(timeout=timeout))
        except queue.Empty:
            return None
        with self._submit_lock:
            self._waiting.pop(id(item), None)
        return item

    def _seal(self, items: list[_WorkItem]) -> None:
        """The cohort is final: close every member's ``queue`` ledger
        stage at one shared seal instant (enqueue → admission-to-cohort;
        dispatch starts immediately after, so the ledger still
        partitions wall-clock exactly — no unattributed gap)."""
        now = time.time()
        for it in items:
            if it.ctx is not None:
                it.ctx.stage("queue", it.t_enqueue, now)

    def _admit(self) -> list[_WorkItem]:
        """Continuous (in-flight) admission: greedily form the next
        batch from whatever is queued RIGHT NOW — the loop re-enters
        the moment the previous dispatch returned, so under load no
        request ever waits on a window edge. Only when the device was
        idle (nothing queued on re-entry) does the first arrival hold
        for co-riders, bounded by ``max_wait_ms``; a drain skips even
        that (flush now, nobody new is coming)."""
        first = self._take()
        was_idle = first is None
        if was_idle:
            first = self._take(timeout=0.1)
            if first is None:
                return []
        items, total = [first], first.instances.shape[0]
        while total < self.max_batch:
            nxt = self._take()
            if nxt is None:
                break
            items.append(nxt)
            total += nxt.instances.shape[0]
        if was_idle and total < self.max_batch and self.max_wait > 0 \
                and not self._draining:
            t0 = time.perf_counter()
            while total < self.max_batch:
                remaining = self.max_wait - (time.perf_counter() - t0)
                if remaining <= 0:
                    break
                nxt = self._take(timeout=remaining)
                if nxt is None:
                    break
                items.append(nxt)
                total += nxt.instances.shape[0]
        self._seal(items)
        return items

    def _collect(self) -> list[_WorkItem]:
        """Fixed-window collect (``batching="window"``): block for the
        first item, then drain what arrives within the latency window
        (or until the batch is full)."""
        first = self._take(timeout=0.1)
        if first is None:
            return []
        items, total = [first], first.instances.shape[0]
        deadline = self.max_latency
        t0 = time.perf_counter()
        while total < self.max_batch:
            remaining = deadline - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            nxt = self._take(timeout=remaining)
            if nxt is None:
                break
            items.append(nxt)
            total += nxt.instances.shape[0]
        self._seal(items)
        return items

    def _dispatch(self, items: list[_WorkItem]):
        """One device call for a shape-compatible cohort; errors fan out
        only to that cohort. Each item's ctx gets the cohort's FULL
        stage intervals (the request lived through the whole shared
        pipeline — its wall-clock partitions exactly), with the device
        interval split by the cohort's fill: the real-row fraction is
        serving goodput (co-riders' rows are useful work the request
        rode along with), the pad fraction is pad_waste."""
        traced = [it for it in items if it.ctx is not None]
        t_form0 = time.perf_counter()
        tw_form0 = time.time()
        batch = np.concatenate([it.instances for it in items], axis=0)
        form_s = time.perf_counter() - t_form0
        try:
            if hasattr(self.servable, "predict_with_stages"):
                out, stages = self.servable.predict_with_stages(batch)
            else:
                out, stages = self.servable.predict(batch), None
        except Exception as e:  # noqa: BLE001 — fan the error out
            for it in items:
                it.future.set_exception(e)
            return
        if traced:
            self._record_stages(items, traced, stages, form_s, tw_form0)
        ofs = 0
        for it in items:
            n = it.instances.shape[0]
            it.future.set_result(
                {k: x[ofs:ofs + n] for k, x in out.items()}
                if isinstance(out, dict) else out[ofs:ofs + n])
            ofs += n

    def _record_stages(self, items, traced, stages, form_s: float,
                       tw_form0: float) -> None:
        rows_total = sum(it.instances.shape[0] for it in items)
        batch_id = next(self._batch_ids)
        if stages is None:
            stages = {"h2d_s": 0.0, "device_s": 0.0, "drain_s": 0.0,
                      "bucket": rows_total, "rows": rows_total,
                      "pad_rows": 0}
        bucket = max(1, int(stages.get("bucket", rows_total)))
        pad_rows = int(stages.get("pad_rows", 0))
        # padded_total covers the oversized-split case too (several
        # chunks, each padded): real + pad rows actually computed
        padded_total = max(1, rows_total + pad_rows)
        fill = rows_total / padded_total
        device_s = float(stages.get("device_s", 0.0))
        pad_waste_total = device_s * (pad_rows / padded_total)
        # wall-clock boundaries for the sampled stage spans (the ledger
        # carries the shares; the spans carry the cohort's intervals)
        tw_form1 = tw_form0 + form_s
        tw_h2d1 = tw_form1 + float(stages.get("h2d_s", 0.0))
        tw_dev1 = tw_h2d1 + device_s
        tw_drain1 = tw_dev1 + float(stages.get("drain_s", 0.0))
        quant = getattr(self.servable, "quant", None)
        for it in traced:
            it.ctx.note(batch_id=batch_id, bucket=bucket,
                        fill=round(fill, 4),
                        batch_requests=len(items))
            if quant:
                # the int8 tier's ledgered accuracy delta rides every
                # sampled span — the dashboard's serving table shows it
                # next to the SLO badge
                it.ctx.note(quant_delta=quant["accuracy_delta"])
            it.ctx.stage("batch-form", tw_form0, tw_form1,
                         batch_id=batch_id, fill=round(fill, 4),
                         pad_rows=pad_rows)
            it.ctx.stage("h2d", tw_form1, tw_h2d1, bucket=bucket)
            it.ctx.device(tw_h2d1, tw_dev1,
                          goodput_s=device_s * fill,
                          pad_waste_s=pad_waste_total,
                          batch_id=batch_id)
            it.ctx.stage("drain", tw_dev1, tw_drain1)
            it.ctx.t_pipeline_end = tw_drain1

    def _loop(self):
        while not self._stop.is_set():
            items = (self._admit() if self.batching == "continuous"
                     else self._collect())
            if not items:
                continue
            t_d0 = time.perf_counter()
            # Group by trailing shape + dtype: one malformed request must
            # not poison the other requests coalesced into its cohort.
            groups: dict[tuple, list[_WorkItem]] = {}
            for it in items:
                if it.instances.ndim < 1:
                    it.future.set_exception(ValueError(
                        "instances must have a batch dimension"))
                    continue
                key = (it.instances.shape[1:], str(it.instances.dtype))
                groups.setdefault(key, []).append(it)
            for cohort in groups.values():
                self._dispatch(cohort)
            # drain-rate EWMA (requests/s through the device) feeding
            # the Retry-After shed hint
            rate = len(items) / max(time.perf_counter() - t_d0, 1e-6)
            self._drain_rate = rate if self._drain_rate <= 0.0 \
                else 0.7 * self._drain_rate + 0.3 * rate

    def drain(self, timeout_s: float = 10.0) -> dict:
        """Graceful close: stop accepting, flush the pending cohort
        through the device, then stop the loop. Anything still queued
        past the deadline is failed FAST with an explicit error — a
        queued request must never hang forever past server shutdown —
        and its trace closes with ledger outcome ``drained``. Returns
        ``{"flushed": n, "failed": m}``."""
        with self._submit_lock:
            self._draining = True
            pending_at_close = len(self._waiting)
        deadline = time.monotonic() + max(0.0, timeout_s)
        while time.monotonic() < deadline:
            with self._submit_lock:
                if not self._waiting:
                    break
            time.sleep(0.005)
        failed = self.shutdown(
            join_timeout=max(0.5, deadline - time.monotonic()))
        return {"flushed": max(0, pending_at_close - failed),
                "failed": failed}

    def shutdown(self, join_timeout: float = 5.0) -> int:
        """Hard stop: any request still queued is failed fast (never
        left hanging) with its trace — when it carries one — finished
        as outcome ``drained``. Returns how many stragglers were
        failed."""
        with self._submit_lock:
            self._stop.set()
        self._thread.join(timeout=join_timeout)
        failed = 0
        while True:  # fail any stragglers
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            with self._submit_lock:
                self._waiting.pop(id(item), None)
            err = BatcherClosedError(
                "batcher shut down before this request was "
                "dispatched (drained)")
            if item.ctx is not None:
                # first-wins finish: the handler's own error path then
                # no-ops — the ledger records the drain, not a generic
                # error (the drain contract)
                item.ctx.finish("drained", error=str(err))
            item.future.set_exception(err)
            failed += 1
        return failed
