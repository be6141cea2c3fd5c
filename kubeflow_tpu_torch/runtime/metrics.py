"""Per-step metrics, throughput, the window-edge metric fetch, the
flight recorder and the profiler hooks.

The port of the single-process part of ``kubeflow_tpu/runtime/metrics.py``:

- ``StepStats``, ``MetricsLogger`` (a JSONL sink and TensorBoard scalars
  through ``utils/tbevents.py``, mirrored on the port's process registry,
  which the worker's ``/metrics`` port serves) and ``AsyncWindowFetch``;
- ``FlightRecorder``: a ring of per-window host-stage records (data wait,
  H2D, dispatch, drain and the residual the device kept the host
  blocked) with the input stages' batch counts, dumped to the span sink;
- ``ProfileArm`` (``POST /profile?steps=N``) and ``profile_trace`` on
  ``torch.profiler`` (CPU, and CUDA where a card is present), each
  writing a Chrome trace into its directory.

``HeartbeatReporter`` (it needs ``cluster/http_client.py``) is not ported
yet (ROADMAP Queue 1 item 4), and neither is the modeled ICI/DCN split of
the recorder's records (``obs/collectives.py``): the port's records carry
none.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import socket
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..obs import registry as obsreg

log = logging.getLogger(__name__)

# env contract: where the worker streams per-step JSONL so external
# harnesses (workflows/kubebench reporter) can aggregate the run
METRICS_PATH_ENV = "KFTPU_METRICS_PATH"

# flight-recorder ring depth (windows kept); 0 disables the recorder
FLIGHT_WINDOWS_ENV = "KFTPU_FLIGHT_WINDOWS"
# span name a flight-recorder dump lands under in the trace sink
FLIGHT_RECORD_SPAN = "flight-record"


@dataclass
class StepStats:
    step: int
    step_time_s: float
    examples_per_sec: float
    metrics: dict[str, float] = field(default_factory=dict)
    # number of device steps this record averages over (>1 when the worker
    # only syncs every N steps)
    window: int = 1

    def to_dict(self) -> dict:
        d = {"step": self.step, "step_time_s": self.step_time_s,
             "examples_per_sec": self.examples_per_sec, **self.metrics}
        if self.window != 1:
            d["window"] = self.window
        return d


class MetricsLogger:
    """Accumulates per-window stats; optionally streams JSONL to a file
    and TensorBoard scalars to ``tensorboard_dir``. The process registry
    carries the step-time histogram, the throughput gauge and the window
    counter."""

    def __init__(self, path: Optional[str] = None, batch_size: int = 0,
                 log_every: int = 10, tensorboard_dir: Optional[str] = None):
        self.path = path
        self.batch_size = batch_size
        self.log_every = log_every
        self.history: list[StepStats] = []
        self._fh = open(path, "a") if path else None
        self._tb = None
        if tensorboard_dir:
            from ..utils.tbevents import EventWriter
            self._tb = EventWriter(tensorboard_dir)
        self.registry = obsreg.default_registry()
        self._obs_step = self.registry.histogram(
            "kftpu_step_seconds",
            "per-device-step wall time (window average)")
        self._obs_eps = self.registry.gauge(
            "kftpu_examples_per_sec",
            "training throughput over the last closed window")
        self._obs_windows = self.registry.counter(
            "kftpu_train_windows_total",
            "closed timing windows (one host sync each)")

    def record_window(self, step: int, n_steps: int, wall_s: float,
                      metrics: Optional[dict] = None) -> StepStats:
        """Record an already-timed window (the worker loop times windows
        itself; the metric fetch lags the window edge, AsyncWindowFetch)."""
        dt = wall_s / max(n_steps, 1)
        scalars = {}
        for k, v in (metrics or {}).items():
            try:
                scalars[k] = float(v)
            except (TypeError, ValueError):
                continue
        stats = StepStats(
            step=step, step_time_s=dt,
            examples_per_sec=(self.batch_size / dt) if dt > 0 else 0.0,
            metrics=scalars, window=max(n_steps, 1))
        self.history.append(stats)
        self._obs_step.observe(dt)
        self._obs_eps.set(stats.examples_per_sec)
        self._obs_windows.inc()
        if self._fh:
            self._fh.write(json.dumps(stats.to_dict()) + "\n")
            self._fh.flush()
        if self._tb:
            self._tb.add_scalars(
                {"throughput/examples_per_sec": stats.examples_per_sec,
                 "timing/step_time_s": dt, **scalars}, step)
        if self.log_every and \
                step // self.log_every > (step - n_steps) // self.log_every:
            log.info("step %d: %.1f ex/s %s", step, stats.examples_per_sec,
                     scalars)
        return stats

    def event(self, step: int, metrics: dict) -> None:
        """Stream an out-of-band record (eval results) to the JSONL
        without touching the timing history."""
        if self._fh:
            self._fh.write(json.dumps(
                {"step": step, "event": True,
                 "metrics": {k: float(v) for k, v in metrics.items()}})
                + "\n")
            self._fh.flush()
        if self._tb:
            self._tb.add_scalars(
                {f"eval/{k.removeprefix('eval_')}": float(v)
                 for k, v in metrics.items()}, step)

    def summary(self, warmup: int = 1) -> dict[str, float]:
        """Steady-state throughput, skipping the first ``warmup`` windows
        (kernel builds and first-launch costs) while always keeping the
        final window. Windows are weighted by the steps they cover."""
        if not self.history:
            return {"steps": 0, "examples_per_sec": 0.0,
                    "mean_step_time_s": 0.0}
        start = min(max(int(warmup), 0), len(self.history) - 1)
        steady = self.history[start:]
        n = sum(s.window for s in steady)
        t = sum(s.step_time_s * s.window for s in steady)
        first = self.history[0]
        return {
            "steps": sum(s.window for s in self.history),
            "mean_step_time_s": t / n if n else 0.0,
            "examples_per_sec": (self.batch_size * n / t) if t else 0.0,
            "first_window_s": first.step_time_s * first.window,
        }

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb:
            self._tb.close()
            self._tb = None


class AsyncWindowFetch:
    """Window-edge metrics without draining the device queue.

    ``submit()`` starts a non-blocking copy of each CUDA metric into
    pinned host memory and records a CUDA event behind the copies;
    ``drain()`` resolves windows ``lag`` submissions later, after waiting
    on their event, by which point the copies have long completed and the
    launch queue never emptied. Hard sync points (eval, preemption, the
    final step) force the drain. CPU tensors and host scalars pass
    through."""

    def __init__(self, lag: int = 1):
        self.lag = max(0, int(lag))
        self._pending: deque = deque()

    def submit(self, step: int, n_steps: int, wall_s: float,
               metrics: dict) -> None:
        host, device = {}, None
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v, non_blocking=True)
                host[k], device = buf, v.device
            else:
                host[k] = v
        event = None
        if device is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        self._pending.append((step, n_steps, wall_s, host, event))

    def drain(self, force: bool = False
              ) -> list[tuple[int, int, float, dict]]:
        """Windows ready to report, oldest first, values as host floats.
        Without ``force`` the newest ``lag`` submissions stay pending."""
        out = []
        while self._pending and (force or len(self._pending) > self.lag):
            step, n_steps, wall_s, host, event = self._pending.popleft()
            if event is not None:
                event.synchronize()
            out.append((step, n_steps, wall_s,
                        {k: float(v) for k, v in host.items()}))
        return out


class FlightRecorder:
    """Step-time flight recorder: a bounded in-memory ring of per-window
    timing records with the host-side stage breakdown (data wait, H2D,
    dispatch, end-of-window drain, and the residual the device kept the
    host blocked for), dumped to the span sink on a crash and on demand
    (``GET /flightrecorder``), so a wedged worker leaves evidence of
    WHERE it stuck.

    The hot path is two ``mark()`` attribute writes and one
    ``note_step()`` float-accumulate per step — no locks, no I/O; the
    lock only guards ring snapshots against the dump paths (signal
    handler, HTTP peek), which run concurrently with the loop."""

    # input-pipeline stage counters snapshotted per window
    # (data/mp_augment.py, data/device_prefetch.py label values)
    INPUT_STAGES = ("augment", "device_put")

    def __init__(self, windows: int = 64):
        self.enabled = windows > 0
        self._ring: deque = deque(maxlen=max(1, windows))
        self._lock = threading.Lock()
        self._stage = "init"
        self._stage_step = -1
        self._stage_since = time.time()
        self._acc = self._fresh_acc()
        self._input_counters = None
        self._input_last: dict[str, float] = {}

    @staticmethod
    def _fresh_acc() -> dict:
        return {"data_s": 0.0, "h2d_s": 0.0, "dispatch_s": 0.0,
                "first_step_s": 0.0, "steps": 0}

    def _input_totals(self) -> dict[str, float]:
        if self._input_counters is None:
            fam = obsreg.counter(
                "kftpu_input_batches_total",
                "batches delivered by each input-pipeline stage",
                labels=("stage",))
            self._input_counters = {s: fam.labels(stage=s)
                                    for s in self.INPUT_STAGES}
        return {s: c.value for s, c in self._input_counters.items()}

    # ------------------------------------------------------------ hot path

    def mark(self, stage: str, step: int) -> None:
        """Record what the loop is ABOUT to do — the dump's "where it
        stuck" pointer."""
        self._stage = stage
        self._stage_step = step
        self._stage_since = time.time()

    def note_step(self, data_s: float = 0.0, h2d_s: float = 0.0,
                  dispatch_s: float = 0.0,
                  first_step_s: float = 0.0) -> None:
        """``first_step_s`` carries the FIRST step's start-up cost and
        blocking sync separately, never charged to dispatch."""
        acc = self._acc
        acc["data_s"] += data_s
        acc["h2d_s"] += h2d_s
        acc["dispatch_s"] += dispatch_s
        acc["first_step_s"] += first_step_s
        acc["steps"] += 1

    def close_window(self, step: int, steps: int, wall_s: float,
                     drain_s: float = 0.0) -> None:
        """Fold the accumulated per-step stage times into one ring
        record at the window edge (the cadence of the window span)."""
        if not self.enabled:
            return
        acc = self._acc
        host = acc["data_s"] + acc["h2d_s"] + acc["dispatch_s"] + \
            acc["first_step_s"]
        totals = self._input_totals()
        deltas = {s: round(totals[s] - self._input_last.get(s, totals[s]))
                  for s in totals}
        self._input_last = totals
        rec = {
            "step": int(step), "steps": int(steps),
            "wall_s": round(wall_s, 6),
            "data_s": round(acc["data_s"], 6),
            "h2d_s": round(acc["h2d_s"], 6),
            "dispatch_s": round(acc["dispatch_s"], 6),
            "drain_s": round(drain_s, 6),
            # what the host spent BLOCKED on the device inside dispatch/
            # fetch — everything the host-side stages can't explain
            "device_wait_s": round(max(0.0, wall_s + drain_s - host), 6),
            "input_batches": deltas,
        }
        if acc["first_step_s"]:
            rec["first_step_s"] = round(acc["first_step_s"], 6)
        with self._lock:
            self._ring.append(rec)
        self._acc = self._fresh_acc()

    # --------------------------------------------------------------- dumps

    def snapshot(self) -> dict:
        """The ring plus the in-progress state. Signal-safe: a
        non-blocking acquire, then a best-effort copy (a concurrent
        mutation retries once)."""
        got = self._lock.acquire(blocking=False)
        try:
            try:
                records = list(self._ring)
            except RuntimeError:   # mutated mid-copy (lockless path)
                records = list(self._ring)
        finally:
            if got:
                self._lock.release()
        acc = dict(self._acc)
        return {
            "records": records,
            "inProgress": {
                "stage": self._stage,
                "step": self._stage_step,
                "stuckSeconds": round(time.time() - self._stage_since, 3),
                **{k: round(v, 6) if isinstance(v, float) else v
                   for k, v in acc.items()},
            },
        }

    def dump(self, tracer, reason: str, **attrs) -> Optional[dict]:
        """Write the ring to the span sink as ONE ``flight-record``
        span. Never raises — losing the dump must not mask the failure
        being dumped."""
        if not self.enabled or tracer is None:
            return None
        try:
            snap = self.snapshot()
            return tracer.emit(FLIGHT_RECORD_SPAN, start=time.time(),
                               reason=reason, **snap, **attrs)
        except Exception as e:  # noqa: BLE001 — evidence is best-effort
            log.warning("flight-recorder dump (%s) failed: %s", reason, e)
            return None


class TorchProfile:
    """One ``torch.profiler`` capture (CPU activity, and CUDA where a
    card is present) that writes a Chrome trace,
    ``<host>.<pid>.pt.trace.json`` (the name TensorBoard's profiler
    plugin reads), into its directory on ``stop()``."""

    def __init__(self):
        self._prof = None
        self._dir: Optional[str] = None

    def start(self, out_dir: str) -> None:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        self._prof, self._dir = prof, out_dir

    def stop(self) -> Optional[str]:
        prof, self._prof = self._prof, None
        if prof is None:
            return None
        prof.stop()
        path = os.path.join(
            self._dir, f"{socket.gethostname()}.{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(path)
        return path


class ProfileArm:
    """On-demand profiler trigger: ``POST /profile?steps=N`` on the
    worker's ObsServer arms a ``torch.profiler`` capture around the NEXT
    N steps and returns the artifact dir. The HTTP thread only flips
    armed state under the lock; the capture itself starts/stops on the
    LOOP thread at step boundaries. ``start_fn(out_dir)`` / ``stop_fn()``
    replace the profiler (tests inject them)."""

    def __init__(self, base_dir: str,
                 start_fn: Optional[Callable] = None,
                 stop_fn: Optional[Callable] = None,
                 tracer=None):
        self.base_dir = base_dir
        if start_fn is None or stop_fn is None:
            capture = TorchProfile()
            start_fn = start_fn or capture.start
            stop_fn = stop_fn or capture.stop
        self._start_fn = start_fn
        self._stop_fn = stop_fn
        self._tracer = tracer
        self._lock = threading.Lock()
        self._pending = 0
        self._active = 0
        self._dir: Optional[str] = None
        self._t0 = 0.0

    def request(self, steps: int) -> tuple[int, dict]:
        """The HTTP handler: arm a capture of ``steps`` steps. Returns
        (status, body) — 409 while a capture is already armed/active
        (two overlapping profiler sessions would corrupt both)."""
        try:
            steps = int(steps)
        except (TypeError, ValueError):
            return 400, {"error": "steps must be an integer"}
        if steps <= 0:
            return 400, {"error": f"steps must be > 0, got {steps}"}
        with self._lock:
            if self._pending or self._active:
                return 409, {"error": "a profile capture is already "
                                      "armed or active",
                             "dir": self._dir}
            self._dir = os.path.join(self.base_dir,
                                     f"profile-{time.time_ns()}")
            self._pending = steps
            return 200, {"armed": True, "steps": steps, "dir": self._dir}

    def on_step_start(self) -> None:
        """Loop thread, before dispatching a step: start a pending
        capture. Failures disarm with a warning — profiling must never
        kill training."""
        with self._lock:
            if not self._pending:
                return
            self._active = self._pending
            self._pending = 0
            out_dir = self._dir
        try:
            os.makedirs(out_dir, exist_ok=True)
            self._start_fn(out_dir)
            self._t0 = time.time()
        except Exception as e:  # noqa: BLE001
            log.warning("on-demand profile start failed: %s", e)
            with self._lock:
                self._active = 0

    def on_step_end(self, step: int, force: bool = False) -> None:
        """Loop thread, after a step completes: count down and stop.
        ``force`` stops an active capture now (the loop is ending)."""
        with self._lock:
            if not self._active:
                return
            self._active = 0 if force else self._active - 1
            if self._active:
                return
            out_dir = self._dir
        try:
            self._stop_fn()
            log.info("on-demand profiler trace written to %s", out_dir)
            if self._tracer is not None:
                self._tracer.emit("profile", start=self._t0,
                                  end=time.time(), out_dir=out_dir,
                                  step=step, on_demand=True)
        except Exception as e:  # noqa: BLE001
            log.warning("on-demand profile stop failed: %s", e)


@contextlib.contextmanager
def profile_trace(out_dir: Optional[str], enabled: bool = True,
                  tracer=None):
    """Capture a ``torch.profiler`` trace around a block into
    ``out_dir`` (a Chrome trace; view in Perfetto or TensorBoard). With
    a ``tracer`` (obs/trace.py SpanWriter) the capture is recorded as a
    ``profile`` span with the trace dir in its attrs."""
    if not (enabled and out_dir):
        yield
        return
    os.makedirs(out_dir, exist_ok=True)
    capture = TorchProfile()
    t0 = time.time()
    capture.start(out_dir)
    try:
        yield
    finally:
        path = capture.stop()
        log.info("profiler trace written to %s", path)
        if tracer is not None:
            tracer.emit("profile", start=t0, end=time.time(),
                        out_dir=out_dir, trace=path)
