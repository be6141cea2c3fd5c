"""Per-step metrics, throughput, and the window-edge metric fetch.

The port of the training-loop part of ``kubeflow_tpu/runtime/metrics.py``:
``StepStats``, ``MetricsLogger`` (a JSONL sink, mirrored on the port's own
``obs/registry.py``) and ``AsyncWindowFetch``. TensorBoard events, the
heartbeat, the flight recorder and the profiler hooks are not ported yet
(ROADMAP Queue 1 item 4); a ``tensorboard_dir`` raises.
"""

from __future__ import annotations

import json
import logging
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..obs.registry import Registry

log = logging.getLogger(__name__)

# env contract: where the worker streams per-step JSONL so external
# harnesses (workflows/kubebench reporter) can aggregate the run
METRICS_PATH_ENV = "KFTPU_METRICS_PATH"


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
    """Accumulates per-window stats; optionally streams JSONL to a file.
    Its own registry carries the step-time histogram, the throughput
    gauge and the window counter."""

    def __init__(self, path: Optional[str] = None, batch_size: int = 0,
                 log_every: int = 10, tensorboard_dir: Optional[str] = None):
        if tensorboard_dir:
            raise NotImplementedError(
                "tensorboard_dir: TensorBoard events are not yet ported "
                "(ROADMAP Queue 1 item 4); use the JSONL metrics path")
        self.path = path
        self.batch_size = batch_size
        self.log_every = log_every
        self.history: list[StepStats] = []
        self._fh = open(path, "a") if path else None
        self.registry = Registry()
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
