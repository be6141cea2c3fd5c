"""Replica health registry: the signals the router and autoscaler read.

The ROADMAP's serving tier needs "per-replica health/latency from the
obs registry" for load-balancing routing and "queue-depth and latency
histograms" for autoscaling — this module is that registry. Each model
server feeds one ReplicaState with every finished request (via
serving/request_trace.py) and its batchers' queue state; the state
publishes two surfaces:

- **/metrics** (Prometheus, via the server's obs Registry): rolling
  p50/p99 gauges, request/error/shed counters, in-flight + queue-depth
  + oldest-waiting-age gauges, per-category serving badput counters,
  batch-fill gauge, warm/cold start kind, and multi-window SLO
  burn-rate gauges — all labeled per model (shadow traffic labeled
  ``role=shadow`` so a cold shadow JIT never pollutes the primary's
  SLO series).
- **/healthz?verbose=1** (compact JSON): the same numbers as one
  snapshot — the exact interface the future load-balancing router and
  autoscaler reconciler poll.

Series are pruned when a model is unloaded (`prune`): a router reading
frozen last-latency for a gone model would keep routing to it.

SLO burn rate (the SRE multi-window form): a model declares a target
p99 (ms) and/or an availability target. Over each window, the latency
burn is frac(requests over target) / 0.01 (a p99 target budgets 1%
over) and the availability burn is error_rate / (1 - target). Burn 1.0
= exactly consuming budget; >1 = burning faster than the SLO allows.
The port's copy of kubeflow_tpu/serving/replica_state.py; stdlib only.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from ..obs import goodput as gp

# multi-window burn rates (seconds): the fast window pages, the slow
# window confirms — the standard multi-window multi-burn-rate pattern
BURN_WINDOWS = (60.0, 300.0, 3600.0)

# a p99 target budgets 1% of requests over it
_P99_BUDGET = 0.01


@dataclass(frozen=True)
class ModelSLO:
    """Declarative per-model SLO (the serving manifest schema renders
    these as --slo-p99-ms / --slo-availability)."""

    target_p99_ms: Optional[float] = None
    availability: Optional[float] = None   # e.g. 0.999

    def to_dict(self) -> dict:
        return {"targetP99Ms": self.target_p99_ms,
                "availability": self.availability}


class _ModelWindow:
    """Bounded rolling sample window for one (model, role): (t, latency,
    ok, over_slo) tuples, enough for an hour-window burn rate at
    moderate QPS without unbounded growth."""

    __slots__ = ("samples", "fills")

    def __init__(self, max_samples: int):
        self.samples: deque = deque(maxlen=max_samples)
        self.fills: deque = deque(maxlen=256)


class ReplicaState:
    """Per-model rolling health the model server feeds and publishes."""

    def __init__(self, registry, windows: tuple = BURN_WINDOWS,
                 max_samples: int = 4096, clock=time.time):
        self.registry = registry
        self.windows = tuple(float(w) for w in windows)
        self.max_samples = max_samples
        self.clock = clock
        # the fleet-router contract (serving/fleet.py): uptime lets the
        # router spot a freshly-restarted (cold) replica, draining tells
        # it to stop sending BEFORE the pod dies
        self.started_at = self.clock()
        self.draining = False
        self._lock = threading.Lock()
        self._models: dict[tuple, _ModelWindow] = {}   # (model, role)
        self._slos: dict[str, ModelSLO] = {}
        self._start_kind: dict[str, str] = {}
        self._inflight: dict[str, int] = {}
        self._heartbeat: dict[str, float] = {}
        self._queues: dict[str, object] = {}   # model → batcher
        # cumulative goodput/wall seconds per model (primary ledgers)
        # feeding the kftpu_serving_goodput_ratio gauge
        self._goodput_acc: dict[str, list] = {}
        r = registry
        self._m_requests = r.counter(
            "kftpu_serving_requests_total",
            "finished serving requests per model/role/outcome",
            labels=("model", "role", "outcome"))
        self._m_latency = r.histogram(
            "kftpu_serving_request_seconds",
            "end-to-end request latency (accept → respond)",
            labels=("model", "role"))
        self._m_p50 = r.gauge(
            "kftpu_serving_p50_seconds",
            "rolling p50 request latency", labels=("model", "role"))
        self._m_p99 = r.gauge(
            "kftpu_serving_p99_seconds",
            "rolling p99 request latency", labels=("model", "role"))
        self._m_err = r.gauge(
            "kftpu_serving_error_ratio",
            "rolling error fraction", labels=("model", "role"))
        self._m_inflight = r.gauge(
            "kftpu_serving_inflight",
            "requests accepted but not yet responded", labels=("model",))
        self._m_qdepth = r.gauge(
            "kftpu_serving_queue_depth",
            "requests waiting in the micro-batcher queue",
            labels=("model",))
        self._m_oldest = r.gauge(
            "kftpu_serving_oldest_wait_seconds",
            "age of the oldest request waiting in the batcher queue",
            labels=("model",))
        self._m_fill = r.gauge(
            "kftpu_serving_batch_fill_ratio",
            "rolling mean real-rows / padded-bucket fraction",
            labels=("model",))
        self._m_goodput = r.gauge(
            "kftpu_serving_goodput_ratio",
            "rolling device-real-work fraction of request wall-clock "
            "(docs/operations.md 'Serving observability')",
            labels=("model",))
        # cumulative badput per category: a true counter (inc per
        # request), unlike the job ledger's snapshot-set bridge
        self._m_badput = r.counter(
            "kftpu_serving_badput_seconds_total",
            "request wall-clock seconds lost per serving badput "
            "category", labels=("model", "category"))
        self._m_shed = r.counter(
            "kftpu_serving_shed_total",
            "requests rejected by the bounded batcher queue (429)",
            labels=("model",))
        self._m_heartbeat = r.gauge(
            "kftpu_serving_last_request_time_seconds",
            "unix time of the model's last finished request",
            labels=("model",))
        self._m_start_kind = r.gauge(
            "kftpu_serving_start_kind",
            "1 for the warm-start rung that loaded this model "
            "(cold|warm)",
            labels=("model", "kind"))
        self._m_burn = r.gauge(
            "kftpu_serving_slo_burn_rate",
            "error-budget burn rate per SLO and window (1.0 = exactly "
            "consuming budget)", labels=("model", "slo", "window"))
        self._m_draining = r.gauge(
            "kftpu_serving_draining",
            "1 while this replica is draining (readiness flipped, new "
            "work rejected, in-flight finishing)")
        self._m_uptime = r.gauge(
            "kftpu_serving_uptime_seconds",
            "seconds since this replica started serving")

    # ------------------------------------------------------------- feeding

    def set_slo(self, model: str, slo: ModelSLO) -> None:
        with self._lock:
            self._slos[model] = slo

    def slo_of(self, model: str) -> Optional[ModelSLO]:
        with self._lock:
            return self._slos.get(model)

    def set_start_kind(self, model: str, kind: str) -> None:
        with self._lock:
            previous = self._start_kind.get(model)
            self._start_kind[model] = kind
        # one-hot: a reloaded model that warms up must not keep
        # exporting its previous kind's 1 beside the new one
        if previous is not None and previous != kind:
            self._m_start_kind.remove(model=model, kind=previous)
        self._m_start_kind.labels(model=model, kind=kind).set(1)

    def register_queue(self, model: str, batcher) -> None:
        """The model's MicroBatcher: polled at refresh()/snapshot()
        time for queue depth + oldest-waiting age (scrape-time pull,
        zero hot-path cost). Under continuous batching the
        batcher removes an item from both gauges the moment it is
        admitted to a forming cohort — the gauges count work the
        DEVICE has not yet claimed, which is exactly the backlog the
        autoscaler reconciler scales on; counting admitted (in-flight)
        work here would double-book it against ``inFlight``."""
        with self._lock:
            self._queues[model] = batcher

    def inflight_inc(self, model: str) -> None:
        with self._lock:
            self._inflight[model] = self._inflight.get(model, 0) + 1

    def inflight_dec(self, model: str) -> None:
        with self._lock:
            self._inflight[model] = max(
                0, self._inflight.get(model, 0) - 1)

    def total_inflight(self) -> int:
        """Accepted-but-unanswered requests across all models — what a
        graceful drain waits on before the process may exit."""
        with self._lock:
            return sum(self._inflight.values())

    def set_draining(self, draining: bool = True) -> None:
        """Flip the replica-wide draining flag: advertised on the
        verbose healthz payload and /metrics so the fleet router stops
        sending BEFORE the pod dies (plain /healthz also flips to 503
        — the kubelet readiness contract; http_server.py)."""
        self.draining = bool(draining)
        self._m_draining.set(1 if self.draining else 0)

    def uptime_seconds(self) -> float:
        return max(0.0, self.clock() - self.started_at)

    def observe_request(self, model: str, latency_s: float,
                        outcome: str = "ok", role: str = "primary",
                        ledger: Optional[dict] = None,
                        fill: Optional[float] = None) -> None:
        """One finished request (called by RequestTrace.finish)."""
        now = self.clock()
        slo = self._slos.get(model)
        over = bool(slo and slo.target_p99_ms is not None
                    and latency_s * 1e3 > slo.target_p99_ms)
        ok = outcome == "ok"
        with self._lock:
            w = self._models.get((model, role))
            if w is None:
                w = self._models[(model, role)] = \
                    _ModelWindow(self.max_samples)
            w.samples.append((now, latency_s, ok, over))
            if fill is not None:
                w.fills.append(float(fill))
            self._heartbeat[model] = now
        self._m_requests.labels(model=model, role=role,
                                outcome=outcome).inc()
        self._m_latency.labels(model=model, role=role).observe(latency_s)
        self._m_heartbeat.labels(model=model).set(now)
        if outcome == "shed":
            self._m_shed.labels(model=model).inc()
        if ledger and role == "primary":
            for cat, secs in ledger.get("badputSeconds", {}).items():
                if secs:
                    self._m_badput.labels(model=model,
                                          category=cat).inc(secs)
            with self._lock:
                acc = self._goodput_acc.setdefault(model, [0.0, 0.0])
                acc[0] += ledger.get("goodputSeconds", 0.0)
                acc[1] += ledger.get("wallSeconds", 0.0)
                ratio = acc[0] / acc[1] if acc[1] else 0.0
            self._m_goodput.labels(model=model).set(round(ratio, 6))

    # ----------------------------------------------------------- publishing

    def _window_stats(self, w: _ModelWindow, now: float,
                      window_s: float) -> dict:
        # copy under the lock: a request thread appending to the deque
        # while the scrape path iterates it would raise (deque
        # mutated-during-iteration) and 500 the /metrics render
        with self._lock:
            samples = list(w.samples)
        cutoff = now - window_s
        lats = []
        errors = over = 0
        for t, lat, ok, ov in samples:
            if t < cutoff:
                continue
            lats.append(lat)
            if not ok:
                errors += 1
            if ov:
                over += 1
        lats.sort()
        n = len(lats)
        return {
            "n": n,
            "p50": gp._percentile(lats, 0.50),
            "p99": gp._percentile(lats, 0.99),
            "errorRatio": errors / n if n else 0.0,
            "overSloRatio": over / n if n else 0.0,
        }

    def _burn_rates(self, model: str, w: _ModelWindow,
                    now: float) -> dict:
        """{window_label: {"latency": burn, "availability": burn}} for
        the configured windows, only for declared SLOs."""
        slo = self._slos.get(model)
        if slo is None:
            return {}
        out = {}
        for win in self.windows:
            stats = self._window_stats(w, now, win)
            burns = {}
            if slo.target_p99_ms is not None:
                burns["latency"] = stats["overSloRatio"] / _P99_BUDGET
            if slo.availability is not None:
                budget = max(1e-9, 1.0 - slo.availability)
                burns["availability"] = stats["errorRatio"] / budget
            if burns:
                out[f"{int(win)}s"] = burns
        return out

    def refresh(self) -> None:
        """Recompute the derived gauges (rolling percentiles, error
        ratio, queue depth/age, burn rates) — called at scrape and
        healthz time, never on the request hot path."""
        now = self.clock()
        with self._lock:
            models = dict(self._models)
            queues = dict(self._queues)
            inflight = dict(self._inflight)
        # the default rolling window for the headline gauges is the
        # middle burn window (5 min): long enough to be stable, short
        # enough that a recovered replica's gauges recover too
        headline = self.windows[min(1, len(self.windows) - 1)]
        for (model, role), w in models.items():
            stats = self._window_stats(w, now, headline)
            self._m_p50.labels(model=model, role=role).set(
                round(stats["p50"], 6))
            self._m_p99.labels(model=model, role=role).set(
                round(stats["p99"], 6))
            self._m_err.labels(model=model, role=role).set(
                round(stats["errorRatio"], 6))
            if role == "primary":
                with self._lock:
                    fills = list(w.fills)
                if fills:
                    self._m_fill.labels(model=model).set(
                        round(sum(fills) / len(fills), 4))
                for win_label, burns in self._burn_rates(
                        model, w, now).items():
                    for slo_name, burn in burns.items():
                        self._m_burn.labels(
                            model=model, slo=slo_name,
                            window=win_label).set(round(burn, 4))
        self._m_uptime.set(round(self.uptime_seconds(), 3))
        self._m_draining.set(1 if self.draining else 0)
        for model, count in inflight.items():
            self._m_inflight.labels(model=model).set(count)
        for model, batcher in queues.items():
            depth = oldest = 0.0
            try:
                depth = batcher.queue_depth()
                oldest = batcher.oldest_wait_s()
            except Exception:  # noqa: BLE001 — a dead batcher must
                pass           # not kill the scrape
            self._m_qdepth.labels(model=model).set(depth)
            self._m_oldest.labels(model=model).set(round(oldest, 4))

    def snapshot(self) -> dict:
        """The /healthz?verbose=1 body: per-model health the router
        and autoscaler poll — compact, one JSON object. Computes its
        own rolling stats; the Prometheus gauges are refreshed on the
        /metrics scrape path (refresh()), not here — a 1 Hz health
        poller must not pay the window recomputation twice."""
        now = self.clock()
        with self._lock:
            models = dict(self._models)
            queues = dict(self._queues)
            inflight = dict(self._inflight)
            heartbeat = dict(self._heartbeat)
            slos = dict(self._slos)
            start_kind = dict(self._start_kind)
            goodput_acc = {m: (a[0] / a[1] if a[1] else 0.0)
                           for m, a in self._goodput_acc.items()}
        headline = self.windows[min(1, len(self.windows) - 1)]
        out: dict = {}
        for (model, role), w in sorted(models.items()):
            stats = self._window_stats(w, now, headline)
            entry = out.setdefault(model, {
                "model": model,
                "startKind": start_kind.get(model, ""),
                "inFlight": inflight.get(model, 0),
                "lastRequestAgeSeconds": round(
                    now - heartbeat[model], 3)
                if model in heartbeat else None,
            })
            block = {
                "requests": stats["n"],
                "p50Ms": round(stats["p50"] * 1e3, 3),
                "p99Ms": round(stats["p99"] * 1e3, 3),
                "errorRatio": round(stats["errorRatio"], 6),
            }
            if role == "primary":
                entry.update(block)
                with self._lock:
                    fills = list(w.fills)
                entry["meanFill"] = round(
                    sum(fills) / len(fills), 4) if fills else None
                entry["goodputRatio"] = round(
                    goodput_acc.get(model, 0.0), 6)
                slo = slos.get(model)
                if slo is not None:
                    entry["slo"] = slo.to_dict()
                    entry["burnRates"] = {
                        win: {k: round(v, 4) for k, v in burns.items()}
                        for win, burns in
                        self._burn_rates(model, w, now).items()}
            else:
                entry.setdefault("roles", {})[role] = block
        for model, batcher in queues.items():
            entry = out.setdefault(model, {"model": model})
            try:
                entry["queueDepth"] = batcher.queue_depth()
                entry["oldestWaitSeconds"] = round(
                    batcher.oldest_wait_s(), 4)
            except Exception:  # noqa: BLE001
                pass
        return {"models": sorted(out.values(),
                                 key=lambda m: m["model"]),
                "windowSeconds": headline,
                # the fleet-router contract: stop routing to a draining
                # replica; spot a freshly-restarted (cold) one
                "draining": self.draining,
                "uptimeSeconds": round(self.uptime_seconds(), 3)}

    def prune(self, live_models) -> None:
        """Drop every series for models no longer loaded — a router
        must never read frozen stats for a gone model (the
        kftpu_job_phase pruning rule)."""
        live = set(live_models)
        with self._lock:
            gone_keys = [k for k in self._models if k[0] not in live]
            gone = {k[0] for k in gone_keys}
            roles = {}
            for model, role in gone_keys:
                roles.setdefault(model, set()).add(role)
                del self._models[(model, role)]
            for model in gone:
                self._slos.pop(model, None)
                self._start_kind.pop(model, None)
                self._inflight.pop(model, None)
                self._heartbeat.pop(model, None)
                self._queues.pop(model, None)
                self._goodput_acc.pop(model, None)
            slo_windows = [f"{int(w)}s" for w in self.windows]
        for model, model_roles in roles.items():
            for role in model_roles:
                for fam in (self._m_p50, self._m_p99, self._m_err):
                    fam.remove(model=model, role=role)
                for outcome in ("ok", "error", "shed", "drained"):
                    self._m_requests.remove(model=model, role=role,
                                            outcome=outcome)
                self._m_latency.remove(model=model, role=role)
            for fam in (self._m_inflight, self._m_qdepth,
                        self._m_oldest, self._m_fill, self._m_goodput,
                        self._m_shed, self._m_heartbeat):
                fam.remove(model=model)
            for cat in gp.SERVING_BADPUT_CATEGORIES:
                self._m_badput.remove(model=model, category=cat)
            for kind in ("cold", "warm", "aot"):
                self._m_start_kind.remove(model=model, kind=kind)
            for slo_name in ("latency", "availability"):
                for win in slo_windows:
                    self._m_burn.remove(model=model, slo=slo_name,
                                        window=win)
