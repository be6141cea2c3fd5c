"""Per-request tracing: one request id from accept to respond.

The port's copy of kubeflow_tpu/serving/request_trace.py. A **request
id** is minted at accept (honoring an inbound ``x-request-id`` header,
echoed on the response) and used as the span ``trace_id``, so
``load_spans(sink, trace_id=request_id)`` rebuilds one request's
timeline from the JSONL alone: accept → queue → batch-form → h2d →
device → drain → respond.

Cost discipline: every request emits exactly ONE ``serving-request``
summary span carrying its full ledger (obs/goodput.py
decompose_request); the per-stage detail spans are **sampled**
(``sample_every``, plus any request whose inbound id arrives with an
``x-request-sample`` header). Stage *seconds* are accumulated for
every request regardless (two float adds per stage) so the ledger, the
replica registry, and the SLO burn tracking never depend on sampling.
With no span sink configured the writer is None and nothing is emitted
at all.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Optional

from ..obs import goodput as gp
from ..obs import trace as obstrace

# inbound/outbound header carrying the request id (lowercase; http
# header lookup is case-insensitive, gRPC metadata keys must be lower)
REQUEST_ID_HEADER = "x-request-id"

# remaining-deadline budget header: seconds the caller will still wait
# for THIS attempt. The fleet router (serving/fleet.py) decrements it
# across failover retries so retrying can never exceed what the client
# asked for; the model server bounds its batcher wait by it (a request
# whose client is gone must not compute for nobody).
DEADLINE_HEADER = "x-request-deadline"

# stage span name → ledger category (device splits goodput/pad_waste
# by fill, handled in RequestTrace.device)
_STAGE_CATEGORY = {
    "queue": gp.SERVING_QUEUE,
    "batch-form": gp.SERVING_BATCH_FORM,
    "h2d": gp.SERVING_H2D,
    "drain": gp.SERVING_RESPOND,
    "respond": gp.SERVING_RESPOND,
}


def mint_request_id() -> str:
    return uuid.uuid4().hex[:16]


class RequestTrace:
    """One request's context: id, stage ledger, sampled span emission.

    Stage methods are called from two threads — the server handler
    (accept/respond) and the batcher loop (queue/batch-form/h2d/
    device/drain) — but never concurrently for the same stage; the
    future hand-off orders them. ``finish`` is idempotent."""

    __slots__ = ("obs", "request_id", "model", "role", "sampled",
                 "t_accept", "t_pipeline_end", "stages", "attrs",
                 "_done")

    def __init__(self, obs: "ServingObs", request_id: str, model: str,
                 role: str = "primary", sampled: bool = False):
        self.obs = obs
        self.request_id = request_id
        self.model = model
        self.role = role
        self.sampled = sampled
        self.t_accept = time.time()
        # the batcher stamps when its pipeline finished (drain end) so
        # the handler's respond stage starts THERE — the future-wakeup
        # gap is response-path time, not unattributed residual
        self.t_pipeline_end: Optional[float] = None
        self.stages: dict = {}
        self.attrs: dict = {}
        self._done = False
        if sampled and obs.writer is not None:
            obs.writer.emit("accept", start=self.t_accept,
                            trace_id=request_id, model=model, role=role)

    # ------------------------------------------------------------- stages

    def stage(self, name: str, start: float, end: float,
              seconds: Optional[float] = None, **attrs) -> None:
        """Record one stage: ``seconds`` (default end-start) lands in
        the ledger under the stage's category; a sampled request also
        emits the span. Shared-cohort stages (batch-form/h2d/drain)
        pass their prorated share as ``seconds`` while the span keeps
        the cohort's real interval."""
        secs = (end - start) if seconds is None else seconds
        cat = _STAGE_CATEGORY.get(name)
        if cat is not None and secs > 0:
            self.stages[cat] = self.stages.get(cat, 0.0) + secs
        if self.sampled and self.obs.writer is not None:
            self.obs.writer.emit(name, start=start, end=end,
                                 trace_id=self.request_id,
                                 model=self.model, role=self.role,
                                 **attrs)

    def device(self, start: float, end: float, goodput_s: float,
               pad_waste_s: float, **attrs) -> None:
        """The device stage: this request's real-work share is serving
        goodput, its share of the cohort's pad rows is pad_waste."""
        if goodput_s > 0:
            self.stages[gp.SERVING_DEVICE] = \
                self.stages.get(gp.SERVING_DEVICE, 0.0) + goodput_s
        if pad_waste_s > 0:
            self.stages[gp.SERVING_PAD_WASTE] = \
                self.stages.get(gp.SERVING_PAD_WASTE, 0.0) + pad_waste_s
        if self.sampled and self.obs.writer is not None:
            self.obs.writer.emit("device", start=start, end=end,
                                 trace_id=self.request_id,
                                 model=self.model, role=self.role,
                                 goodput_s=round(goodput_s, 6),
                                 pad_waste_s=round(pad_waste_s, 6),
                                 **attrs)

    def note(self, **attrs) -> None:
        """Attach attrs (batch id, fill, bucket) to the summary span."""
        self.attrs.update(attrs)

    # -------------------------------------------------------------- finish

    def finish(self, outcome: str = "ok",
               error: Optional[str] = None) -> dict:
        """Close the request: compute the ledger (exact partition of
        accept→now), emit the always-on summary span, and feed the
        replica registry. Returns the ledger. Idempotent — the first
        caller wins (the error path and a finally block may race)."""
        if self._done:
            return {}
        self._done = True
        t_end = time.time()
        wall = max(0.0, t_end - self.t_accept)
        if outcome == "shed":
            # a shed request never reached the batcher's queue-stamp:
            # its whole unattributed stretch IS queue pressure (the
            # bounded queue turned it away) — charge it there, not to
            # the other residual
            attributed = sum(self.stages.values())
            self.stages[gp.SERVING_QUEUE] = \
                self.stages.get(gp.SERVING_QUEUE, 0.0) + \
                max(0.0, wall - attributed)
        ledger = gp.decompose_request(wall, self.stages)
        if self.obs.writer is not None:
            attrs = {"model": self.model, "role": self.role,
                     "outcome": outcome, "ledger": ledger, **self.attrs}
            if error:
                attrs["error"] = error
            slo = self.obs.slo_p99_ms(self.model)
            if slo is not None:
                attrs["slo_p99_ms"] = slo
            self.obs.writer.emit(gp.SERVING_REQUEST_SPAN,
                                 start=self.t_accept, end=t_end,
                                 trace_id=self.request_id, **attrs)
        if self.obs.replica is not None:
            self.obs.replica.observe_request(
                self.model, wall, outcome=outcome, role=self.role,
                ledger=ledger, fill=self.attrs.get("fill"))
        return ledger


class ServingObs:
    """The model server's request-observability facade: mints
    RequestTraces, owns the span writer + replica registry handle, and
    decides sampling. One per ModelServer (batch_predict makes its
    own); routers share the server's via ``RoutedModel.request_obs``
    so shadow copies trace into the same sink."""

    def __init__(self, replica=None, span_path: Optional[str] = None,
                 component: str = "serving", sample_every: int = 16,
                 slos: Optional[dict] = None):
        if span_path:
            self.writer = obstrace.SpanWriter(span_path, component)
            self._own_writer = True
        else:
            # env-driven (KFTPU_SPAN_PATH, the operator-rendered
            # contract); None = tracing off, zero emission cost
            self.writer = obstrace.default_tracer(component)
            self._own_writer = False
        self.replica = replica
        self.sample_every = max(0, int(sample_every))
        # model → target p99 ms (the declarative SLO; availability
        # lives on the replica registry where the burn windows are)
        self._slos = dict(slos or {})
        self._lock = threading.Lock()
        self._accepted = 0

    def slo_p99_ms(self, model: str) -> Optional[float]:
        # the replica registry is the single SLO source when present
        # (the server feeds it from the manifest-declared targets);
        # the local dict covers registry-less uses (batch_predict)
        if self.replica is not None:
            slo = self.replica.slo_of(model)
            if slo is not None and slo.target_p99_ms is not None:
                return float(slo.target_p99_ms)
            if slo is not None:
                return None
        slo = self._slos.get(model)
        return None if slo is None else float(slo)

    def set_slo(self, model: str, p99_ms: Optional[float]) -> None:
        if p99_ms is None:
            self._slos.pop(model, None)
        else:
            self._slos[model] = float(p99_ms)

    def begin(self, model: str, request_id: Optional[str] = None,
              role: str = "primary",
              force_sample: bool = False) -> RequestTrace:
        """Start one request's trace. ``request_id`` is the honored
        inbound ``x-request-id`` (minted otherwise)."""
        with self._lock:
            self._accepted += 1
            sampled = force_sample or (
                self.sample_every > 0
                and (self._accepted - 1) % self.sample_every == 0)
        return RequestTrace(self, request_id or mint_request_id(),
                            model, role=role,
                            sampled=sampled and self.writer is not None)

    def close(self) -> None:
        # default_tracer-owned writers are process-cached and shared;
        # only close a writer this instance constructed itself
        if self._own_writer and self.writer is not None:
            self.writer.close()
