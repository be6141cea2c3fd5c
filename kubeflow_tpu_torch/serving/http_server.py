"""REST model server: the TF-Serving-compatible HTTP surface.

The port of ``kubeflow_tpu/serving/http_server.py``:

- ``GET  /v1/models/<name>``            → version status
- ``GET  /v1/models/<name>/metadata``   → signature metadata
- ``POST /v1/models/<name>:predict``    → {"instances": [...]} →
  {"predictions": [...]}
- ``GET  /v1/routers/<name>``           → an experiment router's arm stats
- ``POST /v1/routers/<name>:predict``   → predict through the chosen arm
- ``POST /v1/routers/<name>:feedback``  → {"arm", "reward"}
- ``GET  /healthz`` (``?verbose=1``: the replica health snapshot) and
  ``GET /metrics`` (Prometheus text).

stdlib ThreadingHTTPServer: requests are I/O-light; the device work is
serialized by the per-model MicroBatcher. ``main()`` also serves
TF-Serving's PredictionService over gRPC (serving/grpc_server.py) on
``--grpc-port`` (default 9000) where grpcio is installed, on the same
MicroBatchers.

    python -m kubeflow_tpu_torch.serving.http_server \
        --model-type transformer_lm --attention flash --rest-port 8500
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..obs.registry import Registry
from .batcher import MicroBatcher, QueueFullError
from .replica_state import ModelSLO, ReplicaState
from .request_trace import (DEADLINE_HEADER, REQUEST_ID_HEADER,
                            ServingObs, mint_request_id)
from .servable import ModelRepository


class ModelServer:
    def __init__(self, repository: Optional[ModelRepository] = None,
                 host: str = "0.0.0.0", port: int = 8500,
                 max_batch: int = 64, max_latency_ms: float = 5.0,
                 max_pending: int = 0, sample_every: int = 16,
                 span_path: Optional[str] = None,
                 slos: Optional[dict] = None,
                 drain_timeout_s: float = 10.0,
                 batching: str = "continuous",
                 max_wait_ms: Optional[float] = None):
        self.repository = repository or ModelRepository()
        self.host, self.port = host, port
        self.max_batch = max_batch
        self.max_latency_ms = max_latency_ms
        self.max_pending = max_pending
        self.drain_timeout_s = drain_timeout_s
        # batcher admission scheduler: "continuous" = in-flight
        # batching; "window" = the fixed collect window
        self.batching = batching
        self.max_wait_ms = max_wait_ms
        self._batchers: dict[str, MicroBatcher] = {}
        self._batchers_lock = threading.Lock()
        # live handler connections, for kill() (simulated SIGKILL:
        # in-flight clients see a reset, not a response)
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._killed = False
        # predict answers being written: kill() lets them finish, so a
        # request whose ledger says "ok" was delivered, and one cut by the
        # kill reads "error" (a failover's answer is then its only "ok")
        self._sending = 0
        self._sending_cv = threading.Condition()
        # experiment routers (A/B, bandit, shadow — serving/router.py)
        self.routers: dict[str, object] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # per-server registry (obs/registry.py), not the process default:
        # several ModelServers coexist in one test process and must not
        # share counts. The per-servable totals stay owned by the
        # servables (warmup and direct calls count too) and are bridged
        # into the exposition at scrape time; the REST latency histogram
        # is observed per request.
        self.registry = Registry()
        self._m_requests = self.registry.counter(
            "kubeflow_model_request_count", "requests per servable",
            labels=("model",))
        self._m_predict_s = self.registry.counter(
            "kubeflow_model_predict_seconds_total",
            "cumulative device predict seconds per servable",
            labels=("model",))
        self._m_latency = self.registry.histogram(
            "kubeflow_model_request_seconds",
            "end-to-end REST :predict latency", labels=("model",))
        self._m_exported: set = set()
        # replica health registry + per-request tracing:
        # every finished request feeds the registry; spans ride the
        # explicit span_path or the KFTPU_SPAN_PATH env contract
        self.replica = ReplicaState(self.registry)
        self.obs = ServingObs(replica=self.replica, span_path=span_path,
                              sample_every=sample_every)
        for model, slo in (slos or {}).items():
            self.set_slo(model, slo)

    def set_slo(self, model: str, slo: ModelSLO) -> None:
        """Declare a model's SLO (manifest --slo-p99-ms /
        --slo-availability): burn-rate gauges start tracking it."""
        self.replica.set_slo(model, slo)

    def add_router(self, routed) -> None:
        """Mount a RoutedModel at /v1/routers/<name>; when it serves this
        server's repository, its arms resolve through the server's
        MicroBatchers so routed and direct traffic batch together. A
        caller-set resolver or foreign repository is left alone. The
        router also adopts this server's request observability so its
        shadow copies trace into the same sink with role=shadow."""
        if routed.predict_resolver is None and \
                routed.repository is self.repository:
            routed.predict_resolver = lambda arm: self.batcher(arm).predict
        if routed.request_obs is None:
            routed.request_obs = self.obs
        self.routers[routed.name] = routed

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> int:
        owner = self

        class _Httpd(ThreadingHTTPServer):
            def handle_error(self, request, client_address):
                # a killed server's handler threads die on purpose
                # (OSError on send): no traceback; real errors still print
                if not owner._killed:
                    super().handle_error(request, client_address)

        self._httpd = _Httpd((self.host, self.port), _make_handler(self))
        self.port = self._httpd.server_address[1]  # resolve port 0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="model-server")
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        for b in self._batchers.values():
            b.shutdown()
        self.obs.close()

    def drain(self, timeout_s: Optional[float] = None) -> dict:
        """Graceful drain (the SIGTERM / preStop contract):
        flip readiness (plain /healthz → 503, ``draining: true`` on
        the verbose payload so the fleet router stops sending), reject
        new :predict work with 503 + Retry-After, flush each batcher's
        pending cohort, and wait for in-flight requests to finish — up
        to ``drainTimeoutSeconds``. Idempotent; does NOT stop the
        listener (the caller decides when the process dies). Returns a
        report the soak asserts zero-loss against."""
        timeout_s = self.drain_timeout_s if timeout_s is None else \
            float(timeout_s)
        already = self.replica.draining
        self.replica.set_draining(True)
        inflight_at_start = self.replica.total_inflight()
        deadline = time.monotonic() + max(0.0, timeout_s)
        flushed = failed = 0
        if not already:
            with self._batchers_lock:
                batchers = list(self._batchers.values())
            for b in batchers:
                r = b.drain(timeout_s=max(0.1,
                                          deadline - time.monotonic()))
                flushed += r["flushed"]
                failed += r["failed"]
        # in-flight = accepted but not yet responded; the batcher flush
        # resolved their futures, this waits out response serialization
        while time.monotonic() < deadline and \
                self.replica.total_inflight() > 0:
            time.sleep(0.005)
        return {"draining": True,
                "inFlightAtStart": inflight_at_start,
                "inFlightRemaining": self.replica.total_inflight(),
                "flushed": flushed, "failed": failed,
                "drainTimeoutSeconds": timeout_s}

    def kill(self) -> None:
        """Simulated SIGKILL (the chaos replica-crash fault,
        cluster/chaos.py): close the listener and every live connection
        with NO drain — in-flight clients see a reset or an empty
        response, queued work is abandoned. Only answers already being
        written finish first, so every request the ledger counts "ok"
        reached its client (the soak's no-duplicate audit reads the
        ledger). Real code never calls this; the soak does, to prove the
        fleet survives it."""
        with self._sending_cv:
            self._killed = True
            self._sending_cv.wait_for(lambda: self._sending == 0,
                                      timeout=10.0)
        if self._httpd:
            self._httpd.shutdown()
            # don't wait for handler threads — SIGKILL wouldn't
            self._httpd.block_on_close = False
            self._httpd.server_close()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    # -- dispatch -----------------------------------------------------------

    def batcher(self, name: str) -> MicroBatcher:
        servable = self.repository.get(name)
        # check-then-set under a lock: handler threads race on first
        # request, and a losing MicroBatcher would leak its poll thread
        with self._batchers_lock:
            b = self._batchers.get(name)
            if b is None:
                b = MicroBatcher(servable, max_batch=self.max_batch,
                                 max_latency_ms=self.max_latency_ms,
                                 max_pending=self.max_pending,
                                 batching=self.batching,
                                 max_wait_ms=self.max_wait_ms)
                self._batchers[name] = b
                # queue depth + oldest-age gauges: scrape-time pull
                self.replica.register_queue(name, b)
        return b

    def metrics_text(self) -> str:
        """The standard exposition off the shared registry (names
        wire-compatible with the pre-registry hand-rolled text): the
        servable-owned totals are snapshotted in, the request-latency
        histogram is already live."""
        names = set(self.repository.names())
        # a model unloaded from the repository must stop exporting (its
        # frozen last totals would read as live — and as a counter reset
        # if the name is later re-added from zero)
        for gone in self._m_exported - names:
            self._m_requests.remove(model=gone)
            self._m_predict_s.remove(model=gone)
            self._m_latency.remove(model=gone)
        self._m_exported = names
        for name in names:
            servable = self.repository.get(name)
            meta = servable.metadata()["stats"]
            self._m_requests.labels(model=name).set(meta["request_count"])
            self._m_predict_s.labels(model=name).set(
                round(meta["predict_seconds"], 6))
            self.replica.set_start_kind(
                name, getattr(servable, "start_kind", "cold"))
        # the replica registry prunes its own series for gone models
        # and recomputes the rolling gauges + burn rates at scrape time
        self.replica.prune(names)
        self.replica.refresh()
        return self.registry.render()


def _make_handler(server: ModelServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def setup(self):
            super().setup()
            with server._conns_lock:
                server._conns.add(self.connection)

        def finish(self):
            with server._conns_lock:
                server._conns.discard(self.connection)
            try:
                super().finish()
            except OSError:
                pass  # connection already torn down by kill()

        def _send(self, code: int, payload, content_type="application/json",
                  headers: Optional[dict] = None, committed: bool = False):
            if server._killed and not committed:
                # simulated SIGKILL: the response must never leave — the
                # client sees a dead connection, not a late answer
                raise OSError("server killed")
            body = (payload if isinstance(payload, bytes)
                    else json.dumps(payload).encode())
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, msg: str,
                   headers: Optional[dict] = None):
            try:
                self._send(code, {"error": msg}, headers=headers)
            except OSError:
                # the client gave up (deadline timeout, hedge winner
                # elsewhere) — a late error answer has nobody to read
                # it; the ledger already recorded the outcome
                pass

        def do_GET(self):
            path, _, rawq = self.path.partition("?")
            path = path.rstrip("/")
            if path == "/healthz":
                if "verbose=1" in rawq:
                    # the replica-health contract the router and
                    # autoscaler poll (serving/replica_state.py) —
                    # always 200: a draining replica must still be
                    # pollable (the payload carries `draining`)
                    return self._send(200, server.replica.snapshot())
                if "live=1" in rawq:
                    # liveness: the process is up — stays 200 through a
                    # drain so the kubelet doesn't kill a pod that is
                    # gracefully finishing its in-flight work
                    return self._send(200, {"status": "ok"})
                if server.replica.draining:
                    # readiness flip: endpoints controller pulls this
                    # pod out of the Service before it dies
                    return self._send(503, {"status": "draining"})
                return self._send(200, {"status": "ok"})
            if path == "/drain":
                # the preStop hook (manifests/serving.py renders an
                # httpGet here): synchronous bounded drain, so the
                # kubelet holds SIGTERM until in-flight work finished
                return self._send(200, server.drain())
            if path == "/metrics":
                return self._send(200, server.metrics_text().encode(),
                                  content_type="text/plain")
            if path.startswith("/v1/routers/"):
                name = path[len("/v1/routers/"):]
                routed = server.routers.get(name)
                if routed is None:
                    return self._error(404, f"router {name!r} not found")
                return self._send(200, routed.status())
            if path.startswith("/v1/models/"):
                rest = path[len("/v1/models/"):]
                try:
                    if rest.endswith("/metadata"):
                        name = rest[:-len("/metadata")]
                        return self._send(
                            200, server.repository.get(name).metadata())
                    return self._send(
                        200, server.repository.get(rest).status())
                except KeyError as e:
                    return self._error(404, str(e))
            self._error(404, f"no route {path}")

        def _read_body(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length))

        def _parse_instances(self, req: dict) -> np.ndarray:
            if "instances" not in req:
                raise ValueError("missing 'instances' in request")
            instances = np.asarray(req["instances"])
            if "dtype" in req:
                instances = instances.astype(req["dtype"])
            return instances

        def _request_id(self) -> str:
            """Honor an inbound x-request-id (echoed on the response);
            mint otherwise — one id stamps every stage span."""
            return self.headers.get(REQUEST_ID_HEADER) or mint_request_id()

        def _force_sample(self) -> bool:
            """``x-request-sample: 1`` forces stage spans for THIS
            request regardless of the sampling cadence — the debug
            handle for 'reconstruct this exact request'."""
            return self.headers.get("x-request-sample") == "1"

        def _run_predict(self, predict, req: dict, ctx=None,
                         rid: Optional[str] = None,
                         deadline: Optional[float] = None):
            """Shared predict body: parse instances, run, serialize,
            finish the request, send — one implementation for every
            predict endpoint. Instance decode is charged to batch-form
            (it IS forming the device input); the respond stage runs
            from the batcher's pipeline end (so the future-wakeup gap is
            respond time, not residual) through serialization. The
            request context is finished (ledger, replica registry)
            before the response bytes are written, so a client that
            reads the registry after its response finds its request
            counted; a kill() waits for these writes, and one that came
            first turns the answer into an error (the client sees a
            dead connection). Past ``deadline`` (this module's monotonic
            clock: the request's arrival plus the caller's deadline
            budget) the caller has given up and may be retrying
            elsewhere, so the answer is not committed: it raises the
            deadline's timeout and the request reads as an error, never
            as a second ok."""
            t_parse = time.time()
            instances = self._parse_instances(req)
            if ctx is not None:
                ctx.stage("batch-form", t_parse, time.time(),
                          decode=True)
            out = predict(instances)
            t_resp = time.time()
            if ctx is not None and ctx.t_pipeline_end is not None:
                t_resp = min(t_resp, max(ctx.t_pipeline_end,
                                         ctx.t_accept))
            predictions = {
                k: np.asarray(v).tolist() for k, v in out.items()
            } if isinstance(out, dict) else np.asarray(out).tolist()
            with server._sending_cv:
                if server._killed:
                    raise OSError("server killed")
                if deadline is not None and time.monotonic() >= deadline:
                    raise FuturesTimeoutError()
                server._sending += 1
            try:
                if ctx is not None:
                    ctx.stage("respond", t_resp, time.time())
                    ctx.finish("ok")
                self._send(200, {"predictions": predictions},
                           headers={REQUEST_ID_HEADER: rid} if rid else None,
                           committed=True)
            finally:
                with server._sending_cv:
                    server._sending -= 1
                    server._sending_cv.notify_all()

        def _deadline_s(self) -> Optional[float]:
            """The client's remaining deadline budget (the
            ``x-request-deadline`` contract: seconds the caller will
            still wait — serving/request_trace.py). Malformed reads as
            absent."""
            raw = self.headers.get(DEADLINE_HEADER)
            if raw is None:
                return None
            try:
                return max(0.0, float(raw))
            except (TypeError, ValueError):
                return None

        def do_POST(self):
            if self.path.rstrip("/") == "/drain":
                return self._send(200, server.drain())
            if ":" not in self.path:
                return self._error(404, "expected /v1/models/<name>:predict")
            route, verb = self.path.rsplit(":", 1)
            if route.startswith("/v1/routers/"):
                return self._router_post(route[len("/v1/routers/"):], verb)
            if not route.startswith("/v1/models/") or verb != "predict":
                return self._error(404, f"no route {self.path}")
            name = route[len("/v1/models/"):]
            t_arrival = time.monotonic()
            rid = self._request_id()
            hdr = {REQUEST_ID_HEADER: rid}
            if server.replica.draining:
                # draining: refuse new work with an explicit retryable
                # 503 — the fleet router re-routes to a live replica
                return self._error(503, "draining",
                                   headers={**hdr, "Retry-After": "1"})
            ctx = None
            try:
                req = self._read_body()
                try:
                    batcher = server.batcher(name)
                except KeyError as e:  # unknown model only → 404
                    return self._error(404, str(e), headers=hdr)
                # the deadline budget bounds how long this request may
                # wait on the batcher future: past it the client is
                # gone — answer 504 instead of computing for nobody
                deadline_s = self._deadline_s()
                timeout = 30.0 if deadline_s is None \
                    else max(0.001, deadline_s)
                # the caller's budget runs from this request's arrival
                commit_by = None if deadline_s is None \
                    else t_arrival + timeout
                ctx = server.obs.begin(name, request_id=rid,
                                       force_sample=self._force_sample())
                server.replica.inflight_inc(name)
                t0 = time.perf_counter()
                try:
                    self._run_predict(
                        lambda x: batcher.predict(x, timeout=timeout,
                                                  ctx=ctx), req,
                        ctx=ctx, rid=rid, deadline=commit_by)
                finally:
                    server.replica.inflight_dec(name)
                    # errors are latency too (clients waited for them)
                    server._m_latency.labels(model=name).observe(
                        time.perf_counter() - t0)
            except QueueFullError as e:
                # bounded-queue shed: explicit 429, recorded in the
                # ledger (all-queue badput), never silently dropped.
                # Retry-After carries the drain-rate hint:
                # come back when the backlog you were shed behind has
                # drained, not at the client's blind jitter cadence.
                if ctx is not None:
                    ctx.finish("shed", error=str(e))
                self._error(429, f"QueueFullError: {e}", headers={
                    **hdr, "Retry-After":
                        f"{getattr(e, 'retry_after_s', 1.0):.1f}"})
            except FuturesTimeoutError:
                if ctx is not None:
                    ctx.finish("error", error="deadline exceeded")
                self._error(504, "deadline exceeded", headers=hdr)
            except Exception as e:  # noqa: BLE001 — surface to client
                if ctx is not None:
                    ctx.finish("error", error=f"{type(e).__name__}: {e}")
                # an exception may carry its own HTTP status (the chaos
                # 5xx-burst fault rides this; 5xx reads as retryable
                # weather to the fleet router, 400 stays meaning)
                code = int(getattr(e, "http_status", 400))
                self._error(code, f"{type(e).__name__}: {e}", headers=hdr)

        def _router_post(self, name: str, verb: str):
            """/v1/routers/<name>:predict and :feedback."""
            routed = server.routers.get(name)
            if routed is None:
                return self._error(404, f"router {name!r} not found")
            rid = self._request_id()
            hdr = {REQUEST_ID_HEADER: rid}
            ctx = None
            try:
                req = self._read_body()
                if verb == "feedback":
                    routed.record_feedback(req["arm"], float(req["reward"]))
                    return self._send(200, routed.status())
                if verb != "predict":
                    return self._error(404, f"unknown verb {verb!r}")
                # the router stamps the chosen arm onto the ctx once
                # routed; the span's model is the ARM, attrs carry the
                # router name (serving/router.py)
                ctx = server.obs.begin(f"router:{name}", request_id=rid,
                                       force_sample=self._force_sample())
                self._run_predict(
                    lambda x: routed.predict(x, ctx=ctx), req,
                    ctx=ctx, rid=rid)
            except QueueFullError as e:
                if ctx is not None:
                    ctx.finish("shed", error=str(e))
                self._error(429, f"QueueFullError: {e}", headers={
                    **hdr, "Retry-After":
                        f"{getattr(e, 'retry_after_s', 1.0):.1f}"})
            except Exception as e:  # noqa: BLE001 — surface to client
                if ctx is not None:
                    ctx.finish("error", error=f"{type(e).__name__}: {e}")
                self._error(400, f"{type(e).__name__}: {e}", headers=hdr)

    return Handler


def serve(argv: Optional[list[str]] = None) -> dict:
    """The model server process up to the point where it serves: parse
    the flags (the JAX package's, plus ``--device`` and ``--attention``),
    point the kernel builds at the compile cache, load and warm the
    model, start REST and, where grpcio is installed, gRPC. Returns
    ``{"args", "repo", "servable", "server", "grpc"}`` (``grpc`` None
    when off); ``main()`` then waits for SIGTERM."""
    import argparse
    p = argparse.ArgumentParser("tpu-model-server")
    p.add_argument("--model-name", default="model")
    p.add_argument("--model-type", default="resnet50",
                   help="registered model builder: resnet18 ... resnet152 "
                        "or transformer_lm")
    p.add_argument("--model-path", default="")
    p.add_argument("--rest-port", type=int, default=8500)
    p.add_argument("--grpc-port", type=int, default=9000,
                   help="TF-Serving-compatible PredictionService port "
                        "(0 disables; without grpcio only REST serves)")
    p.add_argument("--attention", default=None, choices=["einsum", "flash"],
                   help="transformer_lm's attention: einsum (the model's "
                        "default) or the flash-attention kernel")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; raises "
                        "when no card is present)")
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--reload-interval", "--poll-interval", type=float,
                   default=30.0,
                   help="with --model-path, poll the checkpoint directory "
                        "every this many seconds and serve a newer intact "
                        "step as the next version (0 = never)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running a zero batch through each padded "
                        "bucket at load (the first request then pays the "
                        "kernel build and allocator warm-up)")
    p.add_argument("--kernel-serving", default=None,
                   choices=["stock", "int8"],
                   help="serving kernel tier (spec.kernels.serving): "
                        "int8 = per-channel absmax quantized weights "
                        "behind the accuracy parity gate (default "
                        "$KFTPU_KERNEL_SERVING or stock)")
    p.add_argument("--int8-max-delta", type=float, default=None,
                   help="parity-gate threshold for --kernel-serving "
                        "int8: refuse to serve when the measured "
                        "argmax-disagreement delta exceeds this "
                        "(default $KFTPU_INT8_MAX_DELTA or 0.02)")
    p.add_argument("--batching", default="continuous",
                   choices=["continuous", "window"],
                   help="batcher admission scheduler: 'continuous' = "
                        "in-flight batching (the next batch forms from "
                        "everything queued the moment the previous "
                        "dispatch returns), 'window' = the fixed "
                        "collect window")
    p.add_argument("--max-wait-ms", type=float, default=None,
                   help="continuous batching's idle-device coalescing "
                        "bound: how long a lone request may hold for "
                        "co-riders when the device is idle (default: "
                        "the --max-latency window value; under load "
                        "nobody waits)")
    p.add_argument("--max-latency", type=float, default=5.0,
                   help="window mode's collect window in ms (and the "
                        "max-wait default for continuous mode)")
    p.add_argument("--max-pending", type=int, default=0,
                   help="bounded batcher queue: shed with 429 past this "
                        "many waiting requests (0 = unbounded; sheds "
                        "carry a drain-rate Retry-After hint)")
    p.add_argument("--sample-every", type=int, default=16,
                   help="emit per-stage trace spans for every Nth "
                        "request (the ledger summary span is always "
                        "emitted; 0 = summaries only)")
    p.add_argument("--span-path", default=None,
                   help="request-span JSONL sink (default: the "
                        "KFTPU_SPAN_PATH env contract)")
    p.add_argument("--slo-p99-ms", type=float, default=None,
                   help="declarative latency SLO: target p99 in ms "
                        "(burn-rate gauges on /metrics)")
    p.add_argument("--slo-availability", type=float, default=None,
                   help="declarative availability SLO target, e.g. "
                        "0.999")
    p.add_argument("--drain-timeout", type=float, default=10.0,
                   help="graceful-drain budget in seconds: on SIGTERM "
                        "(or GET /drain, the preStop hook) readiness "
                        "flips, new work is refused with 503, the "
                        "batcher's pending cohort flushes, and "
                        "in-flight requests get this long to finish "
                        "before the process exits")
    args = p.parse_args(argv)
    model_kw = {}
    if args.attention is not None:
        if args.model_type != "transformer_lm":
            p.error("--attention applies to --model-type transformer_lm")
        model_kw["attention"] = args.attention

    # warm restarts load their kernels from the build cache
    # (KFTPU_COMPILE_CACHE_DIR, rendered by the serving manifest onto the
    # model volume) instead of running nvcc in warmup()
    from ..runtime.compile_cache import (compile_stats,
                                         enable_compilation_cache)
    enable_compilation_cache()
    repo = ModelRepository()
    # a QuantizationRefused from the int8 parity gate propagates and
    # kills the server at startup — an operator asking for a quantized
    # tier past its accuracy budget must see the refusal, not a
    # silently-float replica
    servable = repo.load(args.model_name, args.model_type,
                         checkpoint_dir=args.model_path or None,
                         kernels=args.kernel_serving,
                         quant_max_delta=args.int8_max_delta,
                         device=args.device, **model_kw)
    servable.max_batch = args.max_batch
    if args.model_path and args.reload_interval:
        repo.start_polling(args.reload_interval)
    if servable.quant is not None:
        print(f"int8 serving: accuracy delta "
              f"{servable.quant['accuracy_delta']} (gate "
              f"{servable.quant['max_delta']})", flush=True)
    if not args.no_warmup:
        buckets = servable.warmup()
        print(f"warmed buckets {buckets}", flush=True)
    st = compile_stats()
    print(f"start_kind {servable.start_kind}: kernel libraries loaded from "
          f"the build cache {st['cache_hits']} ({st['cache_load_s']:.3f}s), "
          f"nvcc runs {st['xla_backend_compiles']} "
          f"({st['compile_or_load_s'] - st['cache_load_s']:.3f}s)",
          flush=True)
    slos = {}
    if args.slo_p99_ms is not None or args.slo_availability is not None:
        from .replica_state import ModelSLO as _SLO
        slos[args.model_name] = _SLO(target_p99_ms=args.slo_p99_ms,
                                     availability=args.slo_availability)
    server = ModelServer(repo, port=args.rest_port,
                         max_batch=args.max_batch,
                         max_latency_ms=args.max_latency,
                         max_pending=args.max_pending,
                         sample_every=args.sample_every,
                         span_path=args.span_path, slos=slos,
                         drain_timeout_s=args.drain_timeout,
                         batching=args.batching,
                         max_wait_ms=args.max_wait_ms)
    port = server.start()
    grpc_server = None
    if args.grpc_port:
        from .grpc_server import HAVE_GRPC, GrpcPredictServer
        if HAVE_GRPC:
            grpc_server = GrpcPredictServer(
                server, port=args.grpc_port,
                drain_grace_s=args.drain_timeout)
            gport = grpc_server.start()
            print(f"gRPC PredictionService on :{gport}", flush=True)
        else:
            print("grpcio is not installed: serving REST only", flush=True)
    print(f"model server listening on :{port} "
          f"(models: {repo.names()})", flush=True)
    return {"args": args, "repo": repo, "servable": servable,
            "server": server, "grpc": grpc_server}


def main(argv: Optional[list[str]] = None) -> int:
    """CLI: the model server process (``serve()``), until SIGTERM."""
    running = serve(argv)
    args, server, grpc_server = (running["args"], running["server"],
                                 running["grpc"])

    # graceful drain on SIGTERM (the kubelet's pod-stop signal): flip
    # readiness, flush + finish in-flight up to --drain-timeout, THEN
    # die — the fleet router saw `draining` and stopped sending first
    done = threading.Event()

    def _sigterm(signum, frame):
        print("SIGTERM: draining "
              f"(budget {args.drain_timeout:.0f}s)", flush=True)
        report = server.drain()
        print(f"drain: {report}", flush=True)
        if grpc_server:
            grpc_server.stop(grace=args.drain_timeout)
        server.stop()
        done.set()

    import signal
    signal.signal(signal.SIGTERM, _sigterm)
    try:
        done.wait()
    except KeyboardInterrupt:
        if grpc_server:
            grpc_server.stop()
        server.stop()
    running["repo"].stop_polling()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
