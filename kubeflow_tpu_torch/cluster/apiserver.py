"""An HTTP apiserver speaking the Kubernetes REST wire format over any
KubeClient backend.

The port's copy of ``kubeflow_tpu/cluster/apiserver.py``. Two roles:

- **Mock apiserver for tests**: the envtest analog at the wire level —
  HttpKubeClient and the controllers run against it exactly as they
  would against a real apiserver.
- **A FakeCluster as a service**: ``ClusterAPIServer(FakeCluster())``
  exposes an in-memory cluster over HTTP, so manager processes
  (``python -m kubeflow_tpu_torch.controllers --kubeconfig ...``) run as
  real, separate processes against a live endpoint.

Surface (the slice client-go uses, see cluster/wire.py):
GET/POST on collections, GET/PUT/PATCH/DELETE on objects, PUT on /status,
?labelSelector= on list and watch, and ?watch=true chunked JSON-line
streams with BOOKMARK events for filtered-out mutations (so clients can
measure stream catch-up; kube allowWatchBookmarks analog).
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from ..api import k8s
from ..obs import controlplane as ctrlobs
from . import wire
from .client import (AlreadyExistsError, ConflictError, KubeClient,
                     NotFoundError)

log = logging.getLogger(__name__)

# kinds every server recognizes up front (anything else is learned from
# objects POSTed through this server)
_WELL_KNOWN_KINDS = list(k8s.CLUSTER_SCOPED_KINDS) + [
    "Pod", "Service", "StatefulSet", "Deployment", "ConfigMap", "Secret",
    "ServiceAccount", "Role", "RoleBinding", "PersistentVolumeClaim",
    "Event", "ResourceQuota", "Endpoints", "Ingress",
    "HorizontalPodAutoscaler", "TPUJob", "TFJob", "PyTorchJob", "MPIJob",
    "ChainerJob", "MXJob", "PaddleJob", "Notebook", "PodDefault",
    "Workflow", "ScheduledWorkflow", "StudyJob", "KubebenchJob",
    "Application", "VirtualService", "Gateway",
    # leader-election Leases (cluster/lease.py): HA controller replicas
    # coordinate through the same wire surface everything else uses
    "Lease",
]


class ApiError(Exception):
    def __init__(self, code: int, reason: str, message: str):
        super().__init__(message)
        self.code, self.reason, self.message = code, reason, message


def _typed_to_api_error(e: Exception) -> ApiError:
    if isinstance(e, NotFoundError):
        return ApiError(404, "NotFound", str(e))
    if isinstance(e, AlreadyExistsError):
        return ApiError(409, "AlreadyExists", str(e))
    if isinstance(e, ConflictError):
        return ApiError(409, "Conflict", str(e))
    return ApiError(500, "InternalError", f"{type(e).__name__}: {e}")


class ClusterAPIServer:
    """Serve a KubeClient backend over the kube REST wire format."""

    def __init__(self, backend: KubeClient, host: str = "127.0.0.1",
                 port: int = 8443):
        self.backend = backend
        self.host, self.port = host, port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._plural_to_kind: dict[str, str] = {}
        self._known_lock = threading.Lock()
        # resourceVersion high-water mark for BOOKMARKs / delete details:
        # FakeCluster exposes its counter directly; any other backend is
        # tracked from the rvs observed in responses and watch events
        self._rv_high = 0
        # wire-level request ledger (obs/controlplane.py): the SAME
        # vocabulary as FakeCluster's server-side audit, so sim and REST
        # report through one set of (component, verb, kind) rows. The
        # caller's X-Kftpu-Component header attributes the request (and
        # flows through to the backend's own ledger via the contextvar).
        self.audit = ctrlobs.ServerAudit()
        for kind in _WELL_KNOWN_KINDS:
            self.learn_kind(kind)

    # -- resourceVersion tracking -------------------------------------------

    def observe_rv(self, value) -> None:
        try:
            v = int(value)
        except (TypeError, ValueError):
            return
        with self._known_lock:
            if v > self._rv_high:
                self._rv_high = v

    def current_rv(self) -> int:
        n = getattr(self.backend, "_rv_n", None)
        if isinstance(n, int):
            return n
        with self._known_lock:
            return self._rv_high

    # -- kind bookkeeping ---------------------------------------------------

    def learn_kind(self, kind: str) -> None:
        if kind:
            with self._known_lock:
                self._plural_to_kind[wire.plural_of(kind)] = kind

    def kind_for(self, parsed: wire.ParsedPath) -> str:
        with self._known_lock:
            kind = self._plural_to_kind.get(parsed.plural)
        if kind:
            return kind
        raise ApiError(404, "NotFound",
                       f"the server could not find the requested resource "
                       f"(plural {parsed.plural!r})")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> int:
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="kube-apiserver")
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._stopping.set()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


def _make_handler(server: ClusterAPIServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging
            log.debug("apiserver: " + fmt, *args)

        # -- plumbing -------------------------------------------------------

        def _send_json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_error(self, e: ApiError) -> None:
            self._send_json(e.code,
                            wire.status_body(e.code, e.reason, e.message))

        def _read_body(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length)) if length else {}

        @staticmethod
        def _observed(result: dict) -> dict:
            server.observe_rv(result.get("metadata", {})
                              .get("resourceVersion"))
            return result

        # -- dispatch -------------------------------------------------------

        def _dispatch(self, verb: str) -> None:
            split = urlsplit(self.path)
            query = parse_qs(split.query)
            # drain the body up front on mutating verbs: replying before
            # reading it would desync HTTP/1.1 keep-alive connections
            body = None
            if verb in ("POST", "PUT", "PATCH"):
                try:
                    body = self._read_body()
                except (ValueError, json.JSONDecodeError) as e:
                    return self._send_error(
                        ApiError(400, "BadRequest", f"invalid body: {e}"))
            if split.path == "/healthz":
                return self._send_json(200, {"status": "ok"})
            if split.path == "/version":
                return self._send_json(
                    200, {"major": "1", "minor": "29",
                          "gitVersion": "v1.29.0-kubeflow-tpu-sim"})
            parsed = wire.parse_path(split.path)
            if parsed is None:
                return self._send_error(
                    ApiError(404, "NotFound", f"no route {split.path}"))
            # adopt the caller's component for attribution: this
            # handler thread's ledger rows (and the backend's, via the
            # contextvar) land under the caller's name, not unattributed
            comp = self.headers.get(ctrlobs.COMPONENT_HEADER)
            if verb == "GET" and query.get("watch", ["false"])[0] == "true":
                with ctrlobs.attributed(comp) if comp \
                        else contextlib.nullcontext():
                    return self._stream_watch(parsed, query)
            try:
                with ctrlobs.attributed(comp) if comp \
                        else contextlib.nullcontext():
                    self._send_json(200,
                                    self._handle(verb, parsed, query, body))
            except ApiError as e:
                self._send_error(e)
            except ValueError as e:  # bad selector/object → client error
                self._send_error(ApiError(400, "BadRequest", str(e)))
            except Exception as e:  # noqa: BLE001 — map to a Status object
                self._send_error(_typed_to_api_error(e))

        def _handle(self, verb: str, parsed: wire.ParsedPath,
                    query: dict, body) -> dict:
            backend = server.backend
            if verb == "GET":
                kind = server.kind_for(parsed)
                if parsed.name:
                    server.audit.record(ctrlobs.VERB_GET, kind)
                    return backend.get(parsed.api_version, kind,
                                       parsed.namespace or "", parsed.name)
                selector = None
                if query.get("labelSelector"):
                    selector = wire.parse_selector(query["labelSelector"][0])
                items = backend.list(parsed.api_version, kind,
                                     namespace=parsed.namespace,
                                     selector=selector)
                server.audit.record(ctrlobs.VERB_LIST, kind,
                                    objects=len(items),
                                    nbytes=ctrlobs.payload_bytes(items))
                return {"apiVersion": parsed.api_version,
                        "kind": f"{kind}List", "items": items}
            if verb == "POST":
                if parsed.name:
                    raise ApiError(405, "MethodNotAllowed",
                                   "POST targets collections")
                if parsed.namespace and \
                        body.get("kind") not in k8s.CLUSTER_SCOPED_KINDS:
                    body.setdefault("metadata", {}).setdefault(
                        "namespace", parsed.namespace)
                server.learn_kind(body.get("kind", ""))
                server.audit.record(ctrlobs.VERB_CREATE,
                                    str(body.get("kind", "")))
                return self._observed(backend.create(body))
            if verb == "PUT":
                if not parsed.name:
                    raise ApiError(405, "MethodNotAllowed",
                                   "PUT targets objects")
                if parsed.subresource == "status":
                    server.audit.record(ctrlobs.VERB_UPDATE_STATUS,
                                        str(body.get("kind", "")))
                    return self._observed(backend.update_status(body))
                if parsed.subresource:
                    raise ApiError(404, "NotFound",
                                   f"subresource {parsed.subresource!r}")
                server.audit.record(ctrlobs.VERB_UPDATE,
                                    str(body.get("kind", "")))
                return self._observed(backend.update(body))
            if verb == "PATCH":
                if not parsed.name:
                    raise ApiError(405, "MethodNotAllowed",
                                   "PATCH targets objects")
                kind = server.kind_for(parsed)
                server.audit.record(ctrlobs.VERB_PATCH, kind)
                return self._observed(backend.patch(
                    parsed.api_version, kind, parsed.namespace or "",
                    parsed.name, body))
            if verb == "DELETE":
                if not parsed.name:
                    raise ApiError(405, "MethodNotAllowed",
                                   "DELETE targets objects")
                kind = server.kind_for(parsed)
                cascade = query.get("propagationPolicy",
                                    ["Background"])[0] != "Orphan"
                server.audit.record(ctrlobs.VERB_DELETE, kind)
                backend.delete(parsed.api_version, kind,
                               parsed.namespace or "", parsed.name,
                               cascade=cascade)
                status = wire.status_body(200, "Deleted",
                                          f"{kind} {parsed.name} deleted")
                # rv high-water mark after the delete (incl. cascades), so
                # clients can barrier on their watch streams
                status["details"] = {"resourceVersion":
                                     str(server.current_rv())}
                return status
            raise ApiError(405, "MethodNotAllowed", verb)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

        def do_PUT(self):
            self._dispatch("PUT")

        def do_PATCH(self):
            self._dispatch("PATCH")

        def do_DELETE(self):
            self._dispatch("DELETE")

        # -- watch streaming ------------------------------------------------

        def _write_chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        def _stream_watch(self, parsed: wire.ParsedPath,
                          query: dict) -> None:
            try:
                kind = server.kind_for(parsed)
                selector = None
                if query.get("labelSelector"):
                    selector = wire.parse_selector(
                        query["labelSelector"][0])
            except ApiError as e:
                return self._send_error(e)
            except ValueError as e:  # malformed selector → 400, not a crash
                return self._send_error(ApiError(400, "BadRequest", str(e)))

            # subscribe UNFILTERED so filtered-out mutations become
            # BOOKMARKs — the stream-catch-up signal (module docstring).
            # Subscribe BEFORE reading the current rv: a mutation in the gap
            # is then either queued on w or covered by the initial bookmark.
            w = server.backend.watch()
            server.audit.record(ctrlobs.VERB_WATCH, kind)
            current_rv = str(server.current_rv())
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                # initial bookmark: tells the client where the cluster is
                # NOW, so a barrier taken before this stream existed resolves
                self._write_chunk(json.dumps(
                    {"type": wire.BOOKMARK, "object": {
                        "apiVersion": parsed.api_version, "kind": kind,
                        "metadata": {"resourceVersion": current_rv}}}
                ).encode() + b"\n")
                import time as _time
                last_write = _time.monotonic()
                while not server._stopping.is_set():
                    ev = w.get(timeout=0.2)
                    if ev is None:
                        # heartbeat bookmark on idle streams: clients' read
                        # timeouts never fire and liveness is observable
                        if _time.monotonic() - last_write >= 5.0:
                            self._write_chunk(json.dumps(
                                {"type": wire.BOOKMARK, "object": {
                                    "apiVersion": parsed.api_version,
                                    "kind": kind,
                                    "metadata": {"resourceVersion": str(
                                        server.current_rv())}}}
                            ).encode() + b"\n")
                            last_write = _time.monotonic()
                        continue
                    last_write = _time.monotonic()
                    obj = ev.obj
                    server.observe_rv(obj.get("metadata", {})
                                      .get("resourceVersion"))
                    matches = (
                        obj.get("apiVersion") == parsed.api_version
                        and obj.get("kind") == kind
                        and (not parsed.namespace
                             or k8s.namespace_of(obj, "default")
                             == parsed.namespace)
                        and (selector is None
                             or k8s.matches_selector(obj, selector)))
                    if matches:
                        line = {"type": ev.type, "object": obj}
                        server.audit.record_delivered(kind)
                    else:
                        line = {"type": wire.BOOKMARK, "object": {
                            "apiVersion": parsed.api_version, "kind": kind,
                            "metadata": {"resourceVersion":
                                         obj.get("metadata", {})
                                         .get("resourceVersion", "")}}}
                    self._write_chunk(json.dumps(line).encode() + b"\n")
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass  # client went away or server socket closed
            finally:
                w.close()
                try:
                    self._write_chunk(b"")  # terminal chunk
                except OSError:
                    pass
                self.close_connection = True

    return Handler
