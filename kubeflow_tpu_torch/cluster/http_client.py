"""HttpKubeClient — the real-cluster client.

The port's copy of ``kubeflow_tpu/cluster/http_client.py``. It speaks the
Kubernetes REST wire format (cluster/wire.py) against any apiserver: a
real one (via kubeconfig — server URL, CA bundle or
insecure-skip-tls-verify, bearer token / basic auth / client certs) or the
in-repo ClusterAPIServer (cluster/apiserver.py). The manager process
(``python -m kubeflow_tpu_torch.controllers``) runs its controllers over
it; the worker's ``HeartbeatReporter`` (runtime/metrics.py) patches its
own pod through it. ``retry_after_s`` and ``jittered_backoff`` are the
retry helpers the serving client (serving/client.py) and the fleet router
(serving/fleet.py) share with this client's loop.

Watches are background threads reading chunked JSON-line streams
(GET ...?watch=true), with automatic reconnect. The server emits BOOKMARK
events for mutations a filtered stream does not match, so every stream
advances its resourceVersion high-water mark on every cluster mutation;
``wait_caught_up(rv)`` blocks until all streams have seen rv — giving the
same read-your-writes determinism tests get from the in-memory FakeCluster
(enabled via ``sync_watches=True``; off for production use).
"""

from __future__ import annotations

import json
import logging
import random
import ssl
import threading
import time
from typing import Optional
from urllib.parse import quote
from urllib.request import Request, urlopen

from . import wire
from .client import (AlreadyExistsError, ConflictError, KubeClient,
                     KubeError, NotFoundError, Watch, WatchEvent)
from .wire import object_path

__all__ = ["HttpKubeClient", "KubeError", "object_path", "retry_after_s",
           "jittered_backoff"]

log = logging.getLogger(__name__)


def retry_after_s(headers) -> Optional[float]:
    """A server-sent Retry-After in seconds off a headers mapping, or
    None (numeric form only — the HTTP-date form is not worth a parser
    here; unparseable reads as absent). Shared by this client's bounded
    retry loop and the serving-side retry paths (serving/client.py,
    serving/fleet.py): a throttling server telling us when to come back
    must not be hammered at our own jitter cadence."""
    if headers is None:
        return None
    raw = headers.get("Retry-After")
    if raw is None:
        return None
    try:
        return max(0.0, float(raw))
    except (TypeError, ValueError):
        return None


def jittered_backoff(delay_s: float, rng=random) -> float:
    """One jittered backoff interval: uniform in [delay, 1.5*delay] —
    the decorrelation that keeps a fleet of retriers from hammering a
    recovering server in lockstep (thundering-herd protection)."""
    return delay_s * rng.uniform(1.0, 1.5)


class _HttpWatch(Watch):
    """A Watch fed by a background stream-reader thread."""

    def __init__(self, api_version: str, kind: str):
        super().__init__(api_version, kind)
        self.last_rv = 0  # high-water resourceVersion seen on this stream
        self.thread: Optional[threading.Thread] = None
        # set once the server-side subscription exists (initial bookmark
        # received); watch() blocks on it so a mutation issued right after
        # watch() returns can never race the subscription
        self.subscribed = threading.Event()

    def deliver(self, event: WatchEvent) -> None:  # no re-filtering needed
        if not self.closed:
            self.events.put(event)


class HttpKubeClient(KubeClient):
    def __init__(self, base_url: str, token: Optional[str] = None,
                 ca_file: Optional[str] = None, insecure: bool = False,
                 client_cert: Optional[tuple[str, str]] = None,
                 basic_auth: Optional[tuple[str, str]] = None,
                 timeout: float = 30.0, sync_watches: bool = False,
                 retries: int = 3, retry_backoff_s: float = 0.2,
                 retry_wall_clock_s: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        # transient-error budget: a 5xx / connection failure retries up to
        # `retries` times with exponential backoff + jitter before the
        # typed error surfaces — the controller must survive an apiserver
        # flake (LB blip, leader election, chaos-injected burst) without
        # burning its reconcile-retry budget. 4xx semantics (NotFound,
        # Conflict, AlreadyExists) are MEANING, not weather: never retried.
        # A throttling apiserver's Retry-After (429/503) is HONORED — a
        # server telling us when to come back must not be hammered at our
        # own jitter cadence during a health-event storm — and the total
        # sleep across one request's retries is capped at
        # `retry_wall_clock_s` so honoring it cannot pin a reconcile
        # worker for minutes.
        self.retries = max(0, int(retries))
        self.retry_backoff_s = retry_backoff_s
        self.retry_wall_clock_s = retry_wall_clock_s
        # read-your-writes barrier for deterministic drives (tests, CLI
        # apply-then-verify); production reconcilers are level-triggered and
        # don't need it
        self.sync_watches = sync_watches
        self._headers = {"Content-Type": "application/json",
                         "Accept": "application/json"}
        if token:
            self._headers["Authorization"] = f"Bearer {token}"
        elif basic_auth:
            import base64
            cred = base64.b64encode(
                f"{basic_auth[0]}:{basic_auth[1]}".encode()).decode()
            self._headers["Authorization"] = f"Basic {cred}"
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if self.base_url.startswith("https"):
            self._ssl_ctx = ssl.create_default_context(cafile=ca_file)
            if insecure:
                self._ssl_ctx.check_hostname = False
                self._ssl_ctx.verify_mode = ssl.CERT_NONE
            if client_cert:
                self._ssl_ctx.load_cert_chain(client_cert[0], client_cert[1])
        self._watches: list[_HttpWatch] = []
        self._watch_lock = threading.Lock()

    # -- kubeconfig ----------------------------------------------------------

    @classmethod
    def from_kubeconfig(cls, path: str, context: Optional[str] = None,
                        **kw) -> "HttpKubeClient":
        """Build a client from a kubeconfig file (the subset kfctl and the
        manager need: clusters/users/contexts with token, basic-auth, or
        client-cert credentials)."""
        import yaml

        with open(path) as f:
            cfg = yaml.safe_load(f) or {}
        clusters = {e["name"]: e.get("cluster", {})
                    for e in cfg.get("clusters", [])}
        users = {e["name"]: e.get("user", {}) for e in cfg.get("users", [])}
        contexts = {e["name"]: e.get("context", {})
                    for e in cfg.get("contexts", [])}
        ctx_name = context or cfg.get("current-context")
        if not ctx_name or ctx_name not in contexts:
            raise KubeError(f"kubeconfig {path}: no usable context "
                            f"({ctx_name!r})")
        ctx = contexts[ctx_name]
        cluster = clusters.get(ctx.get("cluster", ""), {})
        user = users.get(ctx.get("user", ""), {})
        server = cluster.get("server")
        if not server:
            raise KubeError(f"kubeconfig {path}: context {ctx_name!r} has "
                            "no cluster server")
        token = user.get("token")
        if not token and user.get("tokenFile"):
            with open(user["tokenFile"]) as f:
                token = f.read().strip()
        basic = None
        if user.get("username") and user.get("password"):
            basic = (user["username"], user["password"])
        client_cert = None
        if user.get("client-certificate") and user.get("client-key"):
            client_cert = (user["client-certificate"], user["client-key"])
        return cls(
            server, token=token, basic_auth=basic, client_cert=client_cert,
            ca_file=cluster.get("certificate-authority"),
            insecure=bool(cluster.get("insecure-skip-tls-verify")), **kw)

    # -- request plumbing ----------------------------------------------------

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        delay = self.retry_backoff_s
        slept = 0.0
        for attempt in range(self.retries + 1):
            req = Request(self.base_url + path, data=data,
                          headers=self._headers, method=method)
            try:
                with urlopen(req, timeout=self.timeout,
                             context=self._ssl_ctx) as resp:
                    return json.loads(resp.read() or b"{}")
            except Exception as e:
                payload = self._error_payload(e)
                if attempt < self.retries and self._is_transient(payload):
                    # jitter decorrelates a fleet of controllers hammering
                    # a recovering apiserver (thundering-herd protection);
                    # a server-sent Retry-After (429/503 throttling) wins
                    # over our own schedule — the server knows its load
                    sleep = jittered_backoff(delay)
                    retry_after = self._retry_after_s(e)
                    if retry_after is not None:
                        sleep = max(sleep, retry_after)
                    if slept + sleep > self.retry_wall_clock_s:
                        # wall-clock cap: honoring a long Retry-After (or
                        # stacking backoffs) must not pin this caller past
                        # the budget — surface the error, the reconcile
                        # loop's own requeue is the cheaper way to wait
                        log.warning("%s %s: retry budget exhausted "
                                    "(%.1fs slept, next wait %.1fs > "
                                    "%.1fs cap)", method, path, slept,
                                    sleep, self.retry_wall_clock_s)
                        raise self._typed_error(payload) from None
                    log.warning("%s %s transient (%s); retry %d/%d in "
                                "%.2fs", method, path,
                                payload.get("reason", "?"), attempt + 1,
                                self.retries, sleep)
                    time.sleep(sleep)
                    slept += sleep
                    delay *= 2
                    continue
                raise self._typed_error(payload) from None

    @staticmethod
    def _retry_after_s(e: Exception) -> Optional[float]:
        """The server's Retry-After in seconds, when the error carries
        one (the module-level retry_after_s over the error's headers)."""
        return retry_after_s(getattr(e, "headers", None))

    @staticmethod
    def _is_transient(payload: dict) -> bool:
        """5xx and connection-level failures (code 0: unreachable, timeout,
        dropped mid-response) are retryable weather; 4xx is meaning."""
        code = payload.get("code") or 0
        return code == 0 or code >= 500 or code == 429

    @staticmethod
    def _error_payload(e: Exception) -> dict:
        from urllib.error import HTTPError, URLError
        if isinstance(e, HTTPError):
            try:
                return json.loads(e.read() or b"{}")
            except Exception:  # noqa: BLE001 — non-JSON error body
                return wire.status_body(e.code, "Unknown", str(e))
        if isinstance(e, URLError):
            return wire.status_body(0, "Unreachable", str(e.reason))
        return wire.status_body(0, "ClientError", f"{type(e).__name__}: {e}")

    @staticmethod
    def _typed_error(status: dict) -> KubeError:
        reason = status.get("reason", "")
        message = status.get("message", json.dumps(status))
        # every typed error names the apiserver's reason first
        if reason == "NotFound" or status.get("code") == 404:
            return NotFoundError(f"NotFound: {message}")
        if reason == "AlreadyExists":
            return AlreadyExistsError(f"AlreadyExists: {message}")
        if reason == "Conflict":
            return ConflictError(f"Conflict: {message}")
        return KubeError(f"{reason or 'Error'}: {message}")

    def _after_mutation(self, result: dict) -> dict:
        if self.sync_watches:
            rv = int(result.get("metadata", {}).get("resourceVersion", 0)
                     or 0)
            if rv:
                self.wait_caught_up(rv)
        return result

    # -- KubeClient surface --------------------------------------------------

    def create(self, obj: dict) -> dict:
        av, kind = obj.get("apiVersion", ""), obj.get("kind", "")
        ns = obj.get("metadata", {}).get("namespace")
        path = wire.collection_path(av, kind, ns)
        return self._after_mutation(self._request("POST", path, obj))

    def get(self, api_version: str, kind: str, namespace: str,
            name: str) -> dict:
        return self._request(
            "GET", wire.object_path(api_version, kind, namespace, name))

    def list(self, api_version: str, kind: str,
             namespace: Optional[str] = None,
             selector: Optional[dict] = None) -> list[dict]:
        path = wire.collection_path(api_version, kind, namespace)
        if selector:
            path += "?labelSelector=" + quote(wire.encode_selector(selector))
        return self._request("GET", path).get("items", [])

    def update(self, obj: dict) -> dict:
        av, kind = obj.get("apiVersion", ""), obj.get("kind", "")
        meta = obj.get("metadata", {})
        path = wire.object_path(av, kind, meta.get("namespace"),
                                meta.get("name", ""))
        return self._after_mutation(self._request("PUT", path, obj))

    def update_status(self, obj: dict) -> dict:
        av, kind = obj.get("apiVersion", ""), obj.get("kind", "")
        meta = obj.get("metadata", {})
        path = wire.object_path(av, kind, meta.get("namespace"),
                                meta.get("name", "")) + "/status"
        return self._after_mutation(self._request("PUT", path, obj))

    def patch(self, api_version: str, kind: str, namespace: str, name: str,
              patch: dict) -> dict:
        path = wire.object_path(api_version, kind, namespace, name)
        return self._after_mutation(self._request("PATCH", path, patch))

    def delete(self, api_version: str, kind: str, namespace: str, name: str,
               cascade: bool = True) -> None:
        path = wire.object_path(api_version, kind, namespace, name)
        if not cascade:
            path += "?propagationPolicy=Orphan"
        result = self._request("DELETE", path)
        if self.sync_watches:
            rv = (result.get("details") or {}).get("resourceVersion", "")
            if str(rv).isdigit():
                self.wait_caught_up(int(rv))

    # -- watch ---------------------------------------------------------------

    def watch(self, api_version: Optional[str] = None,
              kind: Optional[str] = None) -> Watch:
        if not api_version or not kind:
            raise KubeError("HttpKubeClient.watch requires api_version and "
                            "kind (a real apiserver has no watch-everything "
                            "endpoint)")
        w = _HttpWatch(api_version, kind)
        t = threading.Thread(target=self._stream_loop, args=(w,),
                             daemon=True,
                             name=f"watch-{kind}")
        w.thread = t
        with self._watch_lock:
            self._watches.append(w)
        t.start()
        # FakeCluster.watch subscribes synchronously; match that so
        # watch-then-mutate is race-free over the wire too
        w.subscribed.wait(timeout=self.timeout)
        return w

    def _stream_loop(self, w: _HttpWatch) -> None:
        import http.client as hc
        from urllib.parse import urlsplit

        split = urlsplit(self.base_url)
        path = wire.collection_path(w.api_version, w.kind) + "?watch=true"
        first_connect = True
        while not w.closed:
            conn = None
            try:
                if split.scheme == "https":
                    conn = hc.HTTPSConnection(split.hostname, split.port,
                                              context=self._ssl_ctx,
                                              timeout=self.timeout)
                else:
                    conn = hc.HTTPConnection(split.hostname, split.port,
                                             timeout=self.timeout)
                headers = {k: v for k, v in self._headers.items()
                           if k != "Content-Type"}
                conn.request("GET", path, headers=headers)
                resp = conn.getresponse()
                if resp.status != 200:
                    log.warning("watch %s: HTTP %s", w.kind, resp.status)
                    time.sleep(0.5)
                    continue
                if not first_connect:
                    # reconnect relist (informer resync analog): events in
                    # the connection gap were lost, so re-deliver current
                    # state as MODIFIED — level-triggered reconcilers just
                    # re-enqueue keys and read the store
                    try:
                        for obj in self.list(w.api_version, w.kind):
                            w.deliver(WatchEvent("MODIFIED", obj))
                    except KubeError as e:
                        log.warning("watch %s relist failed: %s", w.kind, e)
                first_connect = False
                # HTTPResponse.readline is chunk-decoding (io.BufferedIOBase
                # over read1); resp.fp would expose raw chunk framing
                while not w.closed:
                    line = resp.readline()
                    if not line:
                        break  # stream ended; reconnect
                    try:
                        ev = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    obj = ev.get("object", {})
                    rv = obj.get("metadata", {}).get("resourceVersion", "")
                    try:
                        w.last_rv = max(w.last_rv, int(rv))
                    except (TypeError, ValueError):
                        pass
                    # any line proves the server-side subscription exists
                    # (the server's initial bookmark arrives first)
                    w.subscribed.set()
                    if ev.get("type") != wire.BOOKMARK:
                        w.deliver(WatchEvent(ev.get("type", ""), obj))
            except OSError as e:
                if not w.closed:
                    log.debug("watch %s stream error: %s; reconnecting",
                              w.kind, e)
                    time.sleep(0.2)
            finally:
                if conn is not None:
                    conn.close()

    def wait_caught_up(self, rv: int, timeout: float = 10.0) -> bool:
        """Block until every open watch stream has seen resourceVersion
        >= rv (BOOKMARKs included). Used by sync_watches and by tests."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._watch_lock:
                self._watches = [w for w in self._watches if not w.closed]
                behind = [w for w in self._watches if w.last_rv < rv]
            if not behind:
                return True
            time.sleep(0.002)
        return False

    def close(self) -> None:
        with self._watch_lock:
            for w in self._watches:
                w.close()
            self._watches.clear()
