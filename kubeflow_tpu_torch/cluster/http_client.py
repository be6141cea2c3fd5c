"""HttpKubeClient: the Kubernetes REST calls the worker makes.

The port's copy of the part of ``kubeflow_tpu/cluster/http_client.py``
that ``runtime/metrics.py`` ``HeartbeatReporter`` uses: ``patch`` of one
object over the apiserver's REST paths, with the client's timeout,
bearer token and bounded retries of transient failures (5xx, 429 and
connection errors; a 4xx is meaning and raises at once). A failed
request raises ``KubeError`` with the apiserver's Status reason.

``retry_after_s`` and ``jittered_backoff`` are the retry helpers the
serving client (serving/client.py) and the fleet router
(serving/fleet.py) share with this client's loop.
"""

from __future__ import annotations

import json
import logging
import random
import time
from typing import Optional
from urllib.error import HTTPError, URLError
from urllib.request import Request, urlopen

log = logging.getLogger(__name__)


def retry_after_s(headers) -> Optional[float]:
    """A server-sent Retry-After in seconds off a headers mapping, or
    None (numeric form only; unparseable reads as absent): a throttling
    server telling us when to come back must not be hammered at our own
    jitter cadence."""
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
    """One jittered backoff interval: uniform in [delay, 1.5*delay], so a
    fleet of retriers does not hammer a recovering server in lockstep."""
    return delay_s * rng.uniform(1.0, 1.5)


class KubeError(RuntimeError):
    """A request the apiserver refused, or could not be reached for."""


def object_path(api_version: str, kind: str, namespace: Optional[str],
                name: str) -> str:
    """/api/v1/... for the core group, /apis/{group}/{version}/...
    otherwise; the resource is the lower-cased kind + "s" (``pods``, the
    kind the worker patches; the JAX package's ``wire.plural_of`` knows
    the irregular plurals)."""
    prefix = f"/apis/{api_version}" if "/" in api_version \
        else f"/api/{api_version}"
    ns = f"/namespaces/{namespace}" if namespace else ""
    return f"{prefix}{ns}/{kind.lower()}s/{name}"


def _status(code: int, reason: str, message: str) -> dict:
    return {"apiVersion": "v1", "kind": "Status", "code": code,
            "reason": reason, "message": message}


class HttpKubeClient:
    def __init__(self, base_url: str, token: Optional[str] = None,
                 timeout: float = 30.0, retries: int = 3,
                 retry_backoff_s: float = 0.2):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = max(0, int(retries))
        self.retry_backoff_s = retry_backoff_s
        self._headers = {"Content-Type": "application/json",
                         "Accept": "application/json"}
        if token:
            self._headers["Authorization"] = f"Bearer {token}"

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        delay = self.retry_backoff_s
        for attempt in range(self.retries + 1):
            req = Request(self.base_url + path, data=data,
                          headers=self._headers, method=method)
            try:
                with urlopen(req, timeout=self.timeout) as resp:
                    return json.loads(resp.read() or b"{}")
            except Exception as e:  # noqa: BLE001 — mapped to a Status
                payload = self._error_payload(e)
                code = payload.get("code") or 0
                if attempt < self.retries and (code == 0 or code >= 500
                                               or code == 429):
                    sleep = jittered_backoff(delay)
                    log.warning("%s %s transient (%s); retry %d/%d in "
                                "%.2fs", method, path,
                                payload.get("reason", "?"), attempt + 1,
                                self.retries, sleep)
                    time.sleep(sleep)
                    delay *= 2
                    continue
                raise KubeError(
                    f"{payload.get('reason') or 'Error'}: "
                    f"{payload.get('message', json.dumps(payload))}"
                ) from None

    @staticmethod
    def _error_payload(e: Exception) -> dict:
        if isinstance(e, HTTPError):
            try:
                return json.loads(e.read() or b"{}")
            except Exception:  # noqa: BLE001 — non-JSON error body
                return _status(e.code, "Unknown", str(e))
        if isinstance(e, URLError):
            return _status(0, "Unreachable", str(e.reason))
        return _status(0, "ClientError", f"{type(e).__name__}: {e}")

    def patch(self, api_version: str, kind: str, namespace: str, name: str,
              patch: dict) -> dict:
        """A merge patch of one object; returns the patched object."""
        return self._request(
            "PATCH", object_path(api_version, kind, namespace, name), patch)
