"""Kubernetes REST wire-format helpers shared by the HTTP client and the
apiserver.

The port's copy of ``kubeflow_tpu/cluster/wire.py``.

One module knows the path grammar both sides speak, so they cannot drift:

- core group:   /api/v1/[namespaces/{ns}/]{plural}[/{name}[/status]]
- named groups: /apis/{group}/{version}/[namespaces/{ns}/]{plural}[...]
- label selectors: ?labelSelector=k%3Dv,k2%3Dv2 (equality terms only — the
  selector model the rest of the framework uses)
- watch streams: collection GET + ?watch=true → chunked JSON lines
  {"type": ADDED|MODIFIED|DELETED|BOOKMARK, "object": {...}}

Reference parity: this is the slice of the kube API client-go exercises via
RESTMapper + dynamic client (the reference drives it through ksonnet's
client lib, ksonnet.go:92-197, and controller-runtime,
notebook_controller.go:57-144).

BOOKMARK events carry only metadata.resourceVersion. The apiserver emits one
for every mutation a filtered watch does NOT match, so a client can tell how
far a stream has caught up — the determinism hook the sync barrier in
http_client.HttpKubeClient builds on (kube's allowWatchBookmarks analog).
"""

from __future__ import annotations

import urllib.parse
from typing import Optional

from ..api import k8s

# Kind → plural for everything the framework ships; anything else falls back
# to the heuristic below (held identically by client and server).
KIND_PLURALS = {
    "Endpoints": "endpoints",
    "Ingress": "ingresses",
    "NetworkPolicy": "networkpolicies",
    "PodSecurityPolicy": "podsecuritypolicies",
    "ResourceQuota": "resourcequotas",
}

BOOKMARK = "BOOKMARK"


def plural_of(kind: str) -> str:
    if kind in KIND_PLURALS:
        return KIND_PLURALS[kind]
    lower = kind.lower()
    if lower.endswith("s") or lower.endswith("x") or lower.endswith("ch"):
        return lower + "es"
    if lower.endswith("y") and lower[-2:-1] not in "aeiou":
        return lower[:-1] + "ies"
    return lower + "s"


def api_prefix(api_version: str) -> str:
    """/api/v1 for the core group, /apis/{group}/{version} otherwise."""
    if "/" in api_version:
        return f"/apis/{api_version}"
    return f"/api/{api_version}"


def collection_path(api_version: str, kind: str,
                    namespace: Optional[str] = None) -> str:
    prefix = api_prefix(api_version)
    plural = plural_of(kind)
    if namespace and kind not in k8s.CLUSTER_SCOPED_KINDS:
        return f"{prefix}/namespaces/{namespace}/{plural}"
    return f"{prefix}/{plural}"


def object_path(api_version: str, kind: str, namespace: Optional[str],
                name: str) -> str:
    return f"{collection_path(api_version, kind, namespace)}/{name}"


def encode_selector(selector: dict[str, str]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(selector.items()))


def parse_selector(value: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for term in value.split(","):
        term = term.strip()
        if not term:
            continue
        if "==" in term:
            k, v = term.split("==", 1)
        elif "=" in term:
            k, v = term.split("=", 1)
        else:
            raise ValueError(f"unsupported selector term {term!r} "
                             "(equality terms only)")
        out[k.strip()] = v.strip()
    return out


class ParsedPath:
    """A decoded request path: what resource the verb addresses."""

    def __init__(self, api_version: str, plural: str,
                 namespace: Optional[str], name: Optional[str],
                 subresource: Optional[str]):
        self.api_version = api_version
        self.plural = plural
        self.namespace = namespace
        self.name = name
        self.subresource = subresource

    def kind_from(self, plural_to_kind: dict[str, str]) -> Optional[str]:
        return plural_to_kind.get(self.plural)


def parse_path(path: str) -> Optional[ParsedPath]:
    """Decode an /api or /apis resource path (query string already split
    off). Returns None for non-resource paths (/healthz, /version, ...)."""
    parts = [urllib.parse.unquote(p) for p in path.strip("/").split("/") if p]
    if not parts:
        return None
    if parts[0] == "api":
        if len(parts) < 2:
            return None
        api_version = parts[1]
        rest = parts[2:]
    elif parts[0] == "apis":
        if len(parts) < 3:
            return None
        api_version = f"{parts[1]}/{parts[2]}"
        rest = parts[3:]
    else:
        return None
    if not rest:
        return None
    namespace: Optional[str] = None
    if rest[0] == "namespaces" and len(rest) >= 3 and \
            not (len(rest) == 3 and rest[2] in ("status", "finalize")):
        # /namespaces/{ns}/{plural}... — but /namespaces/{name} (the
        # Namespace object itself, len 2) and /namespaces/{name}/status
        # (its subresource) address the Namespace resource, not a scope
        namespace, rest = rest[1], rest[2:]
    plural = rest[0]
    name = rest[1] if len(rest) > 1 else None
    subresource = rest[2] if len(rest) > 2 else None
    return ParsedPath(api_version, plural, namespace, name, subresource)


def status_body(code: int, reason: str, message: str) -> dict:
    """A kube Status object (what the client maps back to typed errors)."""
    return {
        "apiVersion": "v1", "kind": "Status",
        "status": "Failure" if code >= 400 else "Success",
        "code": code, "reason": reason, "message": message,
    }
