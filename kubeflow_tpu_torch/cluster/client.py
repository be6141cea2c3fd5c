"""The Kubernetes client interface.

The port's copy of ``kubeflow_tpu/cluster/client.py``, verbatim below
this docstring. Controllers program against this narrow surface; the
implementation here is the in-memory ``FakeCluster`` (``cluster/fake.py``),
the envtest analog the operator's tests and soaks drive. It mirrors how
controller-runtime splits client-go usage from reconciler logic.
"""

from __future__ import annotations

import copy
import queue
from dataclasses import dataclass
from typing import Callable, Iterable, Optional


class KubeError(Exception):
    pass


class NotFoundError(KubeError):
    pass


class AlreadyExistsError(KubeError):
    pass


class ConflictError(KubeError):
    """resourceVersion mismatch on update — caller must re-read and retry."""


ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


@dataclass
class WatchEvent:
    type: str   # ADDED | MODIFIED | DELETED
    obj: dict


class Watch:
    """A watch subscription: a queue of WatchEvents with an optional
    (apiVersion, kind) filter. close() detaches it from the server."""

    def __init__(self, api_version: Optional[str] = None, kind: Optional[str] = None):
        self.api_version = api_version
        self.kind = kind
        self.events: "queue.Queue[WatchEvent]" = queue.Queue()
        self.closed = False

    def matches(self, obj: dict) -> bool:
        if self.api_version and obj.get("apiVersion") != self.api_version:
            return False
        if self.kind and obj.get("kind") != self.kind:
            return False
        return True

    def deliver(self, event: WatchEvent) -> None:
        if not self.closed and self.matches(event.obj):
            self.events.put(event)

    def get(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        try:
            return self.events.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self.closed = True


class KubeClient:
    """Abstract client. All objects are manifest dicts (see api.k8s)."""

    def create(self, obj: dict) -> dict:
        raise NotImplementedError

    def get(self, api_version: str, kind: str, namespace: str, name: str) -> dict:
        raise NotImplementedError

    def list(self, api_version: str, kind: str, namespace: Optional[str] = None,
             selector: Optional[dict] = None) -> list[dict]:
        raise NotImplementedError

    def update(self, obj: dict) -> dict:
        raise NotImplementedError

    def update_status(self, obj: dict) -> dict:
        raise NotImplementedError

    def patch(self, api_version: str, kind: str, namespace: str, name: str,
              patch: dict) -> dict:
        raise NotImplementedError

    def delete(self, api_version: str, kind: str, namespace: str, name: str,
               cascade: bool = True) -> None:
        raise NotImplementedError

    def watch(self, api_version: Optional[str] = None,
              kind: Optional[str] = None) -> Watch:
        raise NotImplementedError

    # -- conveniences shared by all implementations -------------------------

    def get_or_none(self, api_version: str, kind: str, namespace: str,
                    name: str) -> Optional[dict]:
        try:
            return self.get(api_version, kind, namespace, name)
        except NotFoundError:
            return None

    def apply(self, obj: dict) -> dict:
        """Create-or-update (kubectl apply semantics, spec-level replace).

        No-op when nothing changes: reconcilers apply their children every
        pass while watching those same kinds, so an unconditional update
        (which bumps resourceVersion and broadcasts MODIFIED) would
        re-enqueue the owner forever.
        """
        from ..api import k8s
        existing = self.get_or_none(*k8s.key_of(obj))
        if existing is None:
            return self.create(obj)
        merged = dict(existing)
        for key in ("spec", "data", "stringData", "rules", "webhooks",
                    "subsets", "roleRef", "subjects"):
            if key in obj:
                merged[key] = obj[key]
        meta = dict(existing.get("metadata", {}))
        for key in ("labels", "annotations"):
            if obj.get("metadata", {}).get(key):
                meta[key] = obj["metadata"][key]
        merged["metadata"] = meta
        if k8s.snapshot(merged) == k8s.snapshot(existing):
            return existing
        return self.update(merged)

    def delete_many(self, objs: Iterable[dict]) -> None:
        from ..api import k8s
        for obj in objs:
            try:
                self.delete(*k8s.key_of(obj))
            except NotFoundError:
                pass


def apply_annotations(obj: dict, updates: dict) -> dict:
    """Fold an annotation-update map onto an object in place (the kube
    null-delete convention: a None value REMOVES the key). The shape
    every conflict-safe annotation writer's ``mutate`` uses, so patch
    semantics and update semantics cannot drift."""
    anns = obj.setdefault("metadata", {}).setdefault("annotations", {})
    for key, value in updates.items():
        if value is None:
            anns.pop(key, None)
        else:
            anns[key] = value
    return obj


def update_with_conflict_retry(
        client: KubeClient, api_version: str, kind: str, namespace: str,
        name: str, mutate: Callable[[dict], Optional[dict]],
        max_attempts: int = 5) -> dict:
    """Optimistic-concurrency read-modify-write: re-read → re-apply
    ``mutate`` → update with the read's resourceVersion as precondition;
    a ConflictError (another writer landed in between) re-reads and
    re-applies. THE write primitive for every annotation RMW in the
    control plane (restart counters, bindings, resize histories, health
    folds, final ledgers): a blind patch computes its value from a
    possibly-stale read and silently loses the other writer's update —
    this loses nothing, ever, at the price of a bounded retry.

    ``mutate(obj)`` receives a deep copy of the FRESH object and returns
    the object to write (mutating in place and returning it is fine), or
    None to skip the write entirely (the decision is re-made per
    attempt, so "already done" short-circuits are conflict-safe too).

    NotFoundError propagates — callers that tolerate a deleted object
    catch it, same as they would around a patch.
    """
    last: Optional[ConflictError] = None
    for attempt in range(max_attempts):
        obj = client.get(api_version, kind, namespace, name)
        desired = mutate(copy.deepcopy(obj))
        if desired is None:
            return obj
        desired.setdefault("metadata", {})["resourceVersion"] = \
            obj.get("metadata", {}).get("resourceVersion")
        try:
            return client.update(desired)
        except ConflictError as e:
            last = e
            # lazy import: obs is dependency-free but cluster/ must not
            # grow import-time edges it does not need
            from ..obs import registry as obsreg
            obsreg.counter(
                "kftpu_conflict_retries_total",
                "read-modify-write attempts retried after a "
                "resourceVersion conflict", labels=("kind",)).labels(
                    kind=kind).inc()
    raise last if last is not None else KubeError(
        f"update_with_conflict_retry: no attempt made for "
        f"{kind} {namespace}/{name}")
