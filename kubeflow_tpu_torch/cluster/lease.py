"""Leader election over coordination.k8s.io Lease objects.

The port's copy of ``kubeflow_tpu/cluster/lease.py``; the Lease object,
its fencing token and the token's increment on a steal are the JAX
package's byte for byte, so a real apiserver and both packages' tools
read the same Lease. What it holds:

- **The Lease wire contract.** One Lease object per controller
  deployment (``coordination.k8s.io/v1`` Lease on the same apiserver
  everything else uses). The field names are defined here and only
  here: the elector, the soaks and the manifests import them.
- **Acquire / renew / steal.** ``try_acquire`` is one optimistic-
  concurrency round: read the lease, and create (absent), renew (ours)
  or steal (expired). Every write carries the read's resourceVersion as
  a precondition, so two replicas racing for the same expiry produce
  exactly one winner; the loser's update 409s and it stays a follower.
- **Fencing.** ``leaseTransitions`` is the fencing token: it increments
  on every change of holder. A leader that cannot renew within the lease
  duration demotes itself on its own clock (the client-go rule), and
  ``FencedKubeClient`` rejects every mutating call from a demoted or
  never-elected replica before it reaches the wire.

Every clock read goes through this module's ``time`` (an elector's
``clock`` overrides it), so a test can put the election on a fake clock.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .client import (AlreadyExistsError, ConflictError, KubeClient,
                     KubeError, NotFoundError, Watch)

log = logging.getLogger(__name__)

# ---------------------------------------------------------------- the wire
# The one definition of the Lease object contract; everyone else imports.

LEASE_API_VERSION = "coordination.k8s.io/v1"
LEASE_KIND = "Lease"
# spec field names (the coordination.k8s.io shapes; times are unix floats
# here — the simulated apiserver is schema-free and floats keep the
# expiry arithmetic exact)
HOLDER_FIELD = "holderIdentity"
ACQUIRE_TIME_FIELD = "acquireTime"
RENEW_TIME_FIELD = "renewTime"
DURATION_FIELD = "leaseDurationSeconds"
# the fencing token: bumped exactly once per change of holder, so any
# consumer can order "who held this lease when" without trusting clocks
TRANSITIONS_FIELD = "leaseTransitions"

# default lease homes (the manifests render these through to the
# controller CLI)
DEFAULT_LEASE_NAMESPACE = "kubeflow"
OPERATOR_LEASE = "tpu-job-operator"
SCHEDULER_LEASE = "tpu-scheduler"


class FencingError(KubeError):
    """A mutating call from a replica that does not (or no longer does)
    hold its lease. Raised CLIENT-side before the write reaches the
    apiserver: a deposed leader must not race its successor."""


@dataclass
class LeaseRecord:
    """Parsed view of one Lease object's spec."""

    holder: str = ""
    acquire_time: float = 0.0
    renew_time: float = 0.0
    duration_s: float = 15.0
    transitions: int = 0

    def expired(self, now: float) -> bool:
        """Whether the current holder's claim has lapsed (no holder
        counts as expired — the lease is free)."""
        if not self.holder:
            return True
        return now - self.renew_time > self.duration_s


def lease_record(obj: Optional[dict]) -> LeaseRecord:
    """Parse a Lease object; zeros/empty when absent or malformed (a
    garbage lease reads as free — stealing it is safe because the write
    still carries the rv precondition)."""
    spec = (obj or {}).get("spec") or {}
    try:
        return LeaseRecord(
            holder=str(spec.get(HOLDER_FIELD, "") or ""),
            acquire_time=float(spec.get(ACQUIRE_TIME_FIELD, 0.0) or 0.0),
            renew_time=float(spec.get(RENEW_TIME_FIELD, 0.0) or 0.0),
            duration_s=float(spec.get(DURATION_FIELD, 15.0) or 15.0),
            transitions=int(spec.get(TRANSITIONS_FIELD, 0) or 0))
    except (TypeError, ValueError):
        return LeaseRecord()


def _lease_obj(namespace: str, name: str, rec: LeaseRecord) -> dict:
    return {
        "apiVersion": LEASE_API_VERSION, "kind": LEASE_KIND,
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            HOLDER_FIELD: rec.holder,
            ACQUIRE_TIME_FIELD: rec.acquire_time,
            RENEW_TIME_FIELD: rec.renew_time,
            DURATION_FIELD: rec.duration_s,
            TRANSITIONS_FIELD: rec.transitions,
        },
    }


@dataclass
class AcquireResult:
    acquired: bool
    record: LeaseRecord
    # why the attempt did not acquire ("held", "lost-race", "error")
    reason: str = ""


def try_acquire(client: KubeClient, namespace: str, name: str,
                identity: str, duration_s: float,
                now: Optional[float] = None) -> AcquireResult:
    """One conflict-safe acquire/renew round. Exactly one of N
    concurrent callers wins any given transition: every write carries
    the resourceVersion of the read it was computed from, so a
    concurrent steal 409s the loser (who returns acquired=False and
    keeps following)."""
    now = time.time() if now is None else now
    existing = None
    try:
        existing = client.get(LEASE_API_VERSION, LEASE_KIND, namespace,
                              name)
    except NotFoundError:
        pass
    if existing is None:
        rec = LeaseRecord(holder=identity, acquire_time=now,
                          renew_time=now, duration_s=duration_s,
                          transitions=1)
        try:
            client.create(_lease_obj(namespace, name, rec))
            return AcquireResult(True, rec)
        except (AlreadyExistsError, ConflictError):
            return AcquireResult(False, rec, "lost-race")
    rec = lease_record(existing)
    if rec.holder == identity:
        new = LeaseRecord(holder=identity, acquire_time=rec.acquire_time,
                          renew_time=now, duration_s=duration_s,
                          transitions=rec.transitions)
    elif rec.expired(now):
        # steal: the holder's claim lapsed — the transition bumps the
        # fencing token so the old holder's token goes stale
        new = LeaseRecord(holder=identity, acquire_time=now,
                          renew_time=now, duration_s=duration_s,
                          transitions=rec.transitions + 1)
    else:
        return AcquireResult(False, rec, "held")
    obj = _lease_obj(namespace, name, new)
    obj["metadata"]["resourceVersion"] = \
        existing["metadata"].get("resourceVersion")
    try:
        client.update(obj)
        return AcquireResult(True, new)
    except ConflictError:
        return AcquireResult(False, rec, "lost-race")


def release(client: KubeClient, namespace: str, name: str,
            identity: str) -> bool:
    """Graceful release: clear the holder so a successor acquires on its
    NEXT attempt instead of waiting out the full lease duration.
    Conflict-safe — a lease already stolen from us is left alone."""
    try:
        existing = client.get(LEASE_API_VERSION, LEASE_KIND, namespace,
                              name)
    except (NotFoundError, KubeError):
        return False
    rec = lease_record(existing)
    if rec.holder != identity:
        return False
    new = LeaseRecord(holder="", acquire_time=rec.acquire_time,
                      renew_time=0.0, duration_s=rec.duration_s,
                      transitions=rec.transitions)
    obj = _lease_obj(namespace, name, new)
    obj["metadata"]["resourceVersion"] = \
        existing["metadata"].get("resourceVersion")
    try:
        client.update(obj)
        return True
    except (ConflictError, KubeError):
        return False


# ---------------------------------------------------------------- elector


@dataclass
class LeaderElector:
    """The per-replica election loop state. ``ensure()`` is called from
    the hosting controller loop (controllers/runtime.py gates
    process_one on it): it acquires/renews at ``renew_every_s`` cadence
    and answers "am I the leader RIGHT NOW" off the local clock —
    a leader that has not managed a successful renew within the lease
    duration is NOT the leader anymore, whatever it last read, because
    a standby may already have stolen the lease (the partition-safety
    rule client-go leader election follows).
    """

    client: KubeClient
    identity: str
    name: str
    namespace: str = DEFAULT_LEASE_NAMESPACE
    duration_s: float = 15.0
    # renew cadence; defaults to duration/3 when 0 (the client-go ratio)
    renew_every_s: float = 0.0
    # the local clock; None reads this module's time.time at each call
    clock: Optional[Callable[[], float]] = None

    _held: bool = field(default=False, repr=False)
    _last_renew_ok: float = field(default=0.0, repr=False)
    _next_attempt: float = field(default=0.0, repr=False)
    _token: int = field(default=0, repr=False)
    _was_leader: bool = field(default=False, repr=False)
    _transitions_seen: int = field(default=0, repr=False)

    def __post_init__(self):
        if not self.renew_every_s:
            self.renew_every_s = max(self.duration_s / 3.0, 0.01)

    def _now(self) -> float:
        return self.clock() if self.clock is not None else time.time()

    # -- state ----------------------------------------------------------

    @property
    def is_leader(self) -> bool:
        """Local-clock leadership: held AND renewed recently enough.
        This is the check FencedKubeClient makes per mutating call —
        no apiserver round trip, and safe under partition: once the
        lease duration passes without a successful renew, a standby may
        hold the lease, so the answer must be False."""
        return self._held and \
            (self._now() - self._last_renew_ok) <= self.duration_s

    @property
    def token(self) -> int:
        """The fencing token of our CURRENT claim (leaseTransitions at
        acquire); stale once someone else acquires."""
        return self._token

    # -- the loop hook ---------------------------------------------------

    def ensure(self, now: Optional[float] = None) -> bool:
        """Acquire or renew when due; returns is_leader. Errors (an
        apiserver partition, a chaos burst) never raise — they just
        mean no successful renew, and local expiry demotes us."""
        now = self._now() if now is None else now
        if now < self._next_attempt:
            return self.is_leader
        self._next_attempt = now + self.renew_every_s
        try:
            res = try_acquire(self.client, self.namespace, self.name,
                              self.identity, self.duration_s, now=now)
        except Exception as e:  # noqa: BLE001 — election must not crash
            log.warning("lease %s/%s: acquire attempt failed for %s: %s",
                        self.namespace, self.name, self.identity, e)
            res = AcquireResult(False, LeaseRecord(), "error")
        if res.acquired:
            self._held = True
            self._last_renew_ok = now
            self._token = res.record.transitions
        else:
            self._held = False
        self._observe(res)
        return self.is_leader

    def _observe(self, res: AcquireResult) -> None:
        from ..obs import registry as obsreg
        leader = self.is_leader
        obsreg.gauge(
            "kftpu_leader",
            "1 while this replica holds its controller lease",
            labels=("lease", "identity")).labels(
                lease=self.name, identity=self.identity).set(
                    1 if leader else 0)
        transitions = res.record.transitions
        if transitions > self._transitions_seen:
            if self._transitions_seen:
                obsreg.counter(
                    "kftpu_lease_transitions_total",
                    "observed changes of lease holder (failovers)",
                    labels=("lease",)).labels(lease=self.name).inc(
                        transitions - self._transitions_seen)
            self._transitions_seen = transitions
        if leader and not self._was_leader:
            log.info("lease %s/%s: %s became leader (token %d)",
                     self.namespace, self.name, self.identity,
                     self._token)
        elif self._was_leader and not leader:
            log.warning("lease %s/%s: %s lost leadership",
                        self.namespace, self.name, self.identity)
        self._was_leader = leader

    def release(self) -> bool:
        """Graceful handoff (shutdown path): clear the lease so the
        standby takes over immediately instead of waiting out the
        duration."""
        self._held = False
        self._observe(AcquireResult(False, LeaseRecord()))
        return release(self.client, self.namespace, self.name,
                       self.identity)


# ----------------------------------------------------------- fenced client


# the KubeClient mutating surface (reads and watches pass unfenced —
# "non-leaders watch but do not write")
MUTATING_OPS = ("create", "update", "update_status", "patch", "delete")


class FencedKubeClient(KubeClient):
    """KubeClient wrapper that rejects mutating calls unless its elector
    currently holds the lease. The enforcement boundary for
    "non-leaders watch but do not write": even if a gating bug let a
    follower's reconcile run, its writes die HERE, client-side, before
    they can race the real leader's. Reads, lists, and watches pass
    through — a hot standby keeps its caches warm."""

    def __init__(self, inner: KubeClient, elector: LeaderElector):
        self.inner = inner
        self.elector = elector
        # fenced-write attempts rejected (the split-brain drill's
        # acceptance number rides on this being observable)
        self.rejected = 0
        self._lock = threading.Lock()

    def _fence(self, op: str, detail: str) -> None:
        if not self.elector.is_leader:
            with self._lock:
                self.rejected += 1
            raise FencingError(
                f"fenced: {self.elector.identity} is not the leader of "
                f"{self.elector.namespace}/{self.elector.name}; "
                f"refusing {op} {detail}")

    # -- mutating surface -------------------------------------------------

    def create(self, obj: dict) -> dict:
        self._fence("create", obj.get("kind", "?"))
        return self.inner.create(obj)

    def update(self, obj: dict) -> dict:
        self._fence("update", obj.get("kind", "?"))
        return self.inner.update(obj)

    def update_status(self, obj: dict) -> dict:
        self._fence("update_status", obj.get("kind", "?"))
        return self.inner.update_status(obj)

    def patch(self, api_version: str, kind: str, namespace: str,
              name: str, patch: dict) -> dict:
        self._fence("patch", f"{kind}/{name}")
        return self.inner.patch(api_version, kind, namespace, name, patch)

    def delete(self, api_version: str, kind: str, namespace: str,
               name: str, cascade: bool = True) -> None:
        self._fence("delete", f"{kind}/{name}")
        return self.inner.delete(api_version, kind, namespace, name,
                                 cascade=cascade)

    # -- read surface -----------------------------------------------------

    def get(self, api_version: str, kind: str, namespace: str,
            name: str) -> dict:
        return self.inner.get(api_version, kind, namespace, name)

    def list(self, api_version: str, kind: str, namespace=None,
             selector=None) -> list[dict]:
        return self.inner.list(api_version, kind, namespace, selector)

    def watch(self, api_version: Optional[str] = None,
              kind: Optional[str] = None) -> Watch:
        return self.inner.watch(api_version, kind)

    def __getattr__(self, name):
        # test-driver helpers (tick, fail_pod, ...) are the harness's
        # hand, not controller traffic — unfenced, like ChaosKubeClient
        return getattr(self.inner, name)
