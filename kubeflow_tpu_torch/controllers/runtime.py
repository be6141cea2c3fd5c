"""Controller manager: watch → workqueue → reconcile.

The port's copy of ``kubeflow_tpu/controllers/runtime.py``: the
controller-runtime analog the training-job operator
(``controllers/tpujob.py``) and the slice scheduler run on. Semantics
kept:

- Level-triggered: reconcilers read desired state from the store, never from
  the event (events only enqueue keys).
- One reconcile at a time per controller (single-reconciler concurrency
  model the reference relies on, SURVEY.md §5 race-detection note).
- Dedup: a key already queued is not queued twice.
- Requeue-on-error with bounded retries.
- Owned-object mapping: events on owned kinds enqueue the owner key
  (the Owns()/Watches() analog).
- Leader election (``cluster/lease.py``): a controller with an
  ``elector`` reconciles only while it holds the lease; a standby keeps
  pumping its watches and writes nothing, and a leadership gain relists.

Deterministic drive: `run_pending()` drains the queue synchronously.
Process drive (the manager process, ``controllers/__main__.py``):
`start()` spins a daemon thread per controller.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..api import k8s
from ..cluster.client import KubeClient, Watch
from ..obs import controlplane as ctrlobs
from ..obs import registry as obsreg

log = logging.getLogger(__name__)


def _reconcile_metrics(controller: str) -> tuple:
    """(latency histogram child, error counter child, queue-depth gauge
    child, retries-exhausted counter child, workqueue-dwell histogram
    child) for one controller — the per-stage accounting every hosted
    reconciler gets for free from the manager loop. Resolved once per
    Controller and held (the registry's resolve-once hot-path rule)."""
    labels = ("controller",)
    return (
        obsreg.histogram(
            "kftpu_reconcile_seconds",
            "wall time of one reconcile pass",
            labels=labels).labels(controller=controller),
        obsreg.counter(
            "kftpu_reconcile_errors_total",
            "reconcile passes that raised (and were requeued)",
            labels=labels).labels(controller=controller),
        obsreg.gauge(
            "kftpu_workqueue_depth",
            "keys waiting in the controller workqueue",
            labels=labels).labels(controller=controller),
        obsreg.counter(
            "kftpu_reconcile_retries_exhausted_total",
            "keys given up on after max_retries failed reconciles "
            "(invisible to alerting as a log line; the blind resync is "
            "the only later recovery)",
            labels=labels).labels(controller=controller),
        ctrlobs.workqueue_dwell_histogram(controller),
    )


def ensure_trace_id(client: KubeClient, manifest: dict) -> dict:
    """Mint a job's trace id on first control-plane contact and persist
    it as the observability.kubeflow.org/trace-id annotation
    (obs/trace.py). Idempotent: once written by ANY component —
    scheduler pass or operator reconcile, whichever touches the job
    first — everyone else reads. Shared here so the two sides of the
    contract cannot drift (the binding_of pattern)."""
    from ..cluster.client import NotFoundError
    from ..obs.trace import TRACE_ID_ANNOTATION, mint_trace_id
    if k8s.annotations_of(manifest).get(TRACE_ID_ANNOTATION):
        return manifest
    # uid-derived: concurrent minters agree without coordination
    # uid + identity: concurrent minters still agree (both read the same
    # manifest), while jobs whose uids collide across clusters sharing
    # one span sink (FakeCluster soaks both hand out uid-1; a restored
    # etcd could too) never merge their streams in the goodput ledger
    meta = manifest.get("metadata", {})
    tid = mint_trace_id(f"{meta.get('uid', '')}:"
                        f"{k8s.namespace_of(manifest, 'default')}/"
                        f"{k8s.name_of(manifest)}")
    try:
        return client.patch(*k8s.key_of(manifest), {
            "metadata": {"annotations": {TRACE_ID_ANNOTATION: tid}}})
    except NotFoundError:
        return manifest


def trace_job_event(component: str, manifest: dict, name: str,
                    **attrs) -> None:
    """Append a point event to a job's trace from a control-plane
    component (no-op without a span sink — KFTPU_SPAN_PATH unset — or
    before the job has a trace id)."""
    from ..obs.trace import TRACE_ID_ANNOTATION, default_tracer
    tracer = default_tracer(component)
    if tracer is None:
        return
    tid = k8s.annotations_of(manifest).get(TRACE_ID_ANNOTATION)
    if not tid:
        return
    tracer.event(name, trace_id=tid,
                 job=f"{k8s.namespace_of(manifest, 'default')}/"
                     f"{k8s.name_of(manifest)}", **attrs)

# A reconcile key: (namespace, name) of the primary object.
Key = tuple[str, str]


@dataclass
class Result:
    requeue: bool = False
    requeue_after: float = 0.0


class Reconciler:
    """Interface: reconcile one object identified by key, level-triggered."""

    #: (apiVersion, kind) of the primary resource
    primary: tuple[str, str] = ("", "")
    #: (apiVersion, kind) list of owned resources whose events map to owners
    owns: list[tuple[str, str]] = []

    def reconcile(self, client: KubeClient, key: Key) -> Result:
        raise NotImplementedError

    def map_event(self, client: KubeClient, obj: dict) -> list[Key]:
        """Optional extra event→keys mapping for watched objects that do
        not carry an owner reference to the primary (label-selector
        aggregation, the controller-runtime EnqueueRequestsFromMapFunc
        analog). Called when owner-ref mapping yields nothing."""
        return []


class _WorkQueue:
    def __init__(self):
        self._items: list[Key] = []
        self._set: set[Key] = set()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # dwell accounting: first-enqueue time per queued key (a re-add
        # while queued dedups, so dwell measures from the FIRST add —
        # the latency the owner object actually experienced)
        self._added: dict[Key, float] = {}
        #: enqueue→pop dwell of the most recently popped key
        self.last_dwell_s: float = 0.0

    def add(self, key: Key) -> None:
        with self._cv:
            if key not in self._set:
                self._set.add(key)
                self._items.append(key)
                self._added[key] = time.monotonic()
                self._cv.notify()

    def pop(self, timeout: Optional[float] = None) -> Optional[Key]:
        with self._cv:
            if not self._items and timeout:
                self._cv.wait(timeout)
            if not self._items:
                return None
            key = self._items.pop(0)
            self._set.discard(key)
            self.last_dwell_s = \
                time.monotonic() - self._added.pop(key, time.monotonic())
            return key

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


@dataclass
class Controller:
    reconciler: Reconciler
    client: KubeClient
    max_retries: int = 5
    # Error-requeue pacing: a failing reconcile re-enters the queue after
    # a jittered exponential delay (base * 2^(attempt-1), capped) instead
    # of immediately — a persistently failing key must not hot-loop
    # through its whole retry budget in microseconds, hammering the
    # apiserver with the same doomed writes. Jitter is seeded by
    # (key, attempt) so retries are deterministic under test.
    retry_backoff_s: float = 0.05
    retry_backoff_max_s: float = 5.0
    # Periodic full relist → enqueue (controller-runtime SyncPeriod
    # analog). A watch event lost in flight (stream drop, chaos-injected
    # fault, apiserver hiccup between reconnect and relist) would
    # otherwise never re-enqueue its key; the resync bounds that blind
    # spot. 0 = off (deterministic tests drive enqueue_existing
    # themselves).
    resync_interval: float = 0.0
    # Leader election (cluster/lease.py LeaderElector): when set, this
    # controller processes keys ONLY while its elector holds the lease.
    # Events keep pumping either way (a hot standby watches but does not
    # write); on gaining leadership the full relist re-enqueues so the
    # new leader adopts whatever happened while it was a follower.
    elector: Optional[object] = None
    queue: _WorkQueue = field(default_factory=_WorkQueue)
    #: relist records ({reason, objects, time}) — initial sync, resync,
    #: leadership gain
    relists: list = field(default_factory=list)
    _watches: list[Watch] = field(default_factory=list)
    _retries: dict[Key, int] = field(default_factory=dict)
    _delayed: list[tuple[float, Key]] = field(default_factory=list)
    _last_resync: float = 0.0
    _stop: threading.Event = field(default_factory=threading.Event)
    # (latency, errors, depth) metric children — resolved on first use
    # and held for the controller's lifetime (hot-path rule)
    _metrics: Optional[tuple] = None

    def __post_init__(self):
        # the audit seam (obs/controlplane.py): every hosted reconciler
        # drives the cluster through an AuditingKubeClient labeled by
        # its controller identity, so per-pass write attribution and the
        # client-vs-server reconciliation work on ALL production paths.
        # Stacked wrappers (chaos, recording) audit what the component
        # ISSUED; an already-audited client is not double-wrapped.
        if not isinstance(self.client, ctrlobs.AuditingKubeClient):
            self.client = ctrlobs.AuditingKubeClient(self.client,
                                                     self._name())

    def _name(self) -> str:
        """The controller's metric/audit identity — the reconciler's
        declared controller_name, falling back to its primary kind
        (the same rule the reconcile metrics use)."""
        return (getattr(self.reconciler, "controller_name", None)
                or (self.reconciler.primary[1] or "unknown").lower())

    def _note_relist(self, reason: str, objects: int) -> None:
        self.relists.append({"reason": reason, "objects": objects,
                             "time": time.time()})
        ctrlobs.record_relist(self._name(), reason, objects)

    # -- wiring -------------------------------------------------------------

    def bind_watches(self) -> None:
        av, kind = self.reconciler.primary
        w = self.client.watch(av, kind)
        self._watches.append(w)
        for oav, okind in self.reconciler.owns:
            self._watches.append(self.client.watch(oav, okind))

    def enqueue_existing(self) -> int:
        """Initial list → enqueue (informer initial sync analog).
        Returns the number of objects listed — relist accounting at the
        call sites (initial/resync/leader-gain) records it."""
        av, kind = self.reconciler.primary
        objs = self.client.list(av, kind)
        for obj in objs:
            self.queue.add((k8s.namespace_of(obj, "default"), k8s.name_of(obj)))
        return len(objs)

    def _map_event_key(self, obj: dict) -> Optional[Key]:
        av_kind = (obj.get("apiVersion"), obj.get("kind"))
        if av_kind == self.reconciler.primary:
            return (k8s.namespace_of(obj, "default"), k8s.name_of(obj))
        # owned object: map to controller owner reference
        pav, pkind = self.reconciler.primary
        for ref in obj.get("metadata", {}).get("ownerReferences", []) or []:
            if ref.get("kind") == pkind and ref.get("apiVersion") == pav:
                return (k8s.namespace_of(obj, "default"), ref.get("name", ""))
        return None

    def pump_events(self, budget: int = 1000) -> int:
        """Drain watch queues into the workqueue (non-blocking)."""
        n = 0
        for w in self._watches:
            while n < budget:
                ev = w.get(timeout=0)
                if ev is None:
                    break
                key = self._map_event_key(ev.obj)
                if key:
                    # DELETED of primary still enqueues: reconcile observes
                    # absence and cleans up (level-triggered).
                    self.queue.add(key)
                    n += 1
                elif (ev.obj.get("apiVersion"), ev.obj.get("kind")) != \
                        self.reconciler.primary:
                    for mapped in self.reconciler.map_event(self.client,
                                                            ev.obj):
                        self.queue.add(mapped)
                        n += 1
        now = time.monotonic()
        due = [k for t, k in self._delayed if t <= now]
        self._delayed = [(t, k) for t, k in self._delayed if t > now]
        for k in due:
            self.queue.add(k)
        if self.resync_interval > 0 and \
                now - self._last_resync >= self.resync_interval:
            self._last_resync = now
            try:
                listed = self.enqueue_existing()
            except Exception as e:  # noqa: BLE001 — resync is best-effort
                log.warning("resync list failed: %s", e)
            else:
                self._note_relist(ctrlobs.RELIST_RESYNC, listed)
        return n

    # -- execution ----------------------------------------------------------

    _was_leader: bool = False

    def _leader_gate(self) -> bool:
        """True when this replica may reconcile (no elector = always).
        A leadership GAIN triggers a full relist: keys that changed
        while we were a follower may have been reconciled by the old
        leader mid-flight — the new leader re-reads everything and
        level-triggered reconciles converge it."""
        if self.elector is None:
            return True
        leading = self.elector.ensure()
        if leading and not self._was_leader:
            try:
                listed = self.enqueue_existing()
            except Exception as e:  # noqa: BLE001 — adopt is best-effort
                log.warning("leader-gain relist failed: %s", e)
            else:
                self._note_relist(ctrlobs.RELIST_LEADER_GAIN, listed)
        self._was_leader = leading
        return leading

    def process_one(self) -> bool:
        if not self._leader_gate():
            return False
        key = self.queue.pop()
        if key is None:
            return False
        if self._metrics is None:
            # label by the reconciler's IDENTITY, not its primary kind:
            # the SliceScheduler's primary is also TPUJob, and merging
            # its cluster-wide pass latencies into the operator's
            # per-job histogram would poison both
            self._metrics = _reconcile_metrics(self._name())
        latency, errors, depth, exhausted, dwell = self._metrics
        dwell.observe(self.queue.last_dwell_s)
        t0 = time.perf_counter()
        try:
            # pass-scoped audit: phase timings, per-key reconcile→write
            # attribution, no-op classification. Reentrant — a
            # reconciler opening its own ctrl_pass (the scheduler)
            # joins this context instead of double-counting.
            with ctrlobs.ctrl_pass(self._name(),
                                   key=f"{key[0]}/{key[1]}"):
                res = self.reconciler.reconcile(self.client, key)
            self._retries.pop(key, None)
            if res.requeue_after > 0:
                self._delayed.append((time.monotonic() + res.requeue_after, key))
            elif res.requeue:
                self.queue.add(key)
        except Exception as e:  # noqa: BLE001 - reconcile errors requeue
            errors.inc()
            n = self._retries.get(key, 0) + 1
            self._retries[key] = n
            if n <= self.max_retries:
                # jittered exponential backoff through the _delayed
                # mechanism: an immediate re-add would burn the whole
                # retry budget in one hot loop with zero time for the
                # fault (an apiserver blip, a half-written sibling
                # object) to clear
                delay = min(self.retry_backoff_s * (2 ** (n - 1)),
                            self.retry_backoff_max_s)
                delay *= random.Random(f"{key}:{n}").uniform(1.0, 1.5)
                log.warning("reconcile %s failed (retry %d/%d in "
                            "%.3fs): %s", key, n, self.max_retries,
                            delay, e)
                self._delayed.append((time.monotonic() + delay, key))
            else:
                exhausted.inc()
                log.error("reconcile %s gave up after %d retries: %s",
                          key, self.max_retries, e)
        finally:
            # a failed pass's latency is still latency — observe both arms
            latency.observe(time.perf_counter() - t0)
            depth.set(len(self.queue))
        return True

    def run_pending(self, max_iters: int = 1000) -> int:
        """Deterministic drain: pump events + process until quiescent.
        A follower (elector present, lease not held) pumps its watches
        and returns — watching without writing is exactly the hot
        standby's job."""
        done = 0
        for _ in range(max_iters):
            self.pump_events()
            if self.elector is not None and not self._leader_gate():
                break
            if not self.process_one():
                self.pump_events()
                if len(self.queue) == 0:
                    break
            else:
                done += 1
        return done

    def start(self, poll_interval: float = 0.05) -> threading.Thread:
        def loop():
            while not self._stop.is_set():
                self.pump_events()
                if not self.process_one():
                    time.sleep(poll_interval)
        t = threading.Thread(target=loop, daemon=True,
                             name=f"ctrl-{self.reconciler.primary[1]}")
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()
        for w in self._watches:
            w.close()  # detach from the server so events stop accumulating


class Manager:
    """Holds a set of controllers over one client (manager.Manager analog)."""

    def __init__(self, client: KubeClient):
        self.client = client
        self.controllers: list[Controller] = []

    def add(self, reconciler: Reconciler, **kwargs) -> Controller:
        c = Controller(reconciler=reconciler, client=self.client, **kwargs)
        c.bind_watches()
        c._note_relist(ctrlobs.RELIST_INITIAL, c.enqueue_existing())
        self.controllers.append(c)
        return c

    def run_pending(self, rounds: int = 10) -> None:
        """Drain all controllers to quiescence (test/deterministic mode).
        Multiple rounds because one controller's writes enqueue another's.
        Every controller must drain every round — any() would short-circuit
        at the first busy controller and starve the rest."""
        for _ in range(rounds):
            done = 0
            for c in self.controllers:
                done += c.run_pending()
            if not done:
                break

    def start_all(self) -> list[threading.Thread]:
        return [c.start() for c in self.controllers]

    def stop_all(self) -> None:
        for c in self.controllers:
            c.stop()
