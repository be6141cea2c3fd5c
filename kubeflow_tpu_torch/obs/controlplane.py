"""Control-plane telemetry: audit accounting and pass-scoped profiling.

The port's copy of what ``cluster/fake.py``, ``cluster/apiserver.py``,
``controllers/runtime.py`` and ``scheduler/core.py`` use from
``kubeflow_tpu/obs/controlplane.py`` (the bench's reconciliation is not
here):

- **One vocabulary, defined once**: the verb, relist-reason and outcome
  literals every layer reports through.
- **``AuditingKubeClient``** wraps any KubeClient, counts every request
  per (verb, kind) under a fixed component name, estimates list
  payloads, and stamps the component into a contextvar so the server
  side attributes the same call to the same component.
- **``ServerAudit``**: the request ledger of the FakeCluster and of the
  REST apiserver (``cluster/apiserver.py``), which attributes a request
  to the component its ``COMPONENT_HEADER`` names (``attributed``).
- **``ctrl_pass()``**: a pass-scoped context (the controller's
  ``process_one``) accumulating the scheduler's phase timings
  (``PassContext.phase``), request and write counts
  and the pass's write amplification; it emits a ``ctrl-pass`` span (no-op
  passes sampled 1-in-N, ``KFTPU_CTRL_SPAN_SAMPLE``).
- ``record_relist`` and ``workqueue_dwell_histogram``: the relist and
  workqueue-dwell metrics of the controller runtime.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from typing import Optional

from ..cluster.client import KubeClient, Watch
from . import registry as obsreg
from .trace import default_tracer, new_span_id

# ------------------------------------------------------------- vocabulary
# Defined ONCE here; every other module imports the constants.

VERB_CREATE = "create"
VERB_GET = "get"
VERB_LIST = "list"
VERB_UPDATE = "update"
VERB_UPDATE_STATUS = "update_status"
VERB_PATCH = "patch"
VERB_DELETE = "delete"
VERB_WATCH = "watch"
VERBS = (VERB_CREATE, VERB_GET, VERB_LIST, VERB_UPDATE, VERB_UPDATE_STATUS,
         VERB_PATCH, VERB_DELETE, VERB_WATCH)
#: verbs that (attempt to) change server state — the write-amplification
#: numerator; a pass issuing zero of these is a no-op pass
MUTATING_VERBS = frozenset((VERB_CREATE, VERB_UPDATE, VERB_UPDATE_STATUS,
                            VERB_PATCH, VERB_DELETE))

#: kind label for an unfiltered watch (no kind selector)
KIND_ANY = "*"

PHASE_SNAPSHOT = "snapshot"      # list/read + parse/validate loop
PHASE_HEALTH = "health-pass"     # node-health fold (scores, quarantines)
PHASE_PLAN = "plan"              # pure planning (carve_down + plan())
PHASE_WRITES = "writes"          # applying decisions (binds/preempts/...)
PHASE_WARM = "warm-pass"         # warm-pool advertisement/reconcile
PHASES = (PHASE_SNAPSHOT, PHASE_HEALTH, PHASE_PLAN, PHASE_WRITES,
          PHASE_WARM)

RELIST_INITIAL = "initial"       # informer initial sync (Manager.add)
RELIST_RESYNC = "resync"         # periodic SyncPeriod relist
RELIST_LEADER_GAIN = "leader-gain"  # adopt-the-world on gaining the lease
RELIST_REASONS = (RELIST_INITIAL, RELIST_RESYNC, RELIST_LEADER_GAIN)

OUTCOME_NOOP = "noop"
OUTCOME_WRITE = "write"

#: requests whose caller did not come through an AuditingKubeClient
#: (test hand-of-god helpers, unaudited components)
UNATTRIBUTED = "unattributed"

#: REST header carrying the caller's component name (cluster/apiserver.py
#: adopts it for the request's server-side attribution)
COMPONENT_HEADER = "X-Kftpu-Component"

CTRL_PASS_SPAN = "ctrl-pass"
#: trace-id prefix for pass spans: each emitted pass is its own trace
CTRL_PASS_TRACE_PREFIX = "ctrlpass-"

#: no-op-pass span sampling: emit 1-in-N no-op ctrl-pass spans per
#: component (write-bearing passes always emit). <=1 emits everything.
CTRL_SPAN_SAMPLE_ENV = "KFTPU_CTRL_SPAN_SAMPLE"
CTRL_SPAN_SAMPLE_DEFAULT = 10


# ---------------------------------------------------- component attribution

# The request-scoped component: AuditingKubeClient sets it for the
# duration of each inner call, so the SERVER side (FakeCluster CRUD)
# attributes the request to the same component the client
# side counted it under — that agreement is what makes the
# client-vs-server reconciliation exact instead of approximate.
_component: contextvars.ContextVar = contextvars.ContextVar(
    "kftpu_ctrl_component", default=UNATTRIBUTED)

# The active pass (ctrl_pass), if any — audited calls report into it so
# a pass knows its own reads/writes/objects-changed without the
# reconciler threading a context through every call site.
_active_pass: contextvars.ContextVar = contextvars.ContextVar(
    "kftpu_ctrl_pass", default=None)


@contextlib.contextmanager
def attributed(component: str):
    """Attribute server-side accounting to ``component`` for the block
    (what AuditingKubeClient does per call; the REST apiserver does it
    for a request that carries ``COMPONENT_HEADER``)."""
    token = _component.set(component)
    try:
        yield
    finally:
        _component.reset(token)


def payload_bytes(objs: list) -> int:
    """Deterministic list-payload estimate: serialized size of the FIRST
    object x count. Exact JSON of a 10k-object list would cost more than
    the pass it measures; the first-object sample is cheap, stable, and
    — computed from identical content on both sides of the wire — lands
    on the SAME number client- and server-side, so byte totals reconcile
    exactly too."""
    if not objs:
        return 0
    return len(json.dumps(objs[0], sort_keys=True,
                          separators=(",", ":"))) * len(objs)


# ------------------------------------------------------- server-side audit

class ServerAudit:
    """The apiserver's own request ledger (FakeCluster and the REST
    ClusterAPIServer each carry one). Plain dicts under one lock are the
    exact bookkeeper; ``export()`` snapshot-bridges them into
    ``kftpu_ctrl_server_*`` counters."""

    def __init__(self):
        self._lock = threading.Lock()
        #: (component, verb, kind) -> request count
        self.requests: dict[tuple, int] = {}
        #: (component, kind) -> objects returned by list
        self.list_objects: dict[tuple, int] = {}
        #: (component, kind) -> estimated list payload bytes
        self.list_bytes: dict[tuple, int] = {}
        #: kind -> mutation events broadcast to the watch plane
        self.watch_broadcasts: dict[str, int] = {}
        #: kind -> event copies delivered (events x matching watchers)
        self.watch_delivered: dict[str, int] = {}

    def record(self, verb: str, kind: str, *, objects: Optional[int] = None,
               nbytes: Optional[int] = None) -> None:
        comp = _component.get()
        with self._lock:
            key = (comp, verb, kind)
            self.requests[key] = self.requests.get(key, 0) + 1
            if objects is not None:
                lk = (comp, kind)
                self.list_objects[lk] = self.list_objects.get(lk, 0) + objects
                self.list_bytes[lk] = self.list_bytes.get(lk, 0) + (nbytes or 0)

    def record_broadcast(self, kind: str, delivered: int) -> None:
        with self._lock:
            self.watch_broadcasts[kind] = self.watch_broadcasts.get(kind, 0) + 1
            self.watch_delivered[kind] = \
                self.watch_delivered.get(kind, 0) + delivered

    def record_delivered(self, kind: str, n: int = 1) -> None:
        """Deliveries without a broadcast event of their own — the REST
        watch streams (each stream is one watcher; the backing
        FakeCluster already counted the broadcast)."""
        with self._lock:
            self.watch_delivered[kind] = \
                self.watch_delivered.get(kind, 0) + n

    def totals(self) -> dict:
        """Snapshot for reconciliation/export (keys copied, safe to hold)."""
        with self._lock:
            return {"requests": dict(self.requests),
                    "list_objects": dict(self.list_objects),
                    "list_bytes": dict(self.list_bytes),
                    "watch_broadcasts": dict(self.watch_broadcasts),
                    "watch_delivered": dict(self.watch_delivered)}

# ------------------------------------------------------- client-side audit

class AuditingKubeClient(KubeClient):
    """Counts every request this component issues, per (verb, kind) —
    the stacking-wrapper pattern (ChaosKubeClient, RecordingKubeClient):
    wraps any inner KubeClient, passes unknown attributes through
    (FakeCluster test helpers keep working), and stamps its component
    into the attribution contextvar around each call so the server's
    ledger agrees with this one. Stacks both ways: audit-over-chaos
    counts what the component TRIED (injected faults included);
    chaos-over-audit counts what reached the server."""

    def __init__(self, inner: KubeClient, component: str):
        self.inner = inner
        self.component = component
        # cross-process attribution: an HTTP inner carries the component
        # in a request header, so a remote apiserver's ServerAudit rows
        # reconcile against this client exactly like FakeCluster's do.
        hdrs = getattr(inner, "_headers", None)
        if isinstance(hdrs, dict):
            hdrs[COMPONENT_HEADER] = component
        self._lock = threading.Lock()
        #: (verb, kind) -> requests issued
        self.requests: dict[tuple, int] = {}
        #: kind -> objects received from list
        self.list_objects: dict[str, int] = {}
        #: kind -> estimated list payload bytes received
        self.list_bytes: dict[str, int] = {}
        # resolved-once registry children, keyed (verb, kind) — the
        # hot-path rule: no label hashing per request
        self._req_children: dict[tuple, object] = {}
        self._list_children: dict[str, tuple] = {}

    def __getattr__(self, name: str):
        return getattr(self.inner, name)

    # -- accounting ---------------------------------------------------------

    def _note(self, verb: str, kind: str, *, ok: bool,
              changed_key: Optional[tuple] = None,
              objects: Optional[int] = None,
              nbytes: Optional[int] = None) -> None:
        with self._lock:
            key = (verb, kind)
            self.requests[key] = self.requests.get(key, 0) + 1
            if objects is not None:
                self.list_objects[kind] = \
                    self.list_objects.get(kind, 0) + objects
                self.list_bytes[kind] = \
                    self.list_bytes.get(kind, 0) + (nbytes or 0)
            child = self._req_children.get(key)
            if child is None:
                child = obsreg.counter(
                    "kftpu_ctrl_requests_total",
                    "control-plane requests issued per "
                    "component/verb/kind", labels=("component", "verb",
                                                   "kind")).labels(
                        component=self.component, verb=verb, kind=kind)
                self._req_children[key] = child
        child.inc()
        if objects is not None:
            pair = self._list_children.get(kind)
            if pair is None:
                pair = (
                    obsreg.counter(
                        "kftpu_ctrl_list_objects_total",
                        "objects received from list per component/kind",
                        labels=("component", "kind")).labels(
                            component=self.component, kind=kind),
                    obsreg.counter(
                        "kftpu_ctrl_list_bytes_total",
                        "estimated list payload bytes received",
                        labels=("component", "kind")).labels(
                            component=self.component, kind=kind))
                with self._lock:
                    self._list_children[kind] = pair
            pair[0].inc(objects)
            pair[1].inc(nbytes or 0)
        ctx = _active_pass.get()
        if ctx is not None:
            ctx.note_request(verb, kind, ok=ok, changed_key=changed_key)

    @contextlib.contextmanager
    def _call(self, verb: str, kind: str,
              changed_key: Optional[tuple] = None):
        """Attribute + count one inner call; failures count too (the
        server processed the request either way, so both ledgers move)."""
        token = _component.set(self.component)
        ok = True
        try:
            yield
        except BaseException:
            ok = False
            raise
        finally:
            _component.reset(token)
            self._note(verb, kind, ok=ok,
                       changed_key=changed_key if ok else None)

    # -- the KubeClient surface ---------------------------------------------

    @staticmethod
    def _obj_key(obj: dict) -> tuple:
        meta = obj.get("metadata", {}) or {}
        return (obj.get("kind", ""), meta.get("namespace", ""),
                meta.get("name", ""))

    def create(self, obj: dict) -> dict:
        with self._call(VERB_CREATE, obj.get("kind", ""),
                        changed_key=self._obj_key(obj)):
            return self.inner.create(obj)

    def get(self, api_version: str, kind: str, namespace: str,
            name: str) -> dict:
        with self._call(VERB_GET, kind):
            return self.inner.get(api_version, kind, namespace, name)

    def list(self, api_version: str, kind: str,
             namespace: Optional[str] = None,
             selector: Optional[dict] = None) -> list[dict]:
        token = _component.set(self.component)
        ok = True
        try:
            out = self.inner.list(api_version, kind, namespace=namespace,
                                  selector=selector)
        except BaseException:
            ok = False
            out = None
            raise
        finally:
            _component.reset(token)
            self._note(VERB_LIST, kind, ok=ok,
                       objects=len(out) if ok else 0,
                       nbytes=payload_bytes(out) if ok else 0)
        return out

    def update(self, obj: dict) -> dict:
        with self._call(VERB_UPDATE, obj.get("kind", ""),
                        changed_key=self._obj_key(obj)):
            return self.inner.update(obj)

    def update_status(self, obj: dict) -> dict:
        with self._call(VERB_UPDATE_STATUS, obj.get("kind", ""),
                        changed_key=self._obj_key(obj)):
            return self.inner.update_status(obj)

    def patch(self, api_version: str, kind: str, namespace: str, name: str,
              patch: dict) -> dict:
        with self._call(VERB_PATCH, kind,
                        changed_key=(kind, namespace, name)):
            return self.inner.patch(api_version, kind, namespace, name,
                                    patch)

    def delete(self, api_version: str, kind: str, namespace: str, name: str,
               cascade: bool = True) -> None:
        with self._call(VERB_DELETE, kind,
                        changed_key=(kind, namespace, name)):
            return self.inner.delete(api_version, kind, namespace, name,
                                     cascade=cascade)

    def watch(self, api_version: Optional[str] = None,
              kind: Optional[str] = None) -> Watch:
        with self._call(VERB_WATCH, kind or KIND_ANY):
            return self.inner.watch(api_version, kind)


# -------------------------------------------------------- pass-scoped audit

class PassContext:
    """Accounting for ONE reconcile/plan pass: phase timings, request
    and write counts, distinct objects changed. Created by ctrl_pass();
    audited clients report into it via the contextvar."""

    def __init__(self, component: str):
        self.component = component
        self.started = time.time()
        #: phase -> accumulated seconds
        self.phases: dict[str, float] = {}
        #: (verb, kind) -> requests within this pass
        self.requests: dict[tuple, int] = {}
        self.mutating_calls = 0
        #: distinct (kind, ns, name) successfully changed
        self.changed: set = set()
        #: free-form span attributes (jobs scanned, key, ...)
        self.attrs: dict = {}

    def note(self, **attrs) -> None:
        """Attach pass-level attributes (land on the ctrl-pass span)."""
        self.attrs.update(attrs)

    def note_request(self, verb: str, kind: str, *, ok: bool,
                     changed_key: Optional[tuple] = None) -> None:
        key = (verb, kind)
        self.requests[key] = self.requests.get(key, 0) + 1
        if verb in MUTATING_VERBS:
            self.mutating_calls += 1
            if ok and changed_key is not None:
                self.changed.add(changed_key)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time one phase; re-entry ACCUMULATES (the snapshot phase runs
        twice in a scheduler pass)."""
        if name not in PHASES:
            raise ValueError(f"unknown ctrl phase {name!r}; "
                             f"vocabulary: {PHASES}")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + \
                time.perf_counter() - t0

    @property
    def wrote(self) -> bool:
        return self.mutating_calls > 0

    @property
    def write_amplification(self) -> float:
        """Mutating calls issued / distinct objects actually changed.
        1.0 is the floor for a write-bearing pass; conflict retries and
        repeated patches to one object push it up. 0.0 for no-op
        passes (no writes to amplify)."""
        if not self.mutating_calls:
            return 0.0
        return self.mutating_calls / max(1, len(self.changed))


# no-op span sampling state: per-component pass counters (deterministic,
# not random — 1-in-N means exactly every Nth no-op pass emits)
_sample_lock = threading.Lock()
_noop_counts: dict[str, int] = {}


def _sample_n() -> int:
    try:
        n = int(os.environ.get(CTRL_SPAN_SAMPLE_ENV) or
                CTRL_SPAN_SAMPLE_DEFAULT)
    except ValueError:
        n = CTRL_SPAN_SAMPLE_DEFAULT
    return max(1, n)


def _should_emit(component: str, wrote: bool) -> bool:
    # write-bearing passes are NEVER sampled away: the span is the only
    # per-pass record of its writes
    if wrote:
        return True
    n = _sample_n()
    with _sample_lock:
        c = _noop_counts.get(component, 0)
        _noop_counts[component] = c + 1
    return c % n == 0


def _finish_pass(ctx: PassContext, duration: float) -> None:
    comp = ctx.component
    outcome = OUTCOME_WRITE if ctx.wrote else OUTCOME_NOOP
    obsreg.counter(
        "kftpu_ctrl_passes_total",
        "reconcile/plan passes by outcome (no-op-pass ratio = "
        "noop / total)", labels=("component", "outcome")).labels(
            component=comp, outcome=outcome).inc()
    obsreg.histogram(
        "kftpu_ctrl_pass_seconds", "wall time of one pass",
        labels=("component",)).labels(component=comp).observe(duration)
    if ctx.phases:
        phase_h = obsreg.histogram(
            "kftpu_ctrl_pass_phase_seconds",
            "per-phase wall time within one pass",
            labels=("component", "phase"))
        for name, sec in ctx.phases.items():
            phase_h.labels(component=comp, phase=name).observe(sec)
    if ctx.wrote:
        obsreg.counter(
            "kftpu_ctrl_pass_writes_total",
            "mutating calls issued by passes",
            labels=("component",)).labels(component=comp).inc(
                ctx.mutating_calls)
        obsreg.counter(
            "kftpu_ctrl_pass_objects_changed_total",
            "distinct objects actually changed by passes",
            labels=("component",)).labels(component=comp).inc(
                len(ctx.changed))
        obsreg.gauge(
            "kftpu_ctrl_write_amplification",
            "last write-bearing pass: mutating calls / distinct "
            "objects changed", labels=("component",)).labels(
                component=comp).set(round(ctx.write_amplification, 6))
    if not _should_emit(comp, ctx.wrote):
        return
    tracer = default_tracer(comp)
    if tracer is None:
        return
    span_id = new_span_id()
    trace_id = CTRL_PASS_TRACE_PREFIX + span_id
    attrs = dict(ctx.attrs)
    attrs.update(component=comp, outcome=outcome,
                 requests=sum(ctx.requests.values()),
                 writes=ctx.mutating_calls,
                 objects_changed=len(ctx.changed))
    if ctx.wrote:
        attrs["write_amplification"] = round(ctx.write_amplification, 4)
    else:
        attrs["sample_n"] = _sample_n()
    end = ctx.started + duration
    tracer.emit(CTRL_PASS_SPAN, start=ctx.started, end=end,
                trace_id=trace_id, span_id=span_id, **attrs)


@contextlib.contextmanager
def ctrl_pass(component: str, **attrs):
    """Scope one reconcile/plan pass. Reentrant: a reconciler that opens
    its own pass while the controller runtime already opened one (the
    SliceScheduler under a Controller) joins the ACTIVE context instead
    of double-counting the pass."""
    active = _active_pass.get()
    if active is not None:
        active.attrs.update(attrs)
        yield active
        return
    ctx = PassContext(component)
    ctx.attrs.update(attrs)
    tok_c = _component.set(component)
    tok_p = _active_pass.set(ctx)
    t0 = time.perf_counter()
    try:
        yield ctx
    finally:
        duration = time.perf_counter() - t0
        _active_pass.reset(tok_p)
        _component.reset(tok_c)
        _finish_pass(ctx, duration)


def record_relist(component: str, reason: str, objects: int) -> None:
    """Account one full relist (initial sync / periodic resync) — the
    list-storm signal the scale-out tier's
    informer caches are meant to flatten."""
    if reason not in RELIST_REASONS:
        raise ValueError(f"unknown relist reason {reason!r}; "
                         f"vocabulary: {RELIST_REASONS}")
    labels = ("component", "reason")
    obsreg.counter(
        "kftpu_ctrl_relists_total", "full relists by reason",
        labels=labels).labels(component=component, reason=reason).inc()
    obsreg.counter(
        "kftpu_ctrl_relist_objects_total",
        "objects re-listed (and re-enqueued) by relists",
        labels=labels).labels(component=component, reason=reason).inc(
            max(0, int(objects)))


def workqueue_dwell_histogram(component: str):
    """Resolved child for the workqueue dwell histogram (enqueue→pop
    latency per key) — resolved once per controller, held (hot-path
    rule)."""
    return obsreg.histogram(
        "kftpu_ctrl_workqueue_dwell_seconds",
        "enqueue-to-pop dwell per workqueue key",
        labels=("component",)).labels(component=component)
