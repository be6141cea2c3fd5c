"""Chaos drills: the operator loop's fault menus, checkpoint faults and the
serving fleet's fault menu.

The parts of ``kubeflow_tpu/cluster/chaos.py`` the port needs:

- ``ChaosKubeClient``: wraps any KubeClient and injects seeded transient
  faults (``TransientAPIError`` bursts, watch-stream drops) at the client
  surface; the test driver's own helpers pass through un-faulted;
- the control-plane arm ``ControllerChaos`` (a controller killed right
  after a write lands, an apiserver partition, a stale watch replay, a
  hard death) and ``RecordingKubeClient`` (every mutating call a
  replica makes, Lease renewals aside): the clients of
  ``scheduler/soak.py`` ``ControlPlaneSoak`` and the split-brain drill;
- the soaks: ``ChaosSoak`` (pod kill and fail, an API burst, a watch
  drop, a truncated checkpoint, a hung chief) and ``SentinelSoak`` (a
  numeric fault inside the training loop — ``NaNInjector``,
  ``LossSpikePoisoner``, ``BitFlipGrad`` — and the operator's LKG
  rollback) drive one job end to end: the real operator loop
  (``FakeCluster``, the controller runtime, ``TrainingJobReconciler``)
  around real training segments, each a call of the port's
  ``runtime.worker.train`` on the soak's device with the env the
  reconciler rendered into the chief pod;
- the host-pinned faults the scheduler soaks (``scheduler/soak.py``)
  drive: ``HostFault`` (a flaky node on which every gang pod dies, for a
  budget of trips) and ``CapacityLoss`` (the device plugin losing half
  of one node's GPUs, and getting them back);
- the corruptors a chaos drill applies to a checkpoint directory between
  training segments (a truncated payload file under a committed step, a
  step whose commit marker is gone) and ``final_params``, which restores
  the newest intact step's params the way a resumed worker would;
- the serving arm: ``ChaosServable`` (scriptable serving faults),
  ``ServingReplicaHarness`` (one restartable in-process replica, over a
  ChaosServable or a real servable such as the LM on the card) and
  ``ServingSoak`` (the kill, drain, wedge and hedge scenarios behind a
  FleetRouter, and ``audit()``).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..api import k8s
from ..runtime.checkpoint import (MANIFEST_NAME, ORBAX_COMMIT_MARKER,
                                  CheckpointManager)
from .client import KubeClient, KubeError, Watch

log = logging.getLogger(__name__)


class TransientAPIError(KubeError):
    """An injected transient failure: the 5xx / connection-timeout class a
    real apiserver emits under load. Retryable by contract — controllers
    and the HTTP client must survive a bounded burst of these."""


# the client ops eligible for injection (the KubeClient surface)
CHAOS_OPS = ("create", "get", "list", "update", "update_status", "patch",
             "delete")

@dataclass
class ChaosPolicy:
    """Seeded background fault schedule for ChaosKubeClient.

    ``error_rate`` injects a TransientAPIError on that fraction of eligible
    calls (seeded — the same seed replays the same fault positions);
    ``max_errors`` bounds the total so a soak always makes progress.
    Explicit bursts (``fail_next``) ride on top and ignore the budget.
    """

    seed: int = 0
    error_rate: float = 0.0
    max_errors: int = 0          # 0 = no rate-based injection
    ops: tuple = CHAOS_OPS


@dataclass
class InjectedFault:
    op: str
    detail: str
    at_call: int
    kind: str = "api-error"


class ChaosKubeClient(KubeClient):
    """KubeClient wrapper injecting seeded transient faults.

    Helper attributes not on the KubeClient surface (FakeCluster's tick,
    fail_pod, add_gpu_nodes, ...) delegate to the inner client
    UN-faulted: they are the test driver's hand, not controller traffic.
    """

    def __init__(self, inner: KubeClient,
                 policy: Optional[ChaosPolicy] = None):
        self.inner = inner
        self.policy = policy or ChaosPolicy()
        self._rng = random.Random(self.policy.seed)
        self._burst = 0
        self._rate_injected = 0
        self.calls = 0
        self.injected: list[InjectedFault] = []
        self._live_watches: list[Watch] = []

    # ----------------------------------------------------------- injection

    def fail_next(self, n: int = 1) -> None:
        """Arm an explicit burst: the next n eligible calls raise
        TransientAPIError (an apiserver 5xx burst / brief outage)."""
        self._burst += int(n)

    def _maybe_fail(self, op: str, detail: str) -> None:
        self.calls += 1
        if op not in self.policy.ops:
            return
        if self._burst > 0:
            self._burst -= 1
            self.injected.append(InjectedFault(op, detail, self.calls))
            raise TransientAPIError(
                f"injected 5xx: {op} {detail} (burst)")
        if (self.policy.error_rate > 0
                and self._rate_injected < self.policy.max_errors
                and self._rng.random() < self.policy.error_rate):
            self._rate_injected += 1
            self.injected.append(InjectedFault(op, detail, self.calls))
            raise TransientAPIError(
                f"injected 5xx: {op} {detail} "
                f"({self._rate_injected}/{self.policy.max_errors})")

    # ------------------------------------------------- KubeClient surface

    def create(self, obj: dict) -> dict:
        self._maybe_fail("create", k8s.name_of(obj))
        return self.inner.create(obj)

    def get(self, api_version: str, kind: str, namespace: str,
            name: str) -> dict:
        self._maybe_fail("get", f"{kind}/{name}")
        return self.inner.get(api_version, kind, namespace, name)

    def list(self, api_version: str, kind: str, namespace=None,
             selector=None) -> list[dict]:
        self._maybe_fail("list", kind)
        return self.inner.list(api_version, kind, namespace, selector)

    def update(self, obj: dict) -> dict:
        self._maybe_fail("update", k8s.name_of(obj))
        return self.inner.update(obj)

    def update_status(self, obj: dict) -> dict:
        self._maybe_fail("update_status", k8s.name_of(obj))
        return self.inner.update_status(obj)

    def patch(self, api_version: str, kind: str, namespace: str, name: str,
              patch: dict) -> dict:
        self._maybe_fail("patch", f"{kind}/{name}")
        return self.inner.patch(api_version, kind, namespace, name, patch)

    def delete(self, api_version: str, kind: str, namespace: str, name: str,
               cascade: bool = True) -> None:
        self._maybe_fail("delete", f"{kind}/{name}")
        return self.inner.delete(api_version, kind, namespace, name,
                                 cascade=cascade)

    def watch(self, api_version=None, kind=None) -> Watch:
        w = self.inner.watch(api_version, kind)
        self._live_watches.append(w)
        return w

    def drop_watch_streams(self) -> int:
        """Close every watch opened through this client — the mid-run
        stream drop a flaky apiserver/LB produces. FakeCluster watches do
        not reconnect, so recovery must come from the controller's
        periodic resync (controllers/runtime.py resync_interval)."""
        dropped = 0
        for w in self._live_watches:
            if not w.closed:
                w.close()
                dropped += 1
        self.injected.append(InjectedFault(
            "watch", f"dropped {dropped} streams", self.calls,
            kind="watch-drop"))
        return dropped

    def __getattr__(self, name):
        # FakeCluster test helpers (tick, fail_pod, set_pod_phase, ...)
        return getattr(self.inner, name)


# ------------------------------------------------- control-plane faults
# The ControllerChaos arm: faults against the control plane itself. A
# controller process dying is not a 5xx: its in-memory state (queues,
# retry counts, first-seen maps) evaporates while its half-finished
# writes stay in the cluster. These are the seeded kill-points that
# produce exactly those states.


class ControllerCrash(KubeError):
    """The controller process died. Raised AFTER the triggering write
    landed (the write is on the wire when the process is killed), and
    on every call thereafter — a dead process has no connection."""


# controller-chaos fault kinds (scheduler/soak.py ControlPlaneSoak menu)
CTRL_FAULT_KINDS = ("kill-operator", "kill-scheduler",
                    "apiserver-partition", "stale-watch-rewind")


class ControllerChaos(ChaosKubeClient):
    """ChaosKubeClient plus the control-plane fault menu:

    - ``die_after(op, n)`` — the controller is killed immediately AFTER
      its nth matching call SUCCEEDS: the write persisted, the process
      did not. ``die_after("create", 2)`` kills the operator mid-gang-
      create (service + first pod landed, rest of the gang never
      created); arming it on the scheduler right before a bind kills it
      between the binding write and the operator's pod creates.
    - ``partition(seconds)`` — every call (reads included) raises
      TransientAPIError until the deadline: the apiserver is on the
      other side of a network split. Leases cannot renew through it, so
      a partitioned leader demotes itself (cluster/lease.py).
    - ``rewind_watch()`` — re-delivers the current state of every object
      as MODIFIED events carrying a STALE resourceVersion into the live
      watch streams (a reconnecting informer replaying history).
      Level-triggered reconcilers must re-read and no-op.
    - ``kill()`` / ``revive()`` — hard process death: every subsequent
      call raises ControllerCrash until revived (a killed replica's
      client object may leak into scheduled work; it must never write).
    """

    def __init__(self, inner: KubeClient,
                 policy: Optional[ChaosPolicy] = None):
        super().__init__(inner, policy)
        self.dead = False
        self._die_arm: Optional[tuple] = None   # (op, remaining)
        self._partition_until = 0.0

    # ------------------------------------------------------------ arming

    def die_after(self, op: str, n: int = 1) -> None:
        self._die_arm = (op, int(n))

    def partition(self, seconds: float) -> None:
        self._partition_until = time.monotonic() + seconds
        self.injected.append(InjectedFault(
            "partition", f"{seconds:.2f}s", self.calls,
            kind="apiserver-partition"))

    @property
    def partitioned(self) -> bool:
        return time.monotonic() < self._partition_until

    def kill(self) -> None:
        self.dead = True

    def revive(self) -> None:
        self.dead = False
        self._die_arm = None

    def rewind_watch(self) -> int:
        """Replay every object as a stale-rv MODIFIED event into the
        live watches (the stale-watch-rewind fault). Returns events
        delivered."""
        import copy as _copy

        from .client import MODIFIED as _MOD
        from .client import WatchEvent as _WE
        delivered = 0
        # the driver's hand: read current state through the inner client
        # (no fault injection), stamp a stale rv, replay into the streams
        for obj in list(getattr(self.inner, "_objects", {}).values()):
            stale = _copy.deepcopy(obj)
            stale.setdefault("metadata", {})["resourceVersion"] = "1"
            for w in self._live_watches:
                if not w.closed and w.matches(stale):
                    w.deliver(_WE(_MOD, stale))
                    delivered += 1
        self.injected.append(InjectedFault(
            "watch", f"rewound {delivered} events", self.calls,
            kind="stale-watch-rewind"))
        return delivered

    # --------------------------------------------------------- injection

    def _maybe_fail(self, op: str, detail: str) -> None:
        if self.dead:
            raise ControllerCrash(f"controller is dead ({op} {detail})")
        if self.partitioned:
            self.calls += 1
            raise TransientAPIError(
                f"injected partition: {op} {detail}")
        super()._maybe_fail(op, detail)

    def _maybe_die(self, op: str, kind: str = "") -> None:
        if self._die_arm is None:
            return
        if kind == "Lease":
            # the elector shares this connection: a kill-point armed on
            # the controller's writes must not fire on a lease renewal
            # (renews happen every duration/3 — they would win the race
            # to the armed death nearly every time, and the mid-write
            # window the soak exists to exercise would go untested)
            return
        armed_op, remaining = self._die_arm
        if op != armed_op:
            return
        remaining -= 1
        if remaining > 0:
            self._die_arm = (armed_op, remaining)
            return
        self._die_arm = None
        self.dead = True
        self.injected.append(InjectedFault(
            op, "controller killed after this call landed", self.calls,
            kind="controller-crash"))
        raise ControllerCrash(
            f"controller killed right after {op} landed")

    # kill-point wrapping: the inner call SUCCEEDS first, then the
    # process "dies" — exactly the crash-consistency window

    def create(self, obj: dict) -> dict:
        out = super().create(obj)
        self._maybe_die("create", obj.get("kind", ""))
        return out

    def update(self, obj: dict) -> dict:
        out = super().update(obj)
        self._maybe_die("update", obj.get("kind", ""))
        return out

    def update_status(self, obj: dict) -> dict:
        out = super().update_status(obj)
        self._maybe_die("update_status", obj.get("kind", ""))
        return out

    def patch(self, api_version: str, kind: str, namespace: str,
              name: str, patch: dict) -> dict:
        out = super().patch(api_version, kind, namespace, name, patch)
        self._maybe_die("patch", kind)
        return out

    def delete(self, api_version: str, kind: str, namespace: str,
               name: str, cascade: bool = True) -> None:
        out = super().delete(api_version, kind, namespace, name,
                             cascade=cascade)
        self._maybe_die("delete", kind)
        return out


class RecordingKubeClient(KubeClient):
    """KubeClient wrapper recording every MUTATING call that passes
    through it — the audit layer the HA acceptance criteria ride on
    ("non-leader processes provably make zero mutating calls").
    ``ignore_kinds`` excludes the election mechanism itself (Lease
    renewals are how a standby stays a standby, not controller
    writes)."""

    def __init__(self, inner: KubeClient,
                 ignore_kinds: tuple = ("Lease",)):
        self.inner = inner
        self.ignore_kinds = tuple(ignore_kinds)
        self.mutations: list[tuple] = []   # (op, kind, namespace, name)
        self._lock = threading.Lock()

    def _note(self, op: str, kind: str, namespace: str,
              name: str) -> None:
        if kind in self.ignore_kinds:
            return
        with self._lock:
            self.mutations.append((op, kind, namespace, name))

    def create(self, obj: dict) -> dict:
        self._note("create", obj.get("kind", ""),
                   k8s.namespace_of(obj, ""), k8s.name_of(obj))
        return self.inner.create(obj)

    def update(self, obj: dict) -> dict:
        self._note("update", obj.get("kind", ""),
                   k8s.namespace_of(obj, ""), k8s.name_of(obj))
        return self.inner.update(obj)

    def update_status(self, obj: dict) -> dict:
        self._note("update_status", obj.get("kind", ""),
                   k8s.namespace_of(obj, ""), k8s.name_of(obj))
        return self.inner.update_status(obj)

    def patch(self, api_version: str, kind: str, namespace: str,
              name: str, patch: dict) -> dict:
        self._note("patch", kind, namespace, name)
        return self.inner.patch(api_version, kind, namespace, name, patch)

    def delete(self, api_version: str, kind: str, namespace: str,
               name: str, cascade: bool = True) -> None:
        self._note("delete", kind, namespace, name)
        return self.inner.delete(api_version, kind, namespace, name,
                                 cascade=cascade)

    def get(self, api_version: str, kind: str, namespace: str,
            name: str) -> dict:
        return self.inner.get(api_version, kind, namespace, name)

    def list(self, api_version: str, kind: str, namespace=None,
             selector=None) -> list[dict]:
        return self.inner.list(api_version, kind, namespace, selector)

    def watch(self, api_version=None, kind=None) -> Watch:
        return self.inner.watch(api_version, kind)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def latest_step_dir(directory: str) -> Optional[str]:
    """The newest integer-named step directory, committed or not: the raw
    view a corruptor targets (restore never uses it)."""
    try:
        steps = sorted(int(n) for n in os.listdir(directory)
                       if n.isdigit()
                       and os.path.isdir(os.path.join(directory, n)))
    except OSError:
        return None
    return os.path.join(directory, str(steps[-1])) if steps else None


def truncate_checkpoint_payload(step_dir: str, keep_frac: float = 0.5
                                ) -> str:
    """Truncate the largest payload file of a committed step (a node that
    died mid-write). The commit marker stays, so only the manifest can
    catch it. Returns the truncated path."""
    candidates = []
    for root, _dirs, files in os.walk(step_dir):
        for fname in files:
            if fname in (MANIFEST_NAME, ORBAX_COMMIT_MARKER):
                continue
            path = os.path.join(root, fname)
            candidates.append((os.path.getsize(path), path))
    if not candidates:
        raise FileNotFoundError(f"no payload files under {step_dir}")
    size, path = max(candidates)
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * keep_frac)))
    log.info("chaos: truncated %s to %d/%d bytes", path,
             max(1, int(size * keep_frac)), size)
    return path


def uncommit_checkpoint(step_dir: str) -> None:
    """Remove the commit marker (a writer that died before finalizing):
    ``latest_step()`` must skip the step."""
    marker = os.path.join(step_dir, ORBAX_COMMIT_MARKER)
    if os.path.exists(marker):
        os.remove(marker)


def final_params(checkpoint_dir: str, device="cuda") -> dict:
    """The params of the newest intact step, on ``device`` (cuda unless
    the caller asks for the CPU): corrupted steps fall back."""
    mgr = CheckpointManager(checkpoint_dir)
    try:
        return mgr.restore_params(device=device)
    finally:
        mgr.close()


# ------------------------------------------------- host-pinned faults


@dataclass
class HostFault:
    """A RECURRING fault pinned to one node — the failure class the
    node-health subsystem (scheduler/health.py) exists for. It fails one
    gang pod running on its node each time it fires, until its ``trips``
    budget runs out: a flaky node crash-loops every gang placed on it,
    however many times the operator restarts the gang — only migrating
    OFF the node (the suspect/quarantine path) or exhausting the budget
    (the node "recovers") ends the loop."""

    node: str
    trips: int = 3
    fired: int = 0

    def maybe_fire(self, cluster, namespace: str) -> Optional[str]:
        """Fail the first Running pod on the node, if any and the trips
        budget allows; returns the victim pod name."""
        if self.fired >= self.trips:
            return None
        pods = sorted(
            (p for p in cluster.list("v1", "Pod", namespace)
             if p.get("spec", {}).get("nodeName") == self.node
             and p.get("status", {}).get("phase") == "Running"),
            key=k8s.name_of)
        if not pods:
            return None
        victim = k8s.name_of(pods[0])
        self.fired += 1
        cluster.fail_pod(namespace, victim, f"chaos: flaky node {self.node}")
        log.info("chaos: host fault on %s: %s failed (trip %d/%d)",
                 self.node, victim, self.fired, self.trips)
        return victim


@dataclass
class CapacityLoss:
    """GPUs dropping off one node mid-run: the device plugin reports
    ``keep`` of them allocatable (half of an 8-GPU node by default) and
    the gang pods on the lost GPUs fail. The inventory carves the lost
    GPUs down, so a binding covering them invalidates: the failure class
    elastic shrink-to-survive exists for (scheduler/core.py — a gang
    with no same-size run left re-binds DEGRADED instead of starving).
    ``restore()`` reports every GPU again, which is what grow-to-fill
    recovers into. A gang pod's GPU is its slice's first GPU plus its
    index in the slice (the ``scheduling.kubeflow.org/slice`` run the
    operator stamps); a pod without one is counted in name order."""

    node: str
    keep: int = 4
    _total: Optional[int] = field(default=None, repr=False)

    def fire(self, cluster, namespace: str = "") -> list[str]:
        """Lower the node's allocatable GPUs to ``keep`` and fail the
        live pods of the lost ones; returns the failed pod names."""
        import json as _json

        from ..controllers.tpujob import SLICE_ANNOTATION
        from .fake import GPU_RESOURCE
        node = cluster.get("v1", "Node", "", self.node)
        self._total = int(k8s.parse_quantity(
            node["status"]["allocatable"][GPU_RESOURCE]))
        cluster.set_node_gpus(self.node, self.keep)
        live = sorted(
            (p for p in cluster.list("v1", "Pod", namespace or None)
             if p.get("spec", {}).get("nodeName") == self.node
             and p.get("status", {}).get("phase") in ("Pending",
                                                      "Running")),
            key=k8s.name_of)
        failed = []
        for n, pod in enumerate(live):
            gpu = n
            raw = k8s.annotations_of(pod).get(SLICE_ANNOTATION)
            if raw:
                rect = _json.loads(raw)
                index = int(k8s.labels_of(pod).get(
                    "kubeflow.org/replica-index", 0))
                gpu = int(rect["y"]) + index % int(rect["w"])
            if gpu >= self.keep:
                cluster.fail_pod(k8s.namespace_of(pod), k8s.name_of(pod),
                                 f"chaos: GPU {gpu} of {self.node} lost")
                failed.append(k8s.name_of(pod))
        log.info("chaos: capacity loss — node %s down to %d GPUs",
                 self.node, self.keep)
        return failed

    def restore(self, cluster) -> bool:
        """Report every GPU again (the GPUs came back, or were
        replaced)."""
        if self._total is None:
            return False
        cluster.set_node_gpus(self.node, self._total)
        self._total = None
        log.info("chaos: capacity restored — node %s is whole", self.node)
        return True


# fault kinds the soak can inject between training segments
SOAK_FAULT_KINDS = ("pod-kill", "pod-fail", "api-burst", "watch-drop",
                    "truncate-ckpt", "hung-chief")


@dataclass
class SoakFault:
    """Inject `kind` once training has reached `at_step` global steps."""

    at_step: int
    kind: str

    def __post_init__(self):
        if self.kind not in SOAK_FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(choose from {SOAK_FAULT_KINDS})")


# the soaks' job kind and the accelerator replica's template
_JOB_AV, _JOB_KIND = "tpu.kubeflow.org/v1alpha1", "TPUJob"
_TEMPLATE = {"spec": {"containers": [{"name": "trainer",
                                      "image": "trainer:v1"}]}}


def _soak_cluster(soak):
    """(cluster, chaos client, manager): a FakeCluster with one node of
    ``soak.node_topology`` (the job's topology when unset) labeled with
    its generation's product, and the training-job reconciler on a
    ChaosKubeClient over it."""
    from ..controllers.runtime import Manager
    from ..controllers.tpujob import TrainingJobReconciler
    from .fake import FakeCluster
    cluster = FakeCluster()
    cluster.add_gpu_nodes(soak.node_topology or soak.topology)
    chaos = ChaosKubeClient(cluster)
    mgr = Manager(chaos)
    ctrl = mgr.add(TrainingJobReconciler(_JOB_KIND))
    # watch-drop recovery depends on the periodic resync; keep it tight
    # so the soak converges quickly
    ctrl.resync_interval = 0.02
    return cluster, chaos, mgr


def _gang_size(soak) -> int:
    from ..api.topology import parse_topology
    return parse_topology(soak.topology).pods_per_slice


def _chief_env(cluster, namespace: str, chief: str, report: dict) -> dict:
    """The env the operator rendered into the chief pod; the report keeps
    the first chief pod object it saw (``chief_pod``: its resources,
    selector and env, as the reconciler wrote them)."""
    obj = cluster.get("v1", "Pod", namespace, chief)
    report.setdefault("chief_pod", obj)
    return {e["name"]: e.get("value", "")
            for e in obj["spec"]["containers"][0].get("env", [])}


def _train_segment(soak, env_map: dict, target: int):
    """One training segment: the port's ``worker.train`` on the soak's
    device, up to ``target`` steps, from the env the operator rendered
    into the chief pod (checkpoint dir, resume dir and the trace
    contract). ``soak.train_kwargs`` overrides the tiny-LM defaults."""
    from ..obs.trace import adopt_trace_env
    from ..runtime import worker
    kw = dict(workload="transformer", global_batch=soak.global_batch,
              sync_every=1, seed=soak.seed, handle_sigterm=False,
              workload_kwargs={})
    kw.update(soak.train_kwargs or {})
    kw.update(steps=target, device=soak.device,
              checkpoint_dir=env_map.get("KFTPU_CHECKPOINT_DIR"),
              checkpoint_every=soak.checkpoint_every,
              resume_from=env_map.get("KFTPU_RESUME_FROM"))
    # adopt the operator-rendered trace contract for the segment: the
    # in-process "worker" reads the SAME env a real pod would, so its
    # window/ckpt spans stitch onto the job's trace id
    with adopt_trace_env(env_map):
        return worker.train(**kw)


@dataclass
class ChaosSoak:
    """Drive one TPUJob through a scripted fault sequence, end to end.

    The control plane is real (FakeCluster + scheduler + the TPUJob
    reconciler, over a ChaosKubeClient); the data plane is real too — each
    time the gang is fully Running, a REAL training segment
    (``runtime/worker.train`` on ``device``: the tiny LM by default, or
    whatever ``train_kwargs`` names) runs
    in-process using the env the operator rendered into the chief pod
    (KFTPU_CHECKPOINT_DIR / KFTPU_RESUME_FROM), up to the next scripted
    fault's step. Faults then hit the cluster, the controller recovers
    (gang restart + resume), and the loop continues until the job reaches
    ``total_steps`` and the chief succeeds.

    Determinism: state.rng is checkpointed and the synthetic batch pool is
    seed-derived, so replayed steps recompute identical params — the
    report's final params must match an uninjected run bit-for-bit up to
    float tolerance (≤1e-5).

    The job's GPU replica is ``topology`` (``h100-2`` by default: a gang
    of 2 pods, as the JAX soak's slice is 2 hosts) on one node of
    ``node_topology`` (the job's when unset).
    """

    workdir: str
    faults: list = field(default_factory=list)
    device: str = "cuda"
    train_kwargs: Optional[dict] = None
    topology: str = "h100-2"
    node_topology: Optional[str] = None
    total_steps: int = 6
    checkpoint_every: int = 2
    seed: int = 0
    global_batch: int = 8
    stall_timeout_s: int = 30
    restart_backoff_s: float = 0.02
    restart_backoff_max_s: float = 0.2
    wall_budget_s: float = 300.0
    namespace: str = "kubeflow"
    job_name: str = "chaos-soak"

    def _manifest(self, ckpt_dir: str) -> dict:
        return {
            "apiVersion": _JOB_AV, "kind": _JOB_KIND,
            "metadata": {"name": self.job_name,
                         "namespace": self.namespace},
            "spec": {
                "checkpointDir": ckpt_dir,
                "replicaSpecs": {"GPU": {"gpuTopology": self.topology,
                                         "template": _TEMPLATE}},
                "runPolicy": {
                    "backoffLimit": len(self.faults) + 3,
                    "restartBackoffSeconds": self.restart_backoff_s,
                    "restartBackoffMaxSeconds": self.restart_backoff_max_s,
                    "stallTimeoutSeconds": self.stall_timeout_s,
                },
            },
        }

    def _heartbeat(self, cluster, chief: str, step: int,
                   stale_by_s: float = 0.0) -> None:
        import json as _json
        from ..api.trainingjob import HEARTBEAT_ANNOTATION
        payload = _json.dumps({"step": step,
                               "time": time.time() - stale_by_s})
        cluster.patch("v1", "Pod", self.namespace, chief,
                      {"metadata": {"annotations":
                                    {HEARTBEAT_ANNOTATION: payload}}})

    def _inject(self, fault: SoakFault, cluster, chaos: ChaosKubeClient,
                ckpt_dir: str, chief: str, step: int) -> None:
        log.info("chaos soak: injecting %s at step %d", fault.kind, step)
        worker_pods = sorted(
            k8s.name_of(p)
            for p in cluster.list("v1", "Pod", self.namespace))
        victim = worker_pods[-1] if worker_pods else chief
        if fault.kind == "pod-kill":
            # preemption deletes the pod OBJECT (no Failed phase): the
            # vanish detector must gang-restart
            cluster.delete("v1", "Pod", self.namespace, victim)
        elif fault.kind == "pod-fail":
            cluster.fail_pod(self.namespace, victim, "chaos: worker died")
        elif fault.kind == "api-burst":
            # a 5xx burst right as the gang fails: reconcile attempts hit
            # injected errors and must retry through them
            chaos.fail_next(3)
            cluster.fail_pod(self.namespace, victim, "chaos: worker died")
        elif fault.kind == "watch-drop":
            chaos.drop_watch_streams()
            cluster.fail_pod(self.namespace, victim, "chaos: worker died")
        elif fault.kind == "truncate-ckpt":
            step_dir = latest_step_dir(ckpt_dir)
            if step_dir:
                truncate_checkpoint_payload(step_dir)
            cluster.fail_pod(self.namespace, victim, "chaos: worker died")
        elif fault.kind == "hung-chief":
            # live pod, stale heartbeat: only the stall watchdog recovers
            self._heartbeat(cluster, chief, step,
                            stale_by_s=self.stall_timeout_s + 5)

    def run(self) -> dict:
        from ..controllers.tpujob import RESTART_COUNT_ANNOTATION

        ckpt_dir = os.path.join(self.workdir, "ckpt")
        cluster, chaos, mgr = _soak_cluster(self)
        gang = _gang_size(self)
        cluster.create(self._manifest(ckpt_dir))

        pending = sorted((SoakFault(f.at_step, f.kind) if
                          not isinstance(f, SoakFault) else f
                          for f in self.faults), key=lambda f: f.at_step)
        report: dict = {"injected": [], "restart_reasons": [],
                        "segments": 0, "executed_steps": 0,
                        "outcome": "timeout"}
        deadline = time.monotonic() + self.wall_budget_s
        chief = f"{self.job_name}-worker-0-0"
        reached = 0
        while time.monotonic() < deadline:
            mgr.run_pending()
            cluster.tick()
            mgr.run_pending()
            job = cluster.get_or_none(_JOB_AV, _JOB_KIND,
                                      self.namespace, self.job_name)
            if job is None:
                report["outcome"] = "deleted"
                break
            cond = k8s.get_condition(job, "Restarting")
            if cond is not None and cond.get("status") == "True" and \
                    cond.get("reason") not in report["restart_reasons"]:
                report["restart_reasons"].append(cond.get("reason"))
            if k8s.condition_true(job, "Succeeded"):
                report["outcome"] = "succeeded"
                break
            if k8s.condition_true(job, "Failed"):
                report["outcome"] = "failed"
                report["failed_reason"] = k8s.get_condition(
                    job, "Failed").get("reason")
                break
            pods = cluster.list("v1", "Pod", self.namespace)
            running = [p for p in pods
                       if p.get("status", {}).get("phase") == "Running"]
            if len(running) != gang or \
                    k8s.condition_true(job, "Restarting"):
                # gang down or mid-restart: let timers (restart backoff,
                # resync) fire and reconcile again
                time.sleep(0.03)
                continue
            target = min(pending[0].at_step, self.total_steps) if pending \
                else self.total_steps
            result = _train_segment(
                self, _chief_env(cluster, self.namespace, chief, report),
                target)
            report["segments"] += 1
            # steps this segment actually EXECUTED (its windows): the
            # soak's ground truth for restart-recompute — executed
            # minus final progress = steps replayed after restores,
            # which the goodput ledger must reproduce from spans alone
            report["executed_steps"] += int(result.steps)
            reached = max(reached, target)
            self._heartbeat(cluster, chief, reached)
            if pending and pending[0].at_step <= reached:
                fault = pending.pop(0)
                report["injected"].append({"step": reached,
                                           "kind": fault.kind})
                self._inject(fault, cluster, chaos, ckpt_dir, chief,
                             reached)
                continue
            if reached >= self.total_steps:
                # training done: the chief exits 0 and the operator
                # completes the job off the Succeeded phase
                cluster.set_pod_phase(self.namespace, chief, "Succeeded")
        job = cluster.get_or_none(_JOB_AV, _JOB_KIND,
                                  self.namespace, self.job_name)
        if job is not None:
            report["gang_restarts"] = int(k8s.annotations_of(job).get(
                RESTART_COUNT_ANNOTATION, "0"))
            from ..obs.trace import TRACE_ID_ANNOTATION
            report["trace_id"] = k8s.annotations_of(job).get(
                TRACE_ID_ANNOTATION, "")
        report["final_step"] = reached
        report["checkpoint_dir"] = ckpt_dir
        report["api_calls"] = chaos.calls
        report["api_faults"] = len(chaos.injected)
        for c in mgr.controllers:
            c.stop()
        return report


# ------------------------------------------------- numeric-fault injectors
# The sentinel tier's fault menu (runtime/sentinel.py NumericFaultHook):
# each injector renders the KFTPU_CHAOS_NUMERIC env contract the worker's
# hook consumes — the poison happens INSIDE the training loop (after the
# named step completes, so the damage surfaces in the NEXT window's
# metrics), not between segments like SoakFault.


@dataclass
class NaNInjector:
    """Multiply the params by NaN once step ``at_step`` completes — the
    hard-failure SDC: every downstream loss/grad is NaN, the sentinel's
    non-finite detector must trip within checkEverySteps."""

    at_step: int
    fires: int = 1
    node: Optional[str] = None
    kind = "nan"

    def spec(self) -> str:
        return f"nan:{self.at_step}"


@dataclass
class LossSpikePoisoner:
    """Scale the params by ``scale`` once ``at_step`` completes — a
    finite-but-wrong excursion only the rolling z-score detector sees
    (everything stays representable; nothing is NaN)."""

    at_step: int
    scale: float = 8.0
    fires: int = 1
    node: Optional[str] = None
    kind = "spike"

    def spec(self) -> str:
        return f"spike:{self.at_step}:{self.scale}"


@dataclass
class BitFlipGrad:
    """A silent bit-flip pinned to one host: a small multiplicative
    perturbation (exponent-bit flavor) fired ``fires`` times at the same
    step — the repeat-offender shape replay bisection exists for. The
    ``node`` pin names the host whose pod carries the evidence, so two
    trips fold two numeric-anomaly events onto it and its health score
    crosses the quarantine threshold."""

    at_step: int
    node: Optional[str] = None
    scale: float = 1.25
    fires: int = 2
    kind = "bitflip"

    def spec(self) -> str:
        return f"bitflip:{self.at_step}:{self.scale}"


@dataclass
class SentinelSoak:
    """Drive one TPUJob through a numeric-corruption episode, end to end:
    in-step detection → deliberate anomaly exit → operator LKG rollback
    (resumeFrom pinned to the last-known-good step, NOT the newest
    checkpoint) → clean re-run to completion; with a repeat-firing fault
    (BitFlipGrad), the second trip over the same LKG arms replay
    bisection and the third, clean segment publishes the verdict span.

    Same architecture as ChaosSoak (real control plane on FakeCluster,
    real in-process training segments using the env the operator rendered
    into the chief pod), with two twists: the fault fires INSIDE the
    worker via the KFTPU_CHAOS_NUMERIC hook (a fire-count marker file
    keeps it from re-firing forever across rollback segments), and on a
    trip the soak plays the pod's part — it annotates the victim pod with
    the evidence the real worker would have self-annotated and fails it,
    which is exactly what the operator's anomaly path watches for.

    ``corrupt_lkg=True`` additionally truncates the LKG step's payload at
    trip time: the rollback restore must then walk back to the
    next-oldest INTACT step (verify-then-fallback) and still converge.

    ``device``, ``train_kwargs`` and the topology fields as ChaosSoak's.
    """

    workdir: str
    fault: Optional[object] = None     # one numeric injector (None = clean)
    device: str = "cuda"
    train_kwargs: Optional[dict] = None
    topology: str = "h100-2"
    node_topology: Optional[str] = None
    total_steps: int = 10
    checkpoint_every: int = 2
    check_every: int = 1
    window_steps: int = 4
    spike_z: float = 4.0
    max_rollbacks: int = 3
    corrupt_lkg: bool = False
    seed: int = 0
    global_batch: int = 8
    wall_budget_s: float = 300.0
    namespace: str = "kubeflow"
    job_name: str = "sentinel-soak"

    def _manifest(self, ckpt_dir: str, span_path: str) -> dict:
        return {
            "apiVersion": _JOB_AV, "kind": _JOB_KIND,
            "metadata": {"name": self.job_name,
                         "namespace": self.namespace},
            "spec": {
                "checkpointDir": ckpt_dir,
                "observability": {"spanPath": span_path},
                "integrity": {"enabled": True,
                              "spikeZ": self.spike_z,
                              "windowSteps": self.window_steps,
                              "checkEverySteps": self.check_every},
                "replicaSpecs": {"GPU": {"gpuTopology": self.topology,
                                         "template": _TEMPLATE}},
                "runPolicy": {
                    "backoffLimit": 3,
                    "maxAnomalyRollbacks": self.max_rollbacks,
                    "restartBackoffSeconds": 0.02,
                    "restartBackoffMaxSeconds": 0.2,
                },
            },
        }

    # env the worker reads from os.environ (not train() kwargs): the
    # sentinel knobs the operator rendered into the pod, the rollback
    # directive, and the in-loop fault hook
    _PASS_ENV = ("KFTPU_INTEGRITY", "KFTPU_INTEGRITY_SPIKE_Z",
                 "KFTPU_INTEGRITY_WINDOW", "KFTPU_INTEGRITY_CHECK_EVERY",
                 "KFTPU_RESUME_STEP", "KFTPU_REPLAY_RANGE")

    def _run_segment(self, env_map: dict, target: int, mark_path: str):
        from ..runtime import sentinel as sent
        patched = {k: env_map.get(k) for k in self._PASS_ENV}
        if self.fault is not None:
            patched[sent.NUMERIC_FAULT_ENV] = self.fault.spec()
            patched[sent.NUMERIC_FAULT_MARK_ENV] = mark_path
            patched[sent.NUMERIC_FAULT_FIRES_ENV] = str(self.fault.fires)
        saved = {k: os.environ.get(k) for k in patched}
        for k, v in patched.items():
            if v:
                os.environ[k] = v
            else:
                os.environ.pop(k, None)
        try:
            return _train_segment(self, env_map, target)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def _heartbeat(self, cluster, chief: str, step: int) -> None:
        import json as _json
        from ..api.trainingjob import HEARTBEAT_ANNOTATION
        payload = _json.dumps({"step": step, "time": time.time()})
        cluster.patch("v1", "Pod", self.namespace, chief,
                      {"metadata": {"annotations":
                                    {HEARTBEAT_ANNOTATION: payload}}})

    def _victim(self, cluster, chief: str) -> str:
        """The pod that carries the evidence: the one on the fault's
        pinned node when there is a pin, else the chief."""
        node = getattr(self.fault, "node", None)
        if node:
            for p in cluster.list("v1", "Pod", self.namespace):
                if p.get("spec", {}).get("nodeName") == node:
                    return k8s.name_of(p)
        return chief

    def run(self) -> dict:
        import json as _json

        from ..controllers.tpujob import RESTART_COUNT_ANNOTATION
        from ..api.trainingjob import (ANOMALY_ANNOTATION,
                                       ANOMALY_COUNT_ANNOTATION)
        from ..scheduler import health

        ckpt_dir = os.path.join(self.workdir, "ckpt")
        span_path = os.path.join(self.workdir, "spans.jsonl")
        mark_path = os.path.join(self.workdir, "numeric-fault.mark")
        cluster, chaos, mgr = _soak_cluster(self)
        gang = _gang_size(self)
        cluster.create(self._manifest(ckpt_dir, span_path))

        report: dict = {"anomalies": [], "restart_reasons": [],
                        "segments": 0, "executed_steps": 0,
                        "outcome": "timeout", "lkg_corrupted": False}
        deadline = time.monotonic() + self.wall_budget_s
        chief = f"{self.job_name}-worker-0-0"
        reached = 0
        while time.monotonic() < deadline:
            mgr.run_pending()
            cluster.tick()
            mgr.run_pending()
            job = cluster.get_or_none(_JOB_AV, _JOB_KIND,
                                      self.namespace, self.job_name)
            if job is None:
                report["outcome"] = "deleted"
                break
            cond = k8s.get_condition(job, "Restarting")
            if cond is not None and cond.get("status") == "True" and \
                    cond.get("reason") not in report["restart_reasons"]:
                report["restart_reasons"].append(cond.get("reason"))
            if k8s.condition_true(job, "Succeeded"):
                report["outcome"] = "succeeded"
                break
            if k8s.condition_true(job, "Failed"):
                report["outcome"] = "failed"
                report["failed_reason"] = k8s.get_condition(
                    job, "Failed").get("reason")
                break
            pods = cluster.list("v1", "Pod", self.namespace)
            running = [p for p in pods
                       if p.get("status", {}).get("phase") == "Running"]
            if len(running) != gang or \
                    k8s.condition_true(job, "Restarting"):
                time.sleep(0.03)
                continue
            env_map = _chief_env(cluster, self.namespace, chief, report)
            result = self._run_segment(env_map, self.total_steps,
                                       mark_path)
            report["segments"] += 1
            report["executed_steps"] += int(result.steps)
            if result.anomaly:
                # play the failed pod's part: the in-process worker
                # can't self-annotate (no apiserver env), so the soak
                # attaches the evidence and fails the victim — the
                # operator's anomaly path takes it from here
                report["anomalies"].append(dict(result.anomaly))
                if self.corrupt_lkg and not report["lkg_corrupted"]:
                    lkg = result.anomaly.get("lkg")
                    step_dir = (os.path.join(ckpt_dir, str(int(lkg)))
                                if lkg else None)
                    if step_dir and os.path.isdir(step_dir):
                        truncate_checkpoint_payload(step_dir)
                        report["lkg_corrupted"] = True
                victim = self._victim(cluster, chief)
                cluster.patch(
                    "v1", "Pod", self.namespace, victim,
                    {"metadata": {"annotations": {
                        ANOMALY_ANNOTATION:
                            _json.dumps(result.anomaly)}}})
                cluster.fail_pod(self.namespace, victim,
                                 f"sentinel: {result.anomaly['kind']}")
                continue
            reached = self.total_steps
            self._heartbeat(cluster, chief, self.total_steps)
            if reached >= self.total_steps:
                cluster.set_pod_phase(self.namespace, chief, "Succeeded")
        job = cluster.get_or_none(_JOB_AV, _JOB_KIND,
                                  self.namespace, self.job_name)
        if job is not None:
            anns = k8s.annotations_of(job)
            report["gang_restarts"] = int(anns.get(
                RESTART_COUNT_ANNOTATION, "0"))
            report["rollbacks"] = int(anns.get(
                ANOMALY_COUNT_ANNOTATION, "0"))
            from ..obs.trace import TRACE_ID_ANNOTATION
            report["trace_id"] = anns.get(TRACE_ID_ANNOTATION, "")
        # bisection verdict: the worker's clean replay over the armed
        # range publishes an anomaly-bisection span — the evidence that
        # converts "this job is cursed" into a per-host verdict
        report["bisection"] = None
        try:
            with open(span_path, encoding="utf-8") as f:
                for line in f:
                    try:
                        span = _json.loads(line)
                    except ValueError:
                        continue
                    if span.get("name") == "anomaly-bisection":
                        report["bisection"] = span.get("attrs", span)
        except OSError:
            pass
        # hosts whose folded numeric-anomaly evidence crossed the
        # quarantine threshold (the scheduler's health sweep in
        # scheduler/core.py writes the actual quarantine annotation;
        # the score IS the criterion)
        cfg = health.HealthConfig()
        report["quarantined"] = sorted(
            k8s.name_of(n) for n in cluster.list("v1", "Node", "")
            if health.is_quarantined(n)
            or health.decayed_score(n) >= cfg.quarantine_threshold)
        report["final_step"] = reached
        report["checkpoint_dir"] = ckpt_dir
        report["span_path"] = span_path
        report["api_calls"] = chaos.calls
        report["api_faults"] = len(chaos.injected)
        for c in mgr.controllers:
            c.stop()
        return report


# ------------------------------------------------- serving-plane faults
# The serving fleet's fault menu: the failure classes one replica of a
# fleet WILL have, injectable against a real in-process ModelServer. The
# ChaosServable is a duck-typed servable (no device, host sleeps), so the
# whole ServingSoak runs without a card; a harness over a real servable
# (the LM on the card) takes the replica-crash fault.

SERVING_FAULT_KINDS = ("replica-crash", "wedge", "5xx-burst",
                       "cold-slow-start")


class ChaosServable:
    """Duck-typed servable with scriptable serving faults:

    - ``wedge()`` — accepts work, never answers (the hung-but-not-dead
      replica; only a client-side attempt timeout sees it) until
      ``unwedge()``;
    - ``fail_next(n, status)`` — the next n predicts raise with an
      ``http_status`` the server maps through (5xx burst);
    - ``slow_start(n, extra_s)`` — the next n predicts pay extra
      latency (a freshly-restarted cold replica warming its buckets);
    - ``tail_p``/``tail_s`` — seeded heavy-tail latency;
    - ``pause_every_s``/``pause_s``/``pause_phase_s`` — periodic
      whole-replica stalls (the GC-pause / compaction class the tail-
      at-scale hedging literature targets): a predict landing in a
      pause window waits it out, and its co-queued cohort piles up
      behind it. Replicas get offset phases, so a hedge to a DIFFERENT
      replica always finds one that is not pausing — the hedging A/B's
      workload.

    predict() echoes its instances after ``predict_s`` of host sleep —
    no numpy, no torch; the HTTP layer serializes whatever comes back.
    """

    def __init__(self, name: str = "chaos", predict_s: float = 0.004,
                 seed: int = 0, tail_p: float = 0.0,
                 tail_s: float = 0.0, pause_every_s: float = 0.0,
                 pause_s: float = 0.0, pause_phase_s: float = 0.0):
        self.name = name
        self.version = 1
        self.start_kind = "warm"
        self.predict_s = predict_s
        self.tail_p, self.tail_s = tail_p, tail_s
        self.pause_every_s = pause_every_s
        self.pause_s = pause_s
        self.pause_phase_s = pause_phase_s
        self._rng = random.Random(seed)
        self._proceed = threading.Event()
        self._proceed.set()
        self._lock = threading.Lock()
        self._fail_budget = 0
        self._fail_status = 500
        self._slow_left = 0
        self._slow_extra_s = 0.0
        self.predictions = 0

    # -------------------------------------------------------- fault knobs

    def wedge(self) -> None:
        """Accepts-never-responds: predicts block until unwedge()."""
        self._proceed.clear()

    def unwedge(self) -> None:
        self._proceed.set()

    @property
    def wedged(self) -> bool:
        return not self._proceed.is_set()

    def fail_next(self, n: int, status: int = 500) -> None:
        with self._lock:
            self._fail_budget += int(n)
            self._fail_status = int(status)

    def slow_start(self, n: int, extra_s: float) -> None:
        with self._lock:
            self._slow_left = int(n)
            self._slow_extra_s = float(extra_s)

    # ---------------------------------------------------- servable surface

    def predict(self, instances):
        self._proceed.wait()
        extra = 0.0
        with self._lock:
            if self._fail_budget > 0:
                self._fail_budget -= 1
                err = RuntimeError(
                    f"chaos: injected {self._fail_status}")
                err.http_status = self._fail_status
                raise err
            if self._slow_left > 0:
                self._slow_left -= 1
                extra += self._slow_extra_s
            if self.tail_p and self._rng.random() < self.tail_p:
                extra += self.tail_s
            self.predictions += 1
        if self.pause_every_s > 0:
            # a predict landing inside this replica's pause window
            # waits the pause out (and the queue behind it piles up)
            pos = (time.monotonic() + self.pause_phase_s) \
                % self.pause_every_s
            if pos < self.pause_s:
                extra += self.pause_s - pos
        time.sleep(self.predict_s + extra)
        return instances

    def metadata(self) -> dict:
        return {"model_spec": {"name": self.name},
                "stats": {"request_count": self.predictions,
                          "predict_seconds": 0.0}}

    def status(self) -> dict:
        return {"model_version_status": [
            {"version": self.version, "state": "AVAILABLE"}]}


class ServingReplicaHarness:
    """One in-process fleet member: a real ModelServer over a
    ChaosServable, or over ``servable`` when one is given (a real port
    servable, e.g. the LM on the card: only the replica-crash fault
    applies to it), restartable (the replacement-pod analog: same name,
    fresh server state, new port; a given servable is served again, its
    weights stay where they are)."""

    def __init__(self, name: str, span_path: Optional[str] = None,
                 model: str = "chaos", predict_s: float = 0.004,
                 seed: int = 0, tail_p: float = 0.0, tail_s: float = 0.0,
                 pause_every_s: float = 0.0, pause_s: float = 0.0,
                 pause_phase_s: float = 0.0,
                 max_batch: int = 8, max_latency_ms: float = 0.5,
                 servable=None):
        self.name = name
        self.span_path = span_path
        self._given = servable
        self.model = servable.name if servable is not None else model
        self._servable_kw = dict(name=model, predict_s=predict_s,
                                 seed=seed, tail_p=tail_p, tail_s=tail_s,
                                 pause_every_s=pause_every_s,
                                 pause_s=pause_s,
                                 pause_phase_s=pause_phase_s)
        self._server_kw = dict(max_batch=max_batch,
                               max_latency_ms=max_latency_ms)
        self.servable = None
        self.server = None
        self.url = ""

    def start(self) -> str:
        from ..serving.http_server import ModelServer
        self.servable = self._given if self._given is not None \
            else ChaosServable(**self._servable_kw)
        self.server = ModelServer(host="127.0.0.1", port=0,
                                  sample_every=0,
                                  span_path=self.span_path,
                                  **self._server_kw)
        self.server.repository.add(self.servable)
        port = self.server.start()
        self.url = f"http://127.0.0.1:{port}"
        return self.url

    def inject(self, kind: str, **kw) -> None:
        """The serving fault menu, by kind (SERVING_FAULT_KINDS)."""
        if kind not in SERVING_FAULT_KINDS:
            raise ValueError(f"unknown serving fault {kind!r} "
                             f"(choose from {SERVING_FAULT_KINDS})")
        if kind != "replica-crash" and \
                not isinstance(self.servable, ChaosServable):
            raise ValueError(f"serving fault {kind!r} needs a "
                             f"ChaosServable; {self.name} serves "
                             f"{type(self.servable).__name__}")
        if kind == "replica-crash":
            self.kill()
        elif kind == "wedge":
            self.servable.wedge()
        elif kind == "5xx-burst":
            self.servable.fail_next(kw.get("n", 10),
                                    kw.get("status", 500))
        else:   # cold-slow-start
            self.servable.slow_start(kw.get("n", 20),
                                     kw.get("extra_s", 0.03))
        log.info("chaos: serving fault %s on %s", kind, self.name)

    def kill(self) -> None:
        """SIGKILL-class crash: listener + live connections die,
        in-flight clients see a reset, nothing drains."""
        if self.server is not None:
            self.server.kill()

    def drain(self, timeout_s: float = 5.0) -> dict:
        return self.server.drain(timeout_s=timeout_s)

    def restart(self, slow_start_n: int = 0,
                slow_start_extra_s: float = 0.0) -> str:
        """The replacement pod: fresh server, same identity. A nonzero
        ``slow_start_n`` makes it a cold replica (the fourth fault
        kind) — its first n predicts pay ``slow_start_extra_s``."""
        self.stop()
        url = self.start()
        if slow_start_n and isinstance(self.servable, ChaosServable):
            self.servable.slow_start(slow_start_n, slow_start_extra_s)
        return url

    def stop(self) -> None:
        if self.server is not None:
            if isinstance(self.servable, ChaosServable):
                self.servable.unwedge()  # free any stuck batcher thread
            try:
                self.server.stop()
            except Exception:  # noqa: BLE001 — a killed server may throw
                pass
            self.server = None


@dataclass
class ServingSoak:
    """The kill-one-of-N availability soak: a real in-process N-replica
    fleet (ModelServers over ChaosServables, or over the ``servables``
    given, one per replica) behind a FleetRouter, driven by a
    closed-loop multi-threaded client while scripted serving faults
    land. Four scenarios:

    - **kill**: SIGKILL one replica mid-load (plus, over
      ChaosServables, a 5xx burst on a survivor and the victim's
      cold-slow-start restart — breaker probation re-admits it);
      asserts client success and zero duplicate deliveries.
    - **drain**: gracefully drain one replica mid-load; zero in-flight
      requests lost.
    - **wedge**: one replica accepts-and-never-responds; its breaker
      must eject it and, after recovery, probationally re-admit it.
    - **hedge A/B**: heavy-tail latency, hedging off vs on — the p99.9
      cut, and hedge_waste as the honest price.

    The wedge and hedge scenarios need ChaosServables. Requests carry
    ``bodies`` in turn (default: one 3-float instance); the first
    ``keep_responses`` answers of a load run come back in its report
    under ``samples`` as ``(body index, response)``. Every router span
    lands in ``span_path``; ``audit()`` re-reads the sink and checks the
    fleet ledgers sum to wall-clock (≤2% residual) with retries/hedges
    attributed, and that no request id was ever answered twice.
    """

    span_path: str = ""
    replicas: int = 3
    model: str = "chaos"
    predict_s: float = 0.004
    seconds: float = 3.0
    threads: int = 6
    seed: int = 0
    attempt_timeout_s: float = 0.5
    max_retries: int = 3
    hedge_requests: int = 240
    # the hedge A/B's heavy tail: per-replica periodic pauses (GC /
    # compaction class), phases offset so no two replicas pause at once
    pause_every_s: float = 1.2
    pause_s: float = 0.08
    hedge_delay_ms: float = 15.0
    servables: Optional[list] = None
    bodies: Optional[list] = None
    keep_responses: int = 0

    def __post_init__(self):
        if self.servables:
            if len(self.servables) != self.replicas:
                raise ValueError(f"{len(self.servables)} servables for "
                                 f"{self.replicas} replicas")
            self.model = self.servables[0].name

    # ------------------------------------------------------------ plumbing

    def _bodies(self) -> list:
        return self.bodies or [b'{"instances": [[1.0, 2.0, 3.0]]}']

    def _harnesses(self, prefix: str, **kw) -> list:
        out = []
        for i in range(self.replicas):
            h = ServingReplicaHarness(
                f"{prefix}{i}", span_path=self.span_path,
                model=self.model, predict_s=self.predict_s,
                seed=self.seed * 1000 + i,
                servable=self.servables[i] if self.servables else None,
                **kw)
            h.start()
            out.append(h)
        return out

    def _router(self, harnesses, hedge: bool = False):
        from ..serving.fleet import (BreakerConfig, FleetConfig,
                                     FleetRouter)
        cfg = FleetConfig(
            max_retries=self.max_retries, backoff_s=0.01,
            default_deadline_s=max(5.0, 6 * self.attempt_timeout_s),
            attempt_timeout_s=self.attempt_timeout_s,
            poll_interval_s=0.1, poll_timeout_s=1.0,
            hedge=hedge, hedge_delay_ms=self.hedge_delay_ms)
        bcfg = BreakerConfig(half_life_s=2.0, trip_threshold=2.0,
                             release_threshold=1.0, open_s=0.5,
                             open_max_s=5.0, probe_successes=2)
        router = FleetRouter(
            replicas={h.name: h.url for h in harnesses},
            config=cfg, breaker_config=bcfg,
            span_path=self.span_path,
            rng=random.Random(self.seed))
        router.poll_once()
        router.start_polling()
        return router

    def _load(self, router, prefix: str, seconds: float,
              faults: Optional[list] = None) -> dict:
        """Closed-loop load from ``threads`` workers for ``seconds``;
        ``faults`` is [(at_frac, fn)] fired once by the driver thread.
        Returns the outcome counts (and the kept samples)."""
        bodies = self._bodies()
        samples: list = []
        results: dict = {}
        res_lock = threading.Lock()
        counter = iter(range(10 ** 9))
        count_lock = threading.Lock()
        stop_at = time.monotonic() + seconds

        def worker():
            while time.monotonic() < stop_at:
                with count_lock:
                    n = next(counter)
                rid = f"{prefix}{n:05d}"
                try:
                    out = router.request(self.model,
                                         bodies[n % len(bodies)],
                                         request_id=rid)
                    ok, err = True, ""
                except Exception as e:  # noqa: BLE001 — the soak counts
                    ok, err = False, f"{type(e).__name__}: {e}"
                with res_lock:
                    results[rid] = (ok, err)
                    if ok and len(samples) < self.keep_responses:
                        samples.append((n % len(bodies), out))

        workers = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.threads)]
        t0 = time.monotonic()
        for w in workers:
            w.start()
        pending = sorted(faults or [], key=lambda f: f[0])
        while pending and time.monotonic() < stop_at:
            frac = (time.monotonic() - t0) / max(seconds, 1e-9)
            if frac >= pending[0][0]:
                _, fn = pending.pop(0)
                fn()
            else:
                time.sleep(0.01)
        for w in workers:
            w.join(timeout=seconds + 10)
        ok = sum(1 for o, _ in results.values() if o)
        errs = sorted({e for o, e in results.values() if not o})
        return {"requests": len(results), "ok": ok,
                "success_pct": round(100.0 * ok / len(results), 3)
                if results else 0.0,
                "errors": errs[:5], "samples": samples}

    # ----------------------------------------------------------- scenarios

    def run_kill(self) -> dict:
        """SIGKILL one of N mid-load; a survivor takes a 5xx burst (over
        ChaosServables); the victim restarts (cold, over ChaosServables)
        and earns probational re-admission."""
        harnesses = self._harnesses("kill-r")
        router = self._router(harnesses)
        victim, bursty = harnesses[0], harnesses[-1]

        def crash():
            victim.inject("replica-crash")

        def burst():
            bursty.inject("5xx-burst", n=8, status=500)

        def resurrect():
            url = victim.restart(slow_start_n=10,
                                 slow_start_extra_s=0.02)
            router.set_replica_url(victim.name, url)

        faults = [(0.25, crash), (0.6, resurrect)]
        if isinstance(bursty.servable, ChaosServable):
            faults.append((0.45, burst))
        try:
            report = self._load(router, "kill-", self.seconds,
                                faults=faults)
            # the resurrected victim must be earning its way back:
            # half-open probes → closed (probation served)
            deadline = time.monotonic() + 10.0
            state = ""
            while time.monotonic() < deadline:
                state = router.replica(victim.name).breaker.state()
                if state == "closed":
                    break
                try:
                    router.request(self.model, self._bodies()[0])
                except Exception:  # noqa: BLE001
                    pass
                time.sleep(0.05)
            report["victim_readmitted"] = state == "closed"
            report["victim_breaker"] = \
                router.replica(victim.name).breaker.to_dict()
            report["fleet"] = router.snapshot()
            return report
        finally:
            router.close()
            for h in harnesses:
                h.stop()

    def run_drain(self) -> dict:
        """Gracefully drain one replica mid-load: readiness flips, the
        router routes away, in-flight work finishes — zero loss."""
        harnesses = self._harnesses("drain-r")
        router = self._router(harnesses)
        drained = harnesses[1]
        drain_report: dict = {}

        def drain():
            drain_report.update(drained.drain(timeout_s=5.0))

        try:
            report = self._load(router, "drain-", self.seconds,
                                faults=[(0.4, drain)])
            router.poll_once()
            rep = router.replica(drained.name)
            report["drain"] = drain_report
            report["router_saw_draining"] = bool(rep and rep.draining)
            report["in_flight_lost"] = \
                int(drain_report.get("inFlightRemaining", -1))
            return report
        finally:
            router.close()
            for h in harnesses:
                h.stop()

    def run_wedge(self) -> dict:
        """One replica wedges (accepts, never responds): its breaker
        must eject it; after recovery it is probationally re-admitted."""
        harnesses = self._harnesses("wedge-r")
        router = self._router(harnesses)
        victim = harnesses[-1]
        events: dict = {}

        def wedge():
            victim.inject("wedge")

        def spot_ejection():
            events["ejected_during_load"] = \
                router.replica(victim.name).breaker.state() == "open"

        def recover():
            victim.servable.unwedge()

        try:
            report = self._load(
                router, "wedge-", self.seconds,
                faults=[(0.15, wedge), (0.55, spot_ejection),
                        (0.6, recover)])
            report.update(events)
            # keep trickling until probation completes
            deadline = time.monotonic() + 10.0
            state = ""
            while time.monotonic() < deadline:
                state = router.replica(victim.name).breaker.state()
                if state == "closed":
                    break
                try:
                    router.request(self.model, self._bodies()[0])
                except Exception:  # noqa: BLE001
                    pass
                time.sleep(0.05)
            report["ejected"] = bool(events.get("ejected_during_load")
                                     or router.replica(
                                         victim.name).breaker.trips)
            report["readmitted"] = state == "closed"
            report["victim_breaker"] = \
                router.replica(victim.name).breaker.to_dict()
            return report
        finally:
            router.close()
            for h in harnesses:
                h.stop()

    def run_hedge_ab(self) -> dict:
        """Heavy-tail latency, hedging off vs on: the tail (p99.9) must
        come down, and the duplicated work must land as hedge_waste —
        the honest price, never silent. The tail comes from per-replica
        periodic pauses with offset phases (no two replicas pause
        together), so a hedge to a different replica always finds a
        live one — the exact failure shape tail hedging exists for."""
        body = self._bodies()[0]
        arms = {}
        phase_step = self.pause_every_s / max(1, self.replicas)
        for arm, hedge in (("off", False), ("on", True)):
            harnesses = []
            for i in range(self.replicas):
                h = ServingReplicaHarness(
                    f"hedge{arm}-r{i}", span_path=self.span_path,
                    model=self.model, predict_s=self.predict_s,
                    seed=self.seed * 1000 + i,
                    pause_every_s=self.pause_every_s,
                    pause_s=self.pause_s,
                    pause_phase_s=i * phase_step)
                h.start()
                harnesses.append(h)
            router = self._router(harnesses, hedge=hedge)
            lats: list = []
            lat_lock = threading.Lock()
            counter = iter(range(10 ** 9))
            count_lock = threading.Lock()
            per_thread = max(1, self.hedge_requests // self.threads)

            def worker():
                for _ in range(per_thread):
                    with count_lock:
                        rid = f"hedge{arm}-{next(counter):05d}"
                    t0 = time.monotonic()
                    try:
                        router.request(self.model, body,
                                       request_id=rid)
                        with lat_lock:
                            lats.append(time.monotonic() - t0)
                    except Exception:  # noqa: BLE001
                        pass

            try:
                workers = [threading.Thread(target=worker,
                                             daemon=True)
                           for _ in range(self.threads)]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join(timeout=120)
            finally:
                router.close()
                for h in harnesses:
                    h.stop()
            lats.sort()

            def pct(q):
                return lats[min(len(lats) - 1, int(len(lats) * q))] \
                    if lats else 0.0

            arms[arm] = {
                "requests": len(lats),
                "p50_ms": round(pct(0.50) * 1e3, 2),
                "p99_ms": round(pct(0.99) * 1e3, 2),
                "p999_ms": round(pct(0.999) * 1e3, 2),
            }
        off, on = arms["off"], arms["on"]
        return {
            "off": off, "on": on,
            "p999_cut_pct": round(
                100.0 * (off["p999_ms"] - on["p999_ms"]) /
                off["p999_ms"], 1) if off["p999_ms"] else 0.0,
            "hedging_cuts_p999": on["p999_ms"] < off["p999_ms"],
        }

    # -------------------------------------------------------------- audit

    def audit(self) -> dict:
        """Re-read the span sink: (1) every fleet ledger's wall
        partition holds (upstream + retry + other ≈ wall, ≤2%
        residual) with retries/hedges as NAMED badput; (2) zero
        duplicate side effects — per request id, at most ONE server
        replica completed it ok, audited on the kill- and drain-
        scenario ids where at-most-once matters (a crashed attempt
        must read error, its failover ok). Hedge ids duplicate
        server-side BY DESIGN (that is hedge_waste); wedge ids may
        late-complete into a closed connection — both excluded, and
        the exclusion stated here rather than hidden."""
        from ..obs import goodput as gp
        from ..obs.trace import load_spans
        spans = load_spans(self.span_path)
        fleet = [s for s in spans
                 if s.get("name") == gp.FLEET_REQUEST_SPAN]
        sum_ok = 0
        wall_s = other_s = hedge_waste_s = retry_s = 0.0
        worst_resid = 0.0
        for s in fleet:
            ledger = (s.get("attrs") or {}).get("ledger") or {}
            if gp.fleet_sum_ok(ledger):
                sum_ok += 1
            wall = float(ledger.get("wallSeconds", 0.0))
            bad = ledger.get("badputSeconds") or {}
            wall_s += wall
            other_s += float(bad.get(gp.BADPUT_OTHER, 0.0))
            hedge_waste_s += float(bad.get(gp.SERVING_HEDGE_WASTE, 0.0))
            retry_s += float(bad.get(gp.SERVING_RETRY, 0.0))
            if wall:
                total = float(ledger.get("upstreamSeconds", 0.0)) + \
                    float(bad.get(gp.SERVING_RETRY, 0.0)) + \
                    float(bad.get(gp.BADPUT_OTHER, 0.0))
                worst_resid = max(worst_resid,
                                  abs(total - wall) / wall)
        # server-side at-most-once for the kill/drain ids: a crashed
        # or drained-away attempt's server span must not read ok
        # alongside its failover's
        audited_prefixes = ("kill-", "drain-")
        served: dict = {}
        audited = 0
        for s in spans:
            if s.get("name") != gp.SERVING_REQUEST_SPAN:
                continue
            rid = str(s.get("trace_id", ""))
            if not rid.startswith(audited_prefixes):
                continue
            audited += 1
            if (s.get("attrs") or {}).get("outcome") == "ok":
                served[rid] = served.get(rid, 0) + 1
        dup_served = sum(1 for c in served.values() if c > 1)
        return {
            "fleet_requests": len(fleet),
            "ledger_sum_ok": bool(fleet) and sum_ok == len(fleet),
            "other_residual_pct": round(
                100.0 * other_s / wall_s, 3) if wall_s else 0.0,
            "worst_request_residual_pct": round(
                100.0 * worst_resid, 3),
            "retry_badput_s": round(retry_s, 4),
            "hedge_waste_s": round(hedge_waste_s, 4),
            "audited_server_completions": audited,
            "duplicate_side_effects": dup_served,
            "duplicate_audit_scope": list(audited_prefixes),
        }

    def run(self) -> dict:
        report = {"kill": self.run_kill(),
                  "drain": self.run_drain(),
                  "wedge": self.run_wedge(),
                  "hedge_ab": self.run_hedge_ab()}
        report["audit"] = self.audit()
        return report
