"""Scheduler soaks: preemption, elastic resize and node health — and the
control-plane soak (``ControlPlaneSoak`` and the split-brain drill),
which kills the controllers themselves.

The port's counterparts of ``PreemptionSoak``, ``ElasticSoak``,
``HealthSoak``, ``ControlPlaneSoak`` and ``split_brain_drill`` of
``kubeflow_tpu/scheduler/soak.py``: the chaos-soak pattern
(cluster/chaos.py) applied to the slice scheduler and its operator. The control
plane is real (``FakeCluster`` of ``h100-8`` nodes, ``SliceScheduler``
and the training-job reconciler); the data plane is real too — each time
a gang is fully Running, a training segment (the port's
``runtime.worker.train`` on the soak's ``device``, the tiny LM unless
``train_kwargs`` names another) runs in-process with the env the operator
rendered into the chief pod (cluster/chaos.py ``_train_segment``).

As in the operator soaks, the chief trains in process at world 1 in every
shape, and the gang's other pods never run. So every soak's numeric bar
is its final params against an uncontended clean run of the same seed:
the scheduler's paths must cost progress, never correctness. (The JAX
``ElasticSoak`` also restores its sharded state across replica degrees;
on the port that restore is ``tests/test_torch_elastic.py``'s.)

Every poll, sleep and deadline goes through this module's ``time``.
Stdlib only at import time (the worker is imported inside a segment).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

from ..api import k8s
from ..api.trainingjob import (BINDING_ANNOTATION, COND_QUEUED,
                               PREEMPTED_COUNT_ANNOTATION,
                               RESIZE_HISTORY_ANNOTATION)
from ..cluster.chaos import _chief_env, _train_segment, final_params

POOL_TOPOLOGY = "h100-8"
NAMESPACE = "kubeflow"
WALL_BUDGET_S = 300.0        # a soak's whole run on the module's clock
_JOB_AV, _JOB_KIND = "tpu.kubeflow.org/v1alpha1", "TPUJob"
_TEMPLATE = {"spec": {"containers": [{"name": "trainer",
                                      "image": "trainer:v1"}]}}


def _manifest(name: str, namespace: str, ckpt_dir: str, policy: dict,
              run_policy: Optional[dict] = None,
              topology: str = POOL_TOPOLOGY) -> dict:
    spec = {"checkpointDir": ckpt_dir,
            "schedulingPolicy": policy,
            "replicaSpecs": {"GPU": {"gpuTopology": topology,
                                     "template": _TEMPLATE}}}
    if run_policy:
        spec["runPolicy"] = run_policy
    return {"apiVersion": _JOB_AV, "kind": _JOB_KIND,
            "metadata": {"name": name, "namespace": namespace},
            "spec": spec}


def _running(cluster, namespace: str, job: str) -> list[dict]:
    pods = cluster.list("v1", "Pod", namespace,
                        selector={"kubeflow.org/job-name": job})
    return [p for p in pods
            if p.get("status", {}).get("phase") == "Running"]


def _control_plane(cluster, config=None):
    """A Manager with the slice scheduler and the training-job
    reconciler over ``cluster``."""
    from ..controllers.runtime import Manager
    from ..controllers.tpujob import TrainingJobReconciler
    from .core import SliceScheduler
    mgr = Manager(cluster)
    mgr.add(SliceScheduler(config))
    mgr.add(TrainingJobReconciler(_JOB_KIND))
    return mgr


def _pump(mgr, cluster, ticks: int = 3) -> None:
    for _ in range(ticks):
        mgr.run_pending()
        cluster.tick()
    mgr.run_pending()


def _finish(report: dict, mgr) -> dict:
    for c in mgr.controllers:
        c.stop()
    return report


class _Segments:
    """The segment plumbing every scheduler soak shares: the chief pod's
    env, one training segment, the newest intact step and the clean
    run."""

    # the tiny LM's seed and batch (cluster/chaos.py _train_segment reads
    # them; ``train_kwargs`` may override both)
    seed = 0
    global_batch = 8

    def _chief_env(self, cluster, chief: str, report: dict) -> dict:
        return _chief_env(cluster, NAMESPACE, chief, report)

    def _run_segment(self, env_map: dict, target: int):
        return _train_segment(self, env_map, target)

    @staticmethod
    def _latest_step(ckpt_dir: str):
        from ..runtime.checkpoint import CheckpointManager
        mgr = CheckpointManager(ckpt_dir)
        try:
            return mgr.latest_step()
        finally:
            mgr.close()

    def clean_params(self) -> dict:
        """The parity reference: the job's workload run start to finish
        with the same seed and no contention, its final params on the
        soak's device."""
        env_map = {"KFTPU_CHECKPOINT_DIR":
                   os.path.join(self.workdir, "clean")}
        self._run_segment(env_map, self.total_steps)
        return final_params(env_map["KFTPU_CHECKPOINT_DIR"],
                            device=self.device)


@dataclass
class PreemptionSoak(_Segments):
    """Two jobs contending for one ``h100-8`` node; the scripted outcome
    is victim-preempted → winner-runs → victim-resumes, all through the
    real scheduler/operator loop."""

    workdir: str
    device: str = "cuda"
    train_kwargs: Optional[dict] = None
    total_steps: int = 8
    checkpoint_every: int = 2
    preempt_at: int = 4          # victim's progress when the winner lands

    def _manifest(self, name: str, ckpt_dir: str, priority: int,
                  preemptible: bool) -> dict:
        return _manifest(name, NAMESPACE, ckpt_dir,
                         {"queue": "research", "priority": priority,
                          "preemptible": preemptible},
                         {"backoffLimit": 3})

    def _gang_running(self, cluster, name: str) -> bool:
        return len(_running(cluster, NAMESPACE, name)) == 8

    def run(self) -> dict:
        from ..cluster.fake import FakeCluster

        # preempt_at on a checkpoint boundary mirrors the real reclaim:
        # SIGTERM forces a save before exit 75, so the victim's on-disk
        # state is exactly its progress at preemption
        if self.preempt_at % self.checkpoint_every:
            raise ValueError("preempt_at must land on a checkpoint boundary")
        ckpt_victim = os.path.join(self.workdir, "victim")
        ckpt_winner = os.path.join(self.workdir, "winner")
        cluster = FakeCluster()
        cluster.add_gpu_nodes(POOL_TOPOLOGY)
        mgr = _control_plane(cluster)
        report: dict = {"events": [], "outcome": "timeout",
                        "checkpoint_dir": ckpt_victim}

        def job(name: str) -> dict:
            return cluster.get(_JOB_AV, _JOB_KIND, NAMESPACE, name)

        cluster.create(self._manifest("victim", ckpt_victim,
                                      priority=0, preemptible=True))
        deadline = time.monotonic() + WALL_BUDGET_S
        _pump(mgr, cluster)
        if not self._gang_running(cluster, "victim"):
            report["outcome"] = "victim-never-bound"
            return _finish(report, mgr)

        # victim trains to the preemption point
        seg = self._run_segment(
            self._chief_env(cluster, "victim-worker-0-0", report),
            self.preempt_at)
        report["victim_executed_steps"] = int(seg.steps)
        report["events"].append(f"victim reached step {self.preempt_at}")

        # the winner lands: higher priority, the same whole-node shape
        cluster.create(self._manifest("winner", ckpt_winner,
                                      priority=10, preemptible=False))
        while time.monotonic() < deadline:
            _pump(mgr, cluster)
            v = job("victim")
            if not k8s.annotations_of(v).get(BINDING_ANNOTATION) and \
                    k8s.condition_true(v, COND_QUEUED) and \
                    self._gang_running(cluster, "winner"):
                break
            time.sleep(0.02)
        else:
            report["outcome"] = "preemption-never-happened"
            return _finish(report, mgr)
        v = job("victim")
        report["victim_preempted_count"] = int(k8s.annotations_of(v).get(
            PREEMPTED_COUNT_ANNOTATION, "0"))
        report["victim_resume_from"] = v["spec"].get("resumeFrom", "")
        report["events"].append("victim preempted, winner running")

        # winner trains to completion and succeeds
        self._run_segment(
            self._chief_env(cluster, "winner-worker-0-0", report),
            self.total_steps)
        cluster.set_pod_phase(NAMESPACE, "winner-worker-0-0",
                              "Succeeded")
        # winner done -> its binding releases -> victim re-binds
        while time.monotonic() < deadline:
            _pump(mgr, cluster)
            if k8s.condition_true(job("winner"), "Succeeded") and \
                    self._gang_running(cluster, "victim"):
                break
            time.sleep(0.02)
        else:
            report["outcome"] = "victim-never-rebound"
            return _finish(report, mgr)
        report["events"].append("winner succeeded, victim re-bound")

        # victim resumes from its own checkpoints and completes; the
        # resume step is whatever survived on disk — it must be the save
        # at preemption, not step 0
        env_map = self._chief_env(cluster, "victim-worker-0-0", report)
        report["victim_rebind_resume_env"] = env_map.get(
            "KFTPU_RESUME_FROM", "")
        report["victim_resume_step"] = self._latest_step(ckpt_victim)
        seg = self._run_segment(env_map, self.total_steps)
        report["victim_executed_steps"] += int(seg.steps)
        cluster.set_pod_phase(NAMESPACE, "victim-worker-0-0",
                              "Succeeded")
        while time.monotonic() < deadline:
            _pump(mgr, cluster)
            if k8s.condition_true(job("victim"), "Succeeded"):
                report["outcome"] = "succeeded"
                break
            time.sleep(0.02)
        report["victim_manifest"] = job("victim")
        return _finish(report, mgr)


@dataclass
class ElasticSoak(_Segments):
    """Shrink-to-survive → grow-to-fill, end to end on the real loop.

    One ELASTIC job (``schedulingPolicy.minChips=4, maxChips=8``) trains
    on one ``h100-8`` node. After ``lose_at`` steps the node's device
    plugin loses half of its GPUs (cluster/chaos.py ``CapacityLoss``):
    the gang's pods on them fail, no 8-GPU run exists anywhere, and the
    replan binds the job DEGRADED at ``h100-4`` on the surviving GPUs;
    the operator restarts the gang at the smaller shape with
    ``resumeFrom``. Once the job reaches ``restore_at`` the GPUs return
    and grow-to-fill resizes the binding back to ``h100-8``; the job
    finishes at full width."""

    workdir: str
    device: str = "cuda"
    train_kwargs: Optional[dict] = None
    total_steps: int = 8
    checkpoint_every: int = 2
    lose_at: int = 3             # GPUs drop off after this many steps
    restore_at: int = 5          # ...and return once the job reaches this

    JOB_NAME = "elastic-soak"
    POOL = "pool-a"

    def _manifest(self, ckpt_dir: str) -> dict:
        return _manifest(
            self.JOB_NAME, NAMESPACE, ckpt_dir,
            {"queue": "research", "priority": 0, "minChips": 4,
             "maxChips": 8},
            {"backoffLimit": 6, "restartBackoffSeconds": 0.05,
             "restartBackoffMaxSeconds": 0.2})

    def _gang_running(self, cluster, want: int) -> bool:
        return len(_running(cluster, NAMESPACE,
                            self.JOB_NAME)) == want

    def run(self) -> dict:
        from ..cluster.chaos import CapacityLoss
        from ..cluster.fake import FakeCluster
        from .queue import SchedulerConfig, binding_of

        ckpt_dir = os.path.join(self.workdir, "job")
        cluster = FakeCluster()
        (node,) = cluster.add_gpu_nodes(POOL_TOPOLOGY, pool=self.POOL)
        fault = CapacityLoss(node=k8s.name_of(node), keep=4)
        # no grow cooldown: the soak compresses hours into seconds
        mgr = _control_plane(cluster,
                             SchedulerConfig(grow_cooldown_s=0.0))
        cluster.create(self._manifest(ckpt_dir))

        chief = f"{self.JOB_NAME}-worker-0-0"
        report: dict = {"outcome": "timeout", "events": [],
                        "chips_seen": [], "checkpoint_dir": ckpt_dir}
        deadline = time.monotonic() + WALL_BUDGET_S

        def job() -> dict:
            return cluster.get(_JOB_AV, _JOB_KIND, NAMESPACE,
                               self.JOB_NAME)

        def note_chips() -> int:
            placement = binding_of(job())
            chips = placement.chips if placement else 0
            if chips and (not report["chips_seen"]
                          or report["chips_seen"][-1] != chips):
                report["chips_seen"].append(chips)
            return chips

        def wait_for(pods: int, chips: int, tag: str) -> bool:
            while time.monotonic() < deadline:
                _pump(mgr, cluster)
                if note_chips() == chips and \
                        self._gang_running(cluster, pods):
                    return True
                time.sleep(0.02)
            report["outcome"] = f"timeout: {tag}"
            return False

        # phase 1: bind + train at nominal width until the GPUs drop off
        if not wait_for(8, 8, "never bound at nominal"):
            return _finish(report, mgr)
        report["events"].append("bound at 8 GPUs (1 node)")
        self._run_segment(self._chief_env(cluster, chief, report),
                          self.lose_at)
        report["events"].append(f"trained to step {self.lose_at} @8")

        # phase 2: half the node's GPUs gone -> shrink-to-survive
        fault.fire(cluster, NAMESPACE)
        if not wait_for(4, 4, "never shrank after capacity loss"):
            return _finish(report, mgr)
        report["events"].append("GPUs lost; re-bound DEGRADED at 4 GPUs")
        report["shrink_resume_step"] = self._latest_step(ckpt_dir)
        self._run_segment(self._chief_env(cluster, chief, report),
                          self.restore_at)
        report["events"].append(
            f"trained degraded to step {self.restore_at} @4")

        # phase 3: the GPUs return -> grow-to-fill back to h100-8
        fault.restore(cluster)
        if not wait_for(8, 8, "never grew after capacity returned"):
            return _finish(report, mgr)
        report["events"].append("capacity back; grown to 8 GPUs")
        report["grow_resume_step"] = self._latest_step(ckpt_dir)
        self._run_segment(self._chief_env(cluster, chief, report),
                          self.total_steps)
        cluster.set_pod_phase(NAMESPACE, chief, "Succeeded")
        while time.monotonic() < deadline:
            _pump(mgr, cluster)
            if k8s.condition_true(job(), "Succeeded"):
                report["outcome"] = "succeeded"
                break
            time.sleep(0.02)
        report["resize_history"] = k8s.annotations_of(job()).get(
            RESIZE_HISTORY_ANNOTATION, "")
        return _finish(report, mgr)


@dataclass
class HealthSoak(_Segments):
    """Flaky-node migration drill: quarantine on vs off, end to end.

    One scheduler-managed job trains on a two-pool cluster (one
    ``h100-8`` node a pool) whose first pool's node is FLAKY
    (cluster/chaos.py ``HostFault``): every time a gang pod runs on it,
    one dies. With ``quarantine=True`` the first crash records the
    suspect and folds a crash into the node's score past the (drill's)
    threshold; the scheduler quarantines the node, evacuates the binding
    within ONE rebind, and the gang finishes on the clean pool. With
    ``quarantine=False`` recovery is placement-blind — the gang
    crash-loops on the flaky node until the fault's trips budget runs
    out, burning a restart per trip. Both arms finish Succeeded with the
    clean run's params: the health path changes WHERE the gang runs,
    never what it computes.

    The fault fires on a step schedule (after steps 3, 4, 5 — off the
    checkpoint boundaries), so the off arm pays real replay."""

    workdir: str
    device: str = "cuda"
    train_kwargs: Optional[dict] = None
    quarantine: bool = True
    total_steps: int = 6
    checkpoint_every: int = 2

    JOB_NAME = "health-soak"
    FLAKY_TRIPS = 3
    FLAKY_POOL = "pool-a"
    CLEAN_POOL = "pool-b"

    def _manifest(self, ckpt_dir: str) -> dict:
        return _manifest(
            self.JOB_NAME, NAMESPACE, ckpt_dir,
            {"queue": "research", "priority": 0, "preemptible": False},
            {"backoffLimit": self.FLAKY_TRIPS + 3,
             # a small backoff so the scheduler's evacuation pass wins
             # the race against the operator's recreate
             "restartBackoffSeconds": 0.05,
             "restartBackoffMaxSeconds": 0.2})

    def _gang_running(self, cluster) -> list[dict]:
        running = _running(cluster, NAMESPACE, self.JOB_NAME)
        return running if len(running) == 8 else []

    def run(self) -> dict:
        from ..cluster.chaos import HostFault
        from ..cluster.fake import FakeCluster
        from ..controllers.tpujob import RESTART_COUNT_ANNOTATION
        from .health import HealthConfig, is_quarantined
        from .queue import SchedulerConfig, binding_of

        ckpt_dir = os.path.join(self.workdir, "job")
        cluster = FakeCluster()
        (flaky,) = cluster.add_gpu_nodes(POOL_TOPOLOGY,
                                         pool=self.FLAKY_POOL)
        cluster.add_gpu_nodes(POOL_TOPOLOGY, pool=self.CLEAN_POOL)
        flaky_node = k8s.name_of(flaky)
        fault = HostFault(node=flaky_node, trips=self.FLAKY_TRIPS)
        config = SchedulerConfig(health=HealthConfig(
            enabled=self.quarantine,
            # one crash (weight 1.0) is enough evidence in the drill;
            # 0.9 leaves room for the decay between fold and pass
            quarantine_threshold=0.9, release_threshold=0.5,
            quarantine_s=300.0))
        mgr = _control_plane(cluster, config)
        cluster.create(self._manifest(ckpt_dir))

        # fault schedule: fire once the job has banked these steps (off
        # the checkpoint_every=2 boundaries -> real replay in the off
        # arm); trips beyond the schedule fire immediately on recreate
        fault_steps = [3, 4, 5][:self.FLAKY_TRIPS]
        chief = f"{self.JOB_NAME}-worker-0-0"
        report: dict = {"outcome": "timeout", "restarts": 0,
                        "fires": 0, "rebinds": 0, "pools": [],
                        "executed_steps": 0, "checkpoint_dir": ckpt_dir,
                        "quarantine": self.quarantine}
        deadline = time.monotonic() + WALL_BUDGET_S
        first_fire_t = None
        recovered_t = None
        reached = 0
        last_pools = None
        while time.monotonic() < deadline:
            mgr.run_pending()
            cluster.tick()
            mgr.run_pending()
            job = cluster.get(_JOB_AV, _JOB_KIND, NAMESPACE,
                              self.JOB_NAME)
            report["restarts"] = int(k8s.annotations_of(job).get(
                RESTART_COUNT_ANNOTATION, "0"))
            placement = binding_of(job)
            pools = sorted({r.pool for r in placement.slices}) \
                if placement else None
            if pools is not None and pools != last_pools:
                last_pools = pools
                report["pools"].append(pools)
                report["rebinds"] = len(report["pools"]) - 1
            if k8s.condition_true(job, "Succeeded"):
                report["outcome"] = "succeeded"
                break
            if k8s.condition_true(job, "Failed"):
                report["outcome"] = "failed"
                report["failed_reason"] = k8s.get_condition(
                    job, "Failed").get("reason")
                break
            running = self._gang_running(cluster)
            if not running or k8s.condition_true(job, "Restarting"):
                time.sleep(0.02)
                continue
            on_flaky = any(p.get("spec", {}).get("nodeName") == flaky_node
                           for p in running)
            if first_fire_t is not None and recovered_t is None and \
                    not (on_flaky and fault.fired < fault.trips):
                # fully Running with nothing left for the fault to hit:
                # the gang has outrun the flaky node (migrated, or the
                # node's budget is spent)
                recovered_t = time.monotonic()
                report["recovery_s"] = round(
                    recovered_t - first_fire_t, 3)
            due = fault.fired < len(fault_steps) and \
                reached >= fault_steps[fault.fired]
            late = fault.fired >= len(fault_steps)
            if on_flaky and fault.fired < fault.trips and (due or late):
                if fault.maybe_fire(cluster, NAMESPACE):
                    report["fires"] = fault.fired
                    if first_fire_t is None:
                        first_fire_t = time.monotonic()
                    continue
            # train to the next fault step (if one is pending and the
            # gang still sits on the flaky node) or to the end
            target = fault_steps[fault.fired] \
                if (on_flaky and fault.fired < len(fault_steps)) \
                else self.total_steps
            if reached < target:
                resume = self._latest_step(ckpt_dir) or 0
                self._run_segment(
                    self._chief_env(cluster, chief, report), target)
                report["executed_steps"] += target - resume
                reached = target
            if reached >= self.total_steps:
                cluster.set_pod_phase(NAMESPACE, chief, "Succeeded")
        node = cluster.get("v1", "Node", "", flaky_node)
        report["flaky_node"] = flaky_node
        report["flaky_quarantined"] = is_quarantined(node)
        report["final_pools"] = last_pools
        report["migrated"] = bool(last_pools and
                                  self.FLAKY_POOL not in last_pools)
        report["useful_work_fraction"] = round(
            self.total_steps / max(1, report["executed_steps"]), 4)
        return _finish(report, mgr)


# ------------------------------------------------- control-plane soak
# The chaos tier that kills the control plane itself. Every soak above
# assumes an immortal operator and scheduler; here both run as
# lease-elected replica pairs (cluster/lease.py) over per-replica chaos
# clients (cluster/chaos.py ControllerChaos), and the faults are
# controller deaths mid-write, apiserver partitions and split-brain
# windows — while a real job must still train to Succeeded with params
# identical to an undisturbed run.

#: the control-plane soak's job: one gang of two GPUs on one node, the two
#: pods the JAX soak's v5e-8 job runs (two hosts)
CTRL_TOPOLOGY = "h100-2"
CTRL_WALL_BUDGET_S = 420.0


def _make_audit_cluster():
    """A FakeCluster that audits the two invariants the soak's checks
    name: (1) duplicate pod creates (two leaders racing _ensure_pods —
    the second create hits AlreadyExists); (2) lost annotation writes
    (every observed restart-count value, in write order — a lost update
    shows up as a repeat or a skip; binding rewrites counted the same
    way)."""
    from ..cluster.client import AlreadyExistsError
    from ..cluster.fake import FakeCluster
    from ..controllers.tpujob import RESTART_COUNT_ANNOTATION

    class Audit(FakeCluster):
        def __init__(self):
            super().__init__()
            self.duplicate_pod_creates = 0
            self.restart_count_writes: list[int] = []
            self.binding_writes = 0

        def create(self, obj):
            try:
                return super().create(obj)
            except AlreadyExistsError:
                if obj.get("kind") == "Pod":
                    self.duplicate_pod_creates += 1
                raise

        def _store_update(self, obj, *, check_rv=True):
            key = self._key(obj)
            prev = self._objects.get(key) or {}
            prev_anns = (prev.get("metadata") or {}) \
                .get("annotations") or {}
            out = super()._store_update(obj, check_rv=check_rv)
            if key[1] == _JOB_KIND:
                anns = (out.get("metadata") or {}) \
                    .get("annotations") or {}
                rc = anns.get(RESTART_COUNT_ANNOTATION)
                if rc is not None and \
                        rc != prev_anns.get(RESTART_COUNT_ANNOTATION):
                    self.restart_count_writes.append(int(rc))
                if anns.get(BINDING_ANNOTATION) != \
                        prev_anns.get(BINDING_ANNOTATION):
                    self.binding_writes += 1
            return out

    return Audit()


class _CtrlReplica:
    """One control-plane replica: its own connection (ControllerChaos —
    killable, partitionable), a mutation recorder (the zero-writes-
    while-follower audit), a lease elector, and a fencing client
    wrapped around the controller's write path. The stack mirrors the
    deployed shape: replicas: 2 Deployments whose pods each hold one
    apiserver connection and one Lease identity."""

    def __init__(self, role: str, index: int, cluster,
                 make_reconciler, lease_name: str,
                 lease_duration_s: float):
        from ..cluster.chaos import ControllerChaos, RecordingKubeClient
        from ..cluster.lease import FencedKubeClient, LeaderElector
        from ..controllers.runtime import Controller
        self.role = role
        self.identity = f"{role}-{index}"
        self.chaos = ControllerChaos(cluster)
        self.recorder = RecordingKubeClient(self.chaos)
        self.elector = LeaderElector(
            client=self.chaos, identity=self.identity, name=lease_name,
            duration_s=lease_duration_s)
        self.fenced = FencedKubeClient(self.recorder, self.elector)
        self.controller = Controller(
            reconciler=make_reconciler(), client=self.fenced,
            elector=self.elector, retry_backoff_s=0.01,
            retry_backoff_max_s=0.1)
        self.controller.bind_watches()
        self.controller.enqueue_existing()
        self.ever_leader = False
        self.alive = True

    def pump(self) -> None:
        if not self.alive:
            return
        self.controller.run_pending(max_iters=50)
        if self.elector.is_leader:
            self.ever_leader = True

    def kill(self) -> None:
        """Process death: connection gone, in-memory state gone, lease
        left to EXPIRE (no graceful release — that is the point)."""
        self.alive = False
        self.chaos.kill()
        self.controller.stop()


@dataclass
class ControlPlaneSoak(_Segments):
    """A real job trains to Succeeded while the operator and the
    scheduler are killed and re-elected and the apiserver partitions —
    the control-plane analog of ChaosSoak. Both roles run as TWO
    lease-elected replicas; a kill takes the current leader (armed to
    die right AFTER a write lands — the crash-consistency window) and
    spawns a replacement standby; the surviving standby must steal the
    lease, adopt the half-done state (half-created gangs, fresh
    bindings), and finish the job. The checks: Succeeded with params
    parity against a clean run, zero duplicate pod creates, zero lost
    annotation writes, zero mutations from any replica that never led,
    and measured failover times.

    The job is ``GPU: h100-2`` on one ``h100-8`` node; its chief trains
    in process on ``device`` (``train_kwargs`` as in the other soaks)."""

    workdir: str
    device: str = "cuda"
    train_kwargs: Optional[dict] = None
    total_steps: int = 8
    checkpoint_every: int = 2
    operator_kills: int = 3
    scheduler_kills: int = 2
    partitions: int = 2
    lease_duration_s: float = 0.5

    JOB_NAME = "ctrl-soak"

    def _manifest(self, ckpt_dir: str) -> dict:
        return _manifest(
            self.JOB_NAME, NAMESPACE, ckpt_dir,
            {"queue": "research", "priority": 0, "preemptible": False},
            {"backoffLimit": self.operator_kills + self.scheduler_kills
             + 6,
             "restartBackoffSeconds": 0.02,
             "restartBackoffMaxSeconds": 0.2},
            topology=CTRL_TOPOLOGY)

    def _fault_schedule(self) -> list:
        """Interleave the fault kinds over the training steps: one fault
        per step from step 2 on, operator kills first (they stress the
        gang-create path), scheduler kills next, partitions woven in."""
        kinds = []
        for i in range(max(self.operator_kills, self.scheduler_kills,
                           self.partitions)):
            if i < self.operator_kills:
                kinds.append("kill-operator")
            if i < self.scheduler_kills:
                kinds.append("kill-scheduler")
            if i < self.partitions:
                kinds.append("apiserver-partition")
        start = 2
        last = max(self.total_steps - 1, start)
        return [(min(start + i, last), kind)
                for i, kind in enumerate(kinds)]

    def run(self) -> dict:
        from ..cluster.lease import OPERATOR_LEASE, SCHEDULER_LEASE
        from ..controllers.tpujob import (RESTART_COUNT_ANNOTATION,
                                          TrainingJobReconciler)
        from .core import SliceScheduler
        from .health import HealthConfig
        from .queue import SchedulerConfig

        ckpt_dir = os.path.join(self.workdir, "job")
        cluster = _make_audit_cluster()
        cluster.add_gpu_nodes(POOL_TOPOLOGY)
        cluster.create(self._manifest(ckpt_dir))

        # Health scoring stays out of this soak's way: the pods the
        # fault injector fails are controller-kill collateral, not host
        # evidence — at the default threshold the repeated crashes
        # would quarantine the only node and starve the gang, turning a
        # control-plane drill into a capacity test (HealthSoak owns
        # that scenario).
        sched_config = SchedulerConfig(
            grow_cooldown_s=0.0,
            health=HealthConfig(quarantine_threshold=1e9))
        roles = {
            "operator": dict(
                lease=OPERATOR_LEASE, next_index=0, replicas=[],
                make=lambda: TrainingJobReconciler(_JOB_KIND)),
            "scheduler": dict(
                lease=SCHEDULER_LEASE, next_index=0, replicas=[],
                make=lambda: SliceScheduler(sched_config)),
        }
        retired: list = []   # killed replicas, kept for the write audit

        def spawn(role: str) -> _CtrlReplica:
            r = roles[role]
            rep = _CtrlReplica(role, r["next_index"], cluster, r["make"],
                               r["lease"], self.lease_duration_s)
            r["next_index"] += 1
            r["replicas"].append(rep)
            return rep

        for role in roles:
            spawn(role)
            spawn(role)

        report: dict = {"outcome": "timeout", "injected": [],
                        "segments": 0, "executed_steps": 0,
                        "failovers": {"operator": 0, "scheduler": 0},
                        "failover_s": [], "partitions": 0,
                        "checkpoint_dir": ckpt_dir}
        pending_failover: dict = {}   # role -> kill time

        def leader_of(role: str):
            return next((rep for rep in roles[role]["replicas"]
                         if rep.alive and rep.elector.is_leader), None)

        def pump(ticks: int = 2) -> None:
            for _ in range(ticks):
                for role in roles:
                    for rep in list(roles[role]["replicas"]):
                        rep.pump()
                    if role in pending_failover and \
                            leader_of(role) is not None:
                        report["failover_s"].append(round(
                            time.monotonic()
                            - pending_failover.pop(role), 3))
                        report["failovers"][role] += 1
                cluster.tick()

        def inject(kind: str) -> None:
            if kind == "apiserver-partition":
                # every live connection loses the apiserver: leaders
                # cannot renew, reconciles see transient errors
                report["injected"].append(kind)
                seconds = self.lease_duration_s * 2.5
                for role in roles:
                    for rep in roles[role]["replicas"]:
                        if rep.alive:
                            rep.chaos.partition(seconds)
                report["partitions"] += 1
                time.sleep(seconds + 0.05)
                return
            role = "operator" if kind == "kill-operator" else "scheduler"
            # a kill needs a leader to kill: right after a partition both
            # replicas may briefly be followers — wait for the next
            # election instead of silently counting a fault that never
            # happened (the failovers-against-kills check depends on
            # every counted kill being real)
            wait_leader = time.monotonic() + \
                max(5.0, self.lease_duration_s * 10)
            leader = leader_of(role)
            while leader is None and time.monotonic() < wait_leader:
                pump()
                time.sleep(0.01)
                leader = leader_of(role)
            if leader is None:
                report.setdefault("skipped", []).append(
                    f"{kind}: no {role} leader to kill")
                return
            report["injected"].append(kind)
            victim_pods = sorted(
                k8s.name_of(p)
                for p in cluster.list("v1", "Pod", NAMESPACE))
            # rotate the collateral victim across the gang's pods so no
            # single one soaks up every crash attribution
            victim = victim_pods[len(report["injected"])
                                 % len(victim_pods)] \
                if victim_pods else None
            if kind == "kill-operator" and victim:
                # die mid-gang-create: fail a pod, then the leader dies
                # right after its FIRST recreate lands — a half-created
                # gang the successor must adopt
                leader.chaos.die_after("create", 1)
                cluster.fail_pod(NAMESPACE, victim,
                                 "chaos: worker died under the operator")
            else:
                # the scheduler leader dies right after its next
                # annotation write lands (a binding or state rewrite
                # mid-flight; lease renewals are exempt from kill-points,
                # so this really is a controller write)
                leader.chaos.die_after("update", 1)
                if victim:
                    cluster.fail_pod(NAMESPACE, victim,
                                     "chaos: worker died under the "
                                     "scheduler kill")
            # drive until the armed death fires (or the leader is idle —
            # then kill it outright; a quiescent leader dies too)
            deadline = time.monotonic() + 5.0
            while not leader.chaos.dead and \
                    time.monotonic() < deadline:
                pump()
                time.sleep(0.01)
            if not leader.chaos.dead:
                leader.chaos.kill()
            leader.kill()
            retired.append(leader)
            roles[role]["replicas"].remove(leader)
            pending_failover[role] = time.monotonic()
            spawn(role)   # the replacement standby

        pending = sorted(self._fault_schedule())
        deadline = time.monotonic() + CTRL_WALL_BUDGET_S
        chief = f"{self.JOB_NAME}-worker-0-0"
        reached = 0
        while time.monotonic() < deadline:
            pump()
            job = cluster.get_or_none(_JOB_AV, _JOB_KIND, NAMESPACE,
                                      self.JOB_NAME)
            if job is None:
                report["outcome"] = "deleted"
                break
            if k8s.condition_true(job, "Succeeded"):
                report["outcome"] = "succeeded"
                break
            if k8s.condition_true(job, "Failed"):
                report["outcome"] = "failed"
                report["failed_reason"] = k8s.get_condition(
                    job, "Failed").get("reason")
                break
            pods = cluster.list("v1", "Pod", NAMESPACE)
            running = [p for p in pods
                       if p.get("status", {}).get("phase") == "Running"]
            if len(running) != 2 or \
                    k8s.condition_true(job, "Restarting"):
                time.sleep(0.02)
                continue
            target = min(pending[0][0], self.total_steps) if pending \
                else self.total_steps
            result = self._run_segment(
                self._chief_env(cluster, chief, report), target)
            report["segments"] += 1
            report["executed_steps"] += int(result.steps)
            reached = max(reached, target)
            if pending and pending[0][0] <= reached:
                _, kind = pending.pop(0)
                inject(kind)
                continue
            if reached >= self.total_steps:
                cluster.set_pod_phase(NAMESPACE, chief, "Succeeded")
        job = cluster.get_or_none(_JOB_AV, _JOB_KIND, NAMESPACE,
                                  self.JOB_NAME)
        if job is not None:
            report["gang_restarts"] = int(k8s.annotations_of(job).get(
                RESTART_COUNT_ANNOTATION, "0"))
        report["final_step"] = reached
        # ---- the write audit -------------------------------------------
        report["duplicate_pod_creates"] = cluster.duplicate_pod_creates
        rc = cluster.restart_count_writes
        report["restart_count_writes"] = rc
        # the invariant: observed restart-count values are EXACTLY
        # 1..N in write order — a lost update shows as a repeat or skip
        report["lost_annotation_writes"] = \
            rc != list(range(1, len(rc) + 1))
        report["binding_writes"] = cluster.binding_writes
        all_reps = retired + [rep for r in roles.values()
                              for rep in r["replicas"]]
        report["replicas_spawned"] = len(all_reps)
        report["never_leader_mutations"] = sum(
            len(rep.recorder.mutations) for rep in all_reps
            if not rep.ever_leader)
        report["fenced_rejections"] = sum(
            rep.fenced.rejected for rep in all_reps)
        for r in roles.values():
            for rep in r["replicas"]:
                rep.controller.stop()
        return report


def split_brain_drill(lease_duration_s: float = 0.4) -> dict:
    """The two-leaders-briefly window, made observable: partition the
    operator leader away from the apiserver, let the standby steal the
    lease at expiry, then prove the fence holds — the old leader
    demotes on its own clock, its write attempts raise FencingError
    client-side (counted, never reaching the wire), its recorder shows
    zero mutations after the steal, and no pod was ever double-created."""
    from ..cluster.chaos import ControllerChaos, RecordingKubeClient
    from ..cluster.lease import (OPERATOR_LEASE, FencedKubeClient,
                                 FencingError, LeaderElector)
    from ..controllers.runtime import Controller
    from ..controllers.tpujob import TrainingJobReconciler

    cluster = _make_audit_cluster()
    cluster.add_gpu_nodes(POOL_TOPOLOGY)
    cluster.create({
        "apiVersion": _JOB_AV, "kind": _JOB_KIND,
        "metadata": {"name": "drill", "namespace": NAMESPACE},
        "spec": {"replicaSpecs": {"GPU": {
            "gpuTopology": CTRL_TOPOLOGY, "template": _TEMPLATE}}},
    })

    class Rep:
        def __init__(self, ident: str):
            self.chaos = ControllerChaos(cluster)
            self.recorder = RecordingKubeClient(self.chaos)
            self.elector = LeaderElector(
                client=self.chaos, identity=ident,
                name=OPERATOR_LEASE, duration_s=lease_duration_s)
            self.fenced = FencedKubeClient(self.recorder, self.elector)
            self.controller = Controller(
                reconciler=TrainingJobReconciler(_JOB_KIND),
                client=self.fenced, elector=self.elector,
                retry_backoff_s=0.01, retry_backoff_max_s=0.1)
            self.controller.bind_watches()
            self.controller.enqueue_existing()

    a, b = Rep("op-a"), Rep("op-b")
    for _ in range(4):
        a.controller.run_pending()
        b.controller.run_pending()
        cluster.tick()
    report: dict = {"initial_leader_elected": a.elector.is_leader,
                    "pods_created": len(
                        cluster.list("v1", "Pod", NAMESPACE))}
    writes_before = len(a.recorder.mutations)

    # partition the leader; the standby steals at expiry
    a.chaos.partition(lease_duration_s * 3)
    deadline = time.monotonic() + lease_duration_s * 10
    while time.monotonic() < deadline and not b.elector.is_leader:
        b.controller.run_pending()
        a.controller.run_pending()
        time.sleep(0.02)
    report["stolen_by_standby"] = b.elector.is_leader
    report["old_leader_demoted"] = not a.elector.is_leader

    # the deposed leader tries to write anyway — the fence must reject
    # it client-side, before it can race the new leader
    try:
        a.fenced.patch(_JOB_AV, _JOB_KIND, NAMESPACE, "drill",
                       {"metadata": {"annotations":
                                     {"drill/zombie-write": "1"}}})
        report["fenced_write_rejected"] = False
    except FencingError:
        report["fenced_write_rejected"] = True

    for _ in range(4):
        a.controller.run_pending()
        b.controller.run_pending()
        cluster.tick()
    report["old_leader_writes_after_steal"] = \
        len(a.recorder.mutations) - writes_before
    report["fenced_rejections"] = a.fenced.rejected
    report["doubled_pod_creates"] = cluster.duplicate_pod_creates
    job = cluster.get(_JOB_AV, _JOB_KIND, NAMESPACE, "drill")
    report["zombie_write_landed"] = "drill/zombie-write" in \
        k8s.annotations_of(job)
    a.controller.stop()
    b.controller.stop()
    return report
