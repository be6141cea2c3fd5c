"""Scheduler soaks: preemption, elastic resize and node health.

The port's counterparts of ``PreemptionSoak``, ``ElasticSoak`` and
``HealthSoak`` of ``kubeflow_tpu/scheduler/soak.py``: the chaos-soak
pattern (cluster/chaos.py) applied to the slice scheduler. The control
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
``ControlPlaneSoak`` and the split-brain drill are not here: they need
the lease election and the controller chaos clients.
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
              run_policy: Optional[dict] = None) -> dict:
    spec = {"checkpointDir": ckpt_dir,
            "schedulingPolicy": policy,
            "replicaSpecs": {"GPU": {"gpuTopology": POOL_TOPOLOGY,
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
