"""The training-job operator: TPUJob / TFJob / PyTorchJob / MPIJob reconciler.

The port's copy of ``kubeflow_tpu/controllers/tpujob.py`` with a GPU
accelerator replica. One reconciler serves every kind because the
accelerator execution path is identical — only the legacy env contract
differs per kind.

Semantics (the JAX package's, kept):

- **Gang scheduling (mandatory for GPU replicas).** All pods of a GPU
  replica carry a pod-group label + min-member annotation; the scheduler
  binds them all-or-nothing (the kube-batch PodGroup semantic). The slice
  is the atomic unit: the reconciler never creates a partial gang.
- **Topology contract.** One pod per GPU. Each GPU pod gets the
  ``KFTPU_*`` contract (``api/topology.py``) the worker's bootstrap reads,
  the torch.distributed env of the same contract (``MASTER_ADDR`` /
  ``MASTER_PORT`` = the coordinator, ``RANK`` = the process id,
  ``WORLD_SIZE`` = the process count; no ``LOCAL_RANK``: a pod sees one
  GPU), the ``nvidia.com/gpu.product`` node selector and one
  ``nvidia.com/gpu``. Legacy replicas get their native contracts:
  TF_CONFIG (TFJob), MASTER_ADDR/RANK/WORLD_SIZE (PyTorchJob), hostlist
  env (MPIJob).
- **Slice-level failure domain.** Any failed pod in the gang restarts the
  WHOLE gang (delete + recreate) up to runPolicy.backoffLimit, then the
  job is Failed; a vanished member, a stalled chief or worker and a
  numeric anomaly (LKG rollback) restart it too.
- **Success.** Process-0 ("chief") pod success completes the job;
  remaining pods are cleaned per cleanPodPolicy.
- **Conditions.** Queued/Created/Running/Restarting/Succeeded/Failed,
  mirroring tf-operator's JobCondition vocabulary.
- **Scheduler-managed jobs** (``spec.schedulingPolicy``) create nothing
  until the slice scheduler (``scheduler/core.py``) writes the binding
  annotation; until then the job is Queued. A bound gang's pods pin to
  the binding's pool and to the node of its row (one slice is one node).
  A removed binding (preemption, an evacuated suspect, lost GPUs) tears
  the gang down and sets ``resumeFrom``; an elastic binding of another
  shape restarts the gang at that shape; a binding that names warm-pod
  slots adopts them.
"""

from __future__ import annotations

import copy
import json
import logging
import math
import os
import random
import time

from ..api import k8s
from ..api.topology import TopologyContract, render_contracts
from ..api.trainingjob import (ANOMALY_ANNOTATION,
                               ANOMALY_COUNT_ANNOTATION,
                               ANOMALY_ROLLBACK_ANNOTATION, API_VERSIONS,
                               COND_CREATED, COND_FAILED, COND_QUEUED,
                               COND_RESTARTING, COND_RUNNING, COND_SUCCEEDED,
                               CLEAN_POD_ALL, CLEAN_POD_NONE,
                               CLEAN_POD_RUNNING, HEARTBEAT_ANNOTATION,
                               JOB_KINDS, POD_FAILED,
                               POD_RUNNING, POD_SUCCEEDED,
                               PREEMPTED_COUNT_ANNOTATION,
                               SCHED_REASON_ANNOTATION, SUSPECT_ANNOTATION,
                               ReplicaSpec, TrainingJob)
from ..cluster.client import (KubeClient, NotFoundError, apply_annotations,
                              update_with_conflict_retry)
from ..cluster.fake import GPU_PRODUCT_LABEL, GPU_RESOURCE, POD_GROUP_LABEL
from ..obs import registry as obsreg
from ..obs.trace import (SPAN_MAX_BYTES_ENV, SPAN_PATH_ENV,
                         TRACE_ID_ANNOTATION, TRACE_ID_ENV)
from ..scheduler import health, warmpool
from ..scheduler.inventory import (HOSTNAME_LABEL, POOL_LABEL, Placement,
                                   SliceInventory, SliceRect)
from .runtime import (Key, Reconciler, Result, ensure_trace_id,
                      trace_job_event)

log = logging.getLogger(__name__)

# condition precedence for the exported phase gauge (newest-wins, the
# dashboard's _job_phase walk plus Restarting)
_PHASE_ORDER = (COND_SUCCEEDED, COND_FAILED, COND_RESTARTING, COND_RUNNING,
                COND_CREATED)


def _now() -> float:
    """Wall clock behind every timeout decision (backoff, stall, deadline,
    TTL) — one seam for tests/chaos to control time deterministically."""
    return time.time()


RESTART_COUNT_ANNOTATION = "kubeflow.org/gang-restart-count"
# unix time before which a failed gang must NOT be recreated (exponential
# backoff with jitter between gang restarts — restart-storm protection).
# Persisted as an annotation so a controller crash/restart cannot shortcut
# the wait the way an in-memory timer would.
RESTART_NOT_BEFORE_ANNOTATION = "kubeflow.org/gang-restart-not-before"
# gang shape at last creation (topology×slices per GPU replica): a changed
# fingerprint means the SPEC was resized/reshaped (deliberate restart on
# the new shape), not that members vanished — pod COUNT alone can't tell
# (equal-count reshapes exist: h100-4 x 2 → h100-8 x 1)
GANG_SHAPE_ANNOTATION = "kubeflow.org/gang-shape"
REPLICA_TYPE_LABEL = "kubeflow.org/replica-type"
REPLICA_INDEX_LABEL = "kubeflow.org/replica-index"
DEFAULT_PORT = 2222
# the process group's rendezvous port on the coordinator pod
COORD_PORT = 8476
# the slice-scheduler binding's run, on every pod of a bound slice
SLICE_ANNOTATION = "scheduling.kubeflow.org/slice"


def _replica_pod_name(job: TrainingJob, rtype: str, index) -> str:
    return f"{job.name}-{rtype.lower()}-{index}"


def _gpu_pod_name(job: TrainingJob, slice_id: int, gpu: int) -> str:
    return f"{job.name}-worker-{slice_id}-{gpu}"


def _workers_service_name(job: TrainingJob) -> str:
    return f"{job.name}-workers"


class TrainingJobReconciler(Reconciler):
    """Reconciler for one job kind; instantiate once per kind."""

    def __init__(self, kind: str = "TPUJob"):
        self.kind = kind
        self.primary = (API_VERSIONS[kind], kind)
        self.owns = [("v1", "Pod"), ("v1", "Service")]
        # last exported phase per job key (the gang phase gauge clears a
        # job's previous-phase series instead of exporting two phases)
        self._exported_phase: dict[Key, str] = {}
        # Future-stamped heartbeats (worker clock ahead of ours): the
        # clamp state. (namespace, pod) -> (raw_beat, first_seen_at) —
        # staleness for a future beat is measured from when WE first saw
        # that value, so a skewed-but-hung worker still trips the stall
        # watchdog one timeout after we noticed it, instead of being
        # infinitely fresh until our clock catches its skew up.
        self._future_beats: dict[tuple, tuple] = {}
        # consecutive reconciles a worker trailed the chief's step by
        # >= health.STEP_SKEW_MIN_STEPS: (ns, job, pod) -> streak
        self._skew_streak: dict[tuple, int] = {}
        # heartbeat numeric-canary dedup: (ns, pod) -> last heartbeat
        # step already flagged for a non-finite lastLoss/lastGradNorm —
        # one health event per bad step, not one per reconcile tick
        self._numeric_flagged: dict[tuple, int] = {}

    # ------------------------------------------------------------ reconcile

    def reconcile(self, client: KubeClient, key: Key) -> Result:
        namespace, name = key
        try:
            manifest = client.get(self.primary[0], self.kind, namespace, name)
        except NotFoundError:
            self._export_phase(key, None)
            # cascade GC removed the children with the owner — USUALLY.
            # The crash-consistency hole: a reconcile that read the job
            # just before its deletion creates pods just after the
            # cascade already ran (or a controller died mid-create and
            # its successor raced the delete) — orphans that pin GPUs
            # forever, because nothing owns them anymore. The
            # orphan's own ADDED/MODIFIED event maps back to this key,
            # so level-triggered cleanup lands here.
            self._gc_orphans(client, namespace, name)
            return Result()
        manifest = ensure_trace_id(client, manifest)
        self._export_phase(key, manifest)
        job = TrainingJob.from_manifest(manifest)

        if k8s.condition_true(manifest, COND_SUCCEEDED) or \
                k8s.condition_true(manifest, COND_FAILED):
            return self._handle_finished(client, job, manifest)

        # Scheduler-managed jobs (spec.schedulingPolicy present) create
        # NOTHING until the slice scheduler writes the binding annotation:
        # admission is no longer placement. Unbound jobs sit in a visible
        # Queued condition; a binding REMOVED mid-run (preemption, or a
        # reshape invalidating it) tears the gang down through the
        # graceful path and re-queues — never a failure.
        binding = self._slice_binding(job, manifest)
        if job.scheduling_policy is not None and job.gpu_spec is not None \
                and binding is None:
            return self._handle_unbound(client, job, manifest)
        if binding is not None:
            # Elastic resize: the binding's shape IS the gang's shape.
            # A scheduler resize rewrites the binding to a different
            # topology inside the job's [minChips, maxChips] envelope;
            # adopting it here makes every downstream consumer — pod
            # entries, topology contracts, KFTPU_SHARDING, the gang
            # fingerprint — render the RESIZED gang, and the
            # fingerprint mismatch below restarts the old-shape gang
            # through the graceful GangResized path.
            job = self._job_at_binding_shape(job, binding)

        pods = client.list("v1", "Pod", namespace, selector=job.selector())
        by_name = {k8s.name_of(p): p for p in pods}

        self._ensure_services(client, job, manifest)

        phases = {k8s.name_of(p): p.get("status", {}).get("phase", "Pending")
                  for p in pods}
        chief = self._chief_pod_name(job)
        # chief success wins over concurrent worker failures AND vanishes:
        # a completed job must not be gang-restarted by a non-chief exiting
        # non-zero (or its pod object disappearing) during shutdown
        if phases.get(chief) == POD_SUCCEEDED:
            self._set_condition(client, manifest, COND_SUCCEEDED, "True",
                                "JobSucceeded", f"chief pod {chief} succeeded")
            self._cleanup_pods(client, job, pods)
            return Result()

        # activeDeadlineSeconds: a job running past its wall budget is
        # Failed (DeadlineExceeded) — measured from the Created condition's
        # transition time, which survives controller restarts
        deadline_in = self._deadline_remaining(job, manifest)
        if deadline_in is not None and deadline_in <= 0:
            self._set_condition(
                client, manifest, COND_FAILED, "True", "DeadlineExceeded",
                f"job exceeded activeDeadlineSeconds="
                f"{job.run_policy.active_deadline_seconds}")
            self._cleanup_pods(client, job, pods)
            return Result()

        # A GPU gang member VANISHING mid-run (node loss, preemption
        # deleting the pod object — no Failed phase ever appears) must
        # restart the WHOLE gang: the survivors' process group cannot
        # re-admit a fresh peer, so recreating just the missing pod
        # would hang the slice forever. Scoped to GPU pods only — legacy
        # CPU replicas (TF PS/worker gRPC) reconnect to a solo recreation
        # the way the reference operators relied on. The Restarting
        # condition marks an intentional between-reconciles gap (we just
        # deleted the gang ourselves).
        gpu_entries = {rtype: self._gpu_pod_entries(job, rs)
                       for rtype, rs in job.replica_specs.items()
                       if rs.is_gpu}
        gpu_names = [n for entries in gpu_entries.values()
                     for n, _ in entries]
        shape = self._gang_shape(job, binding)
        shape_anno = k8s.annotations_of(manifest).get(GANG_SHAPE_ANNOTATION)
        if gpu_names and k8s.condition_true(manifest, COND_CREATED) \
                and not k8s.condition_true(manifest, COND_RESTARTING):
            if shape_anno is not None and \
                    self._shape_changed(shape_anno, shape):
                # spec RESIZE/RESHAPE (numSlices/topology changed), an
                # elastic scheduler resize (the adopted binding shape
                # changed), or a defrag migration (same shape, new
                # runs): the old shape/placement is baked into every
                # survivor's KFTPU_* env and node pinning, so the gang
                # restarts on the new one — deliberately, without
                # burning backoff budget (an operator action, not a
                # failure). No by_name guard: even with every pod already
                # gone this path must run so resumeFrom is set.
                return self._handle_gang_failure(
                    client, job, manifest, pods,
                    sorted(by_name) or ["<all>"],
                    reason="GangResized", count_restart=False)
            # a missing annotation (pre-annotation operator versions) must
            # still protect against the slice-hang: default to vanish
            # semantics, the safe restart
            missing = [n for n in gpu_names if n not in by_name]
            if missing:
                return self._handle_gang_failure(
                    client, job, manifest, pods, missing,
                    reason="GangPodsVanished")

        if k8s.condition_true(manifest, COND_RESTARTING):
            # restart backoff: the gang stays down until the persisted
            # not-before time passes (restart-storm protection) — requeue
            # for the remainder instead of recreating immediately
            wait = self._restart_backoff_remaining(manifest)
            if wait > 0:
                return Result(requeue_after=wait)

        created = self._ensure_pods(client, job, manifest, by_name,
                                    gpu_entries, binding=binding)
        if created:
            if gpu_names and shape_anno != shape:
                # conflict-safe: the scheduler writes bindings/state on
                # this same object concurrently — a stale-read update
                # here must re-read, not clobber (cluster/client.py)
                manifest = update_with_conflict_retry(
                    client, *k8s.key_of(manifest),
                    lambda obj: apply_annotations(
                        obj, {GANG_SHAPE_ANNOTATION: shape}))
            self._set_condition(client, manifest, COND_CREATED, "True",
                                "JobCreated", f"created {created} pods")
            if binding is not None:
                # the queue wait is over: the gang exists on its slices
                self._set_condition(client, manifest, COND_QUEUED, "False",
                                    "Bound",
                                    "slice binding present; gang created")
            # the intentional-gap marker is consumed: the gang exists again
            if k8s.condition_true(manifest, COND_RESTARTING):
                self._set_condition(client, manifest, COND_RESTARTING,
                                    "False", "GangRecreated",
                                    "gang pods recreated")
            return Result(requeue=True)

        failed = [n for n, ph in phases.items() if ph == POD_FAILED]
        if failed:
            # a failed pod carrying the sentinel's anomaly-evidence
            # annotation is NOT a crash: the worker tripped a numeric
            # detector and exited deliberately so the control plane can
            # roll the job back to its last-known-good checkpoint — a
            # separate budget, a rollback (not a plain restart), and SDC
            # evidence folded onto the suspect host
            evidence_pod, anomaly = self._anomaly_of(by_name, failed)
            if anomaly is not None:
                return self._handle_anomaly(
                    client, job, manifest, pods, failed, anomaly,
                    suspect=self._suspect_node(by_name, [evidence_pod]))
            return self._handle_gang_failure(
                client, job, manifest, pods, failed,
                suspect=self._suspect_node(by_name, failed),
                evidence=health.EVENT_POD_CRASH)

        # stall watchdog: a chief that is Running but has stopped advancing
        # its heartbeat is hung-not-dead (wedged collective, a dead GPU
        # under a live pod) — no Failed phase will ever appear, so
        # the watchdog is the only recovery path
        stalled = self._stalled_chief(job, manifest, by_name, chief)
        if stalled:
            return self._handle_gang_failure(
                client, job, manifest, pods, [chief], reason="StallTimeout",
                suspect=self._suspect_node(by_name, [chief]),
                evidence=health.EVENT_STALL)

        # per-worker stall: one wedged worker under a healthy chief (the
        # straggler-gone-dead case the chief-only watchdog misses) — the
        # fault is attributable to the stalled worker's host, so the
        # restart folds the stall into that host's health score
        stalled_workers = self._stalled_workers(job, manifest, by_name,
                                                gpu_names, chief)
        if stalled_workers:
            return self._handle_gang_failure(
                client, job, manifest, pods, stalled_workers,
                reason="WorkerStallTimeout",
                suspect=self._suspect_node(by_name, stalled_workers),
                evidence=health.EVENT_WORKER_STALL)

        # straggler scoring (no teardown): per-worker step skew off the
        # heartbeat steps feeds the host health score
        if gpu_names:
            self._note_step_skew(job, by_name, gpu_names, chief, client)
            # numeric canary off the same heartbeats: a worker reporting
            # a non-finite lastLoss/lastGradNorm is flagged (host health
            # event + metric) even when the in-step sentinel is disabled
            self._note_numeric_health(job, by_name, gpu_names, client)
        # the rollback directive is consumed once the recreated gang
        # provably trained PAST the trip step: clear it so the NEXT
        # restart (whatever its cause) resumes from the newest
        # checkpoint again instead of the stale LKG pin
        self._clear_rollback_annotation(client, job, manifest, by_name,
                                        chief)

        running = sum(1 for ph in phases.values() if ph == POD_RUNNING)
        self._finalize_status(client, manifest, pods,
                              all_running=(running == job.total_pods()
                                           and running > 0))
        # timers that need a re-check without any cluster event: the
        # active deadline landing, and the next stall-watchdog probe
        requeue_in = [t for t in (deadline_in,) if t is not None and t > 0]
        if job.run_policy.stall_timeout_seconds:
            requeue_in.append(
                max(1.0, job.run_policy.stall_timeout_seconds / 2))
        return Result(requeue_after=min(requeue_in)) if requeue_in \
            else Result()

    # ------------------------------------------------------- observability

    def _export_phase(self, key: Key, manifest: dict | None) -> None:
        """The gang phase gauge: kftpu_job_phase{...,phase}=1 for the
        job's CURRENT phase only (the previous phase's series is
        removed; a deleted job exports nothing)."""
        g = obsreg.gauge(
            "kftpu_job_phase",
            "1 for the training job's current phase (condition walk)",
            labels=("namespace", "name", "kind", "phase"))
        namespace, name = key
        prev = self._exported_phase.get(key)
        phase = None
        if manifest is not None:
            phase = next((c for c in _PHASE_ORDER
                          if k8s.condition_true(manifest, c)), "Pending")
        if phase == prev:
            return
        if prev is not None:
            g.remove(namespace=namespace, name=name, kind=self.kind,
                     phase=prev)
        if phase in (None, COND_SUCCEEDED, COND_FAILED):
            # done or gone: the per-job watchdog/straggler state has
            # nothing left to watch — a long-lived controller must not
            # accumulate entries (or stale skew series) for every job
            # that ever stalled
            self._prune_job_state(namespace, name)
        if phase is None:
            # job object gone: its final-ledger series go with it (the
            # same rule as the phase gauge — a deleted job must not
            # export its decomposition forever)
            from ..obs.goodput import remove_job_ledger
            remove_job_ledger(namespace, name)
            self._exported_phase.pop(key, None)
            return
        g.labels(namespace=namespace, name=name, kind=self.kind,
                 phase=phase).set(1)
        self._exported_phase[key] = phase

    def _prune_job_state(self, namespace: str, name: str) -> None:
        """Drop the in-memory heartbeat-clamp and skew-streak entries
        for one job's pods (pod names are '<job>-<role>-...'), and its
        skew gauge series."""
        prefix = f"{name}-"
        self._future_beats = {
            k: v for k, v in self._future_beats.items()
            if not (k[0] == namespace and k[1].startswith(prefix))}
        self._numeric_flagged = {
            k: v for k, v in self._numeric_flagged.items()
            if not (k[0] == namespace and k[1].startswith(prefix))}
        self._skew_streak = {
            k: v for k, v in self._skew_streak.items()
            if not (k[0] == namespace and k[1] == name)}
        obsreg.gauge(
            "kftpu_job_step_skew",
            "chief step minus the slowest worker's heartbeat step",
            labels=("namespace", "name")).remove(
                namespace=namespace, name=name)

    def _trace_event(self, manifest: dict, name: str, **attrs) -> None:
        trace_job_event("operator", manifest, name, **attrs)

    # ---------------------------------------------------- slice scheduling

    @staticmethod
    def _slice_binding(job: TrainingJob,
                       manifest: dict) -> Placement | None:
        """The scheduler's placement for this job, or None when unbound.
        A binding whose shape no longer matches the spec (resize under
        it) reads as unbound: creating a gang on a stale placement would
        double-book GPUs the scheduler has already re-planned. Parse +
        shape check are the scheduler's own (scheduler/queue.py), so the
        two sides of the annotation contract cannot drift."""
        from ..scheduler.queue import binding_matches, binding_of
        placement = binding_of(manifest)
        if placement is None or not binding_matches(placement, job):
            return None
        return placement

    def _handle_unbound(self, client: KubeClient, job: TrainingJob,
                        manifest: dict) -> Result:
        """A scheduler-managed job without a binding: tear down whatever
        gang exists (preemption reclaim — the graceful delete path gives
        workers SIGTERM → forced checkpoint → exit 75) and surface a
        Queued condition. No backoff budget is burned: a preemption is a
        requeue, not a failure."""
        pods = client.list("v1", "Pod", job.namespace,
                           selector=job.selector())
        anns = k8s.annotations_of(manifest)
        preempted = int(anns.get(PREEMPTED_COUNT_ANNOTATION, "0")) > 0
        if pods:
            for p in pods:
                try:
                    client.delete("v1", "Pod",
                                  k8s.namespace_of(p, job.namespace),
                                  k8s.name_of(p))
                except NotFoundError:
                    pass
            if job.checkpoint_dir and not job.resume_from:
                # same resume loop as a gang restart: the re-bound gang
                # continues from the forced preemption checkpoint.
                # Conflict-safe RMW: the scheduler is rewriting this
                # object's annotations in the same window

                def _set_resume(obj: dict, ckpt=job.checkpoint_dir):
                    if obj.setdefault("spec", {}).get("resumeFrom"):
                        return None   # already set by a sibling path
                    obj["spec"]["resumeFrom"] = ckpt
                    return obj
                update_with_conflict_retry(client, *k8s.key_of(manifest),
                                           _set_resume)
            self._set_condition(client, manifest, COND_RUNNING, "False",
                                "Preempted" if preempted else "Unbound",
                                "gang torn down; awaiting re-bind")
        reason = "Preempted" if preempted else "AwaitingBinding"
        detail = anns.get(SCHED_REASON_ANNOTATION, "")
        self._set_condition(
            client, manifest, COND_QUEUED, "True", reason,
            detail or "waiting for the slice scheduler to bind this gang")
        return Result()

    # ------------------------------------------------------------- children

    def _ensure_services(self, client: KubeClient, job: TrainingJob,
                         manifest: dict) -> None:
        svc = k8s.make(
            "v1", "Service", _workers_service_name(job), job.namespace,
            labels=job.selector(),
            spec={
                "clusterIP": "None",  # headless: stable per-pod DNS
                "selector": job.selector(),
                "ports": [
                    {"name": "coordinator", "port": COORD_PORT},
                    {"name": "legacy", "port": DEFAULT_PORT},
                ],
            },
        )
        k8s.set_owner(svc, manifest)
        if client.get_or_none(*k8s.key_of(svc)) is None:
            client.create(svc)

    @staticmethod
    def _gpu_pod_entries(job: TrainingJob, rs) -> list[tuple[str, object]]:
        """(pod name, topology contract) for every member of a GPU replica
        — the ONE place gang pod naming happens (_ensure_pods and the
        vanish detector both consume it; drift between them would make
        every pod look missing)."""
        contracts = render_contracts(
            job.name, job.namespace, rs.topology, rs.num_slices,
            port=COORD_PORT)
        return [(_gpu_pod_name(job, c.slice_id,
                               c.process_id % rs.topology.pods_per_slice), c)
                for c in contracts]

    @staticmethod
    def _job_at_binding_shape(job: TrainingJob,
                              binding: Placement) -> TrainingJob:
        """The job with its GPU replica spec swapped to the BINDING's
        shape (elastic resize: the scheduler may bind a shape other
        than the spec's nominal one, inside the minChips/maxChips
        envelope — _slice_binding already validated the envelope via
        binding_matches). Identity when the shapes agree."""
        import dataclasses

        from ..api.topology import parse_topology
        gpu = job.gpu_spec
        if gpu is None or gpu.topology is None:
            return job
        if binding.topology == gpu.topology.name \
                and binding.num_slices == gpu.num_slices:
            return job
        try:
            topo = parse_topology(binding.topology)
        except ValueError:
            return job
        specs = dict(job.replica_specs)
        specs["GPU"] = dataclasses.replace(
            gpu, topology=topo, num_slices=binding.num_slices)
        return dataclasses.replace(job, replica_specs=specs)

    @staticmethod
    def _shape_changed(shape_anno: str, shape: str) -> bool:
        """Whether the persisted fingerprint and the computed one name
        DIFFERENT gangs. An annotation without the "@runs" suffix
        (written before the gang was bound) matches on the shape part
        alone: a binding appearing under a running unmanaged gang must
        not restart it."""
        if shape_anno == shape:
            return False
        if "@" not in shape_anno and shape.split("@", 1)[0] == shape_anno:
            return False
        return True

    @staticmethod
    def _gang_shape(job: TrainingJob,
                    binding: Placement | None = None) -> str:
        """Shape fingerprint of the GPU replicas (topology×slices per
        replica type): the value behind GANG_SHAPE_ANNOTATION. With a
        binding, the PLACEMENT rides in the fingerprint too: a
        scheduler defrag migration moves the gang without changing its
        size, and the running pods (pinned to the old node and GPUs)
        must still restart onto the new cells."""
        shape = ";".join(
            f"{rtype}:{rs.topology.name}x{rs.num_slices}"
            for rtype, rs in sorted(job.replica_specs.items())
            if rs.is_gpu and rs.topology is not None)
        if binding is not None and binding.slices:
            runs = ",".join(
                f"{r.pool}:{r.x}.{r.y}.{r.h}x{r.w}"
                for r in binding.slices)
            shape += f"@{runs}"
        return shape

    def _ensure_pods(self, client: KubeClient, job: TrainingJob,
                     manifest: dict, existing: dict[str, dict],
                     gpu_entries: dict[str, list],
                     binding: Placement | None = None) -> int:
        # slice_id -> assigned run (the scheduler's placement order IS
        # the slice order), and each run's node: one slice is one node
        slice_rects = {i: r for i, r in
                       enumerate(binding.slices)} if binding else {}
        node_at = SliceInventory.from_nodes(
            client.list("v1", "Node")).node_at if slice_rects else {}
        # warm-pod adoption: the binding names the pre-initialized pods
        # this placement covers (scheduler stamps warmHosts at bind
        # time); retire them and mark the gang warm-started BEFORE the
        # cold-create below — rebinds, elastic resizes, and preemption
        # re-binds all come through here, which is exactly the point
        adopted = self._adopt_warm_pods(client, binding) \
            if binding is not None and binding.warm_hosts else []
        created = 0
        for rtype, rs in job.replica_specs.items():
            if rs.is_gpu:
                # all-or-nothing create: build every missing member first,
                # then emit the whole set (never a partial gang)
                gang_pods = []
                for pname, c in gpu_entries[rtype]:
                    if pname in existing:
                        continue
                    rect = slice_rects.get(c.slice_id)
                    node = node_at.get((rect.pool, rect.x), "") \
                        if rect is not None else ""
                    gang_pods.append(self._build_gpu_pod(
                        job, manifest, rs, c, pname, rect=rect,
                        node=node))
                for pod in gang_pods:
                    if adopted:
                        pod["metadata"]["annotations"][
                            warmpool.ADOPTED_ANNOTATION] = \
                            json.dumps(adopted)
                        self._add_env(pod,
                                      {warmpool.WARM_START_ENV: "1"})
                    client.create(pod)
                    created += 1
            else:
                for i in range(rs.replicas):
                    pname = _replica_pod_name(job, rtype, i)
                    if pname in existing:
                        continue
                    client.create(self._build_replica_pod(
                        job, manifest, rs, rtype, i, pname))
                    created += 1
        return created

    def _adopt_warm_pods(self, client: KubeClient,
                         binding: Placement) -> list[dict]:
        """Retire the warm pods of the slots the binding's warmHosts
        name; returns the slots with at least one live pod (a slot whose
        pods are gone — raced away by another bind, or never created —
        degrades to a plain cold create, never an error)."""
        slots = {(w["pool"], int(w["host"])) for w in binding.warm_hosts}
        retired: set = set()
        for pod in warmpool.list_warm_pods(client):
            key = warmpool.slot_of(pod)
            if key is None or key[:2] not in slots:
                continue
            try:
                client.delete("v1", "Pod", warmpool.WARM_POOL_NAMESPACE,
                              k8s.name_of(pod))
            except NotFoundError:
                continue
            retired.add(key[:2])
        adopted = [{"pool": w["pool"], "host": int(w["host"])}
                   for w in binding.warm_hosts
                   if (w["pool"], int(w["host"])) in retired]
        if adopted:
            obsreg.counter(
                "kftpu_warm_pod_adoptions_total",
                "gang creations that adopted a pre-initialized warm "
                "pod instead of cold-creating").inc(len(adopted))
        return adopted

    def _base_pod(self, job: TrainingJob, manifest: dict, rs: ReplicaSpec,
                  name: str, rtype: str, index: str) -> dict:
        pod = copy.deepcopy(rs.template) or {}
        pod.setdefault("spec", {}).setdefault("containers",
                                              [{"name": "main", "image": "main"}])
        # operator-required labels LAST: a user template must not be able to
        # override the selector / replica identity labels
        labels = {**(pod.get("metadata", {}).get("labels") or {}),
                  **job.selector(), REPLICA_TYPE_LABEL: rtype.lower(),
                  REPLICA_INDEX_LABEL: str(index)}
        meta = {"name": name, "namespace": job.namespace, "labels": labels,
                "annotations": dict(pod.get("metadata", {}).get("annotations") or {})}
        pod = {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
               "spec": pod.get("spec", {})}
        pod["spec"].setdefault("restartPolicy", "Never")
        pod["spec"]["hostname"] = name
        pod["spec"]["subdomain"] = _workers_service_name(job)
        k8s.set_owner(pod, manifest)
        # checkpoint/resume contract on every replica kind: workers write to
        # checkpointDir and restore from resumeFrom before the loop
        # (runtime/worker.py); gang restart sets resumeFrom automatically
        # Pod self-identity (the downward-API analog): lets the worker
        # annotate its OWN pod with the liveness heartbeat the stall
        # watchdog reads (runtime/metrics.py HeartbeatReporter). The
        # operator forwards its own KFTPU_APISERVER so workers can build
        # an in-pod client for the heartbeat patch; without it the
        # reporter is a no-op (and the watchdog, seeing no heartbeat,
        # never trips — non-instrumented deployments keep working).
        env = {"KFTPU_POD_NAME": name, "KFTPU_POD_NAMESPACE": job.namespace}
        if os.environ.get("KFTPU_APISERVER"):
            env["KFTPU_APISERVER"] = os.environ["KFTPU_APISERVER"]
        # trace contract (obs/trace.py): the job's minted trace id rides
        # into every worker so its window spans stitch onto the control
        # plane's queued/bound/running events; the operator forwards its
        # own span sink so workers write where the control plane does,
        # unless the spec names one explicitly (obs_spec below wins)
        trace_id = k8s.annotations_of(manifest).get(TRACE_ID_ANNOTATION)
        if trace_id:
            env[TRACE_ID_ENV] = trace_id
        if os.environ.get(SPAN_PATH_ENV):
            env[SPAN_PATH_ENV] = os.environ[SPAN_PATH_ENV]
        if os.environ.get(SPAN_MAX_BYTES_ENV):
            # sink rotation cap rides along with the sink: workers
            # appending to the shared JSONL honor the same rotation
            # policy the control plane does (obs/trace.py)
            env[SPAN_MAX_BYTES_ENV] = os.environ[SPAN_MAX_BYTES_ENV]
        # spec.observability → KFTPU_SPAN_PATH / KFTPU_OBS_METRICS_PORT:
        # the worker's span sink and its own /metrics port
        env.update(job.obs_spec.to_env())
        if job.checkpoint_dir:
            env["KFTPU_CHECKPOINT_DIR"] = job.checkpoint_dir
        if job.resume_from:
            env["KFTPU_RESUME_FROM"] = job.resume_from
        if job.data_dir:
            env["KFTPU_DATA_DIR"] = job.data_dir
        if job.eval_data_dir:
            env["KFTPU_EVAL_DATA_DIR"] = job.eval_data_dir
        if job.tensorboard_dir:
            env["KFTPU_TB_DIR"] = job.tensorboard_dir
        if job.weight_update:
            # spec.weightUpdate → the worker's ZeRO-2 weight-update knob
            # (runtime/worker.py reads it into TrainStepBuilder)
            env["KFTPU_WEIGHT_UPDATE"] = job.weight_update
        if job.scheduling_policy is not None:
            # spec.schedulingPolicy → KFTPU_SCHED_{QUEUE,PRIORITY,
            # PREEMPTIBLE}: queue/priority are informational (logs,
            # metrics labels); preemptible tells the SIGTERM handler a
            # reclaim is a requeue, not a crash
            env.update(job.scheduling_policy.to_env())
        # spec.input → the overlapped-input-pipeline knobs: augment
        # worker processes (KFTPU_INPUT_WORKERS) and device prefetch
        # depth (KFTPU_DEVICE_PREFETCH) — runtime/worker.py reads them
        # into the shared-memory augment ring / DevicePrefetcher
        env.update(job.input_spec.to_env())
        # spec.multislice → KFTPU_MULTISLICE_PIPELINE/_MICROBATCHES: the
        # MPMD pipeline-over-DCN path (one program per slice, explicit
        # activation transfers — runtime/worker.py,
        # parallel/multislice.py)
        env.update(job.multislice.to_env())
        # spec.kernels → KFTPU_KERNEL_ATTENTION/_OPTIMIZER/_SERVING: the
        # kernel tier (flash attention / fused-Adam update / int8
        # serving) — runtime/worker.py consumes them and bakes every set
        # knob into the recipe fingerprint + AOT step key
        env.update(job.kernels.to_env())
        # spec.integrity → KFTPU_INTEGRITY*: the numeric sentinel knobs
        # (runtime/sentinel.py). Deliberately EXCLUDED from the recipe
        # fingerprint — toggling detection must not invalidate warm
        # compile caches or AOT executables (the probe's program shape
        # is layout-gated, not integrity-gated).
        env.update(job.integrity.to_env())
        # anomaly-rollback directive → KFTPU_RESUME_STEP (pin the
        # restore to the LKG step, NOT the newest checkpoint — newest
        # may carry the corruption) and, when the operator armed
        # bisection on a repeat trip, KFTPU_REPLAY_RANGE (the worker
        # re-runs the suspect steps deterministically and publishes a
        # clean/reproduced verdict span)
        rollback = k8s.annotations_of(manifest).get(
            ANOMALY_ROLLBACK_ANNOTATION)
        if rollback:
            from ..runtime.sentinel import (REPLAY_RANGE_ENV,
                                            RESUME_STEP_ENV)
            try:
                directive = json.loads(rollback)
                lkg_step = int(directive.get("lkgStep", 0))
                replay_range = directive.get("replay")
            except (AttributeError, TypeError, ValueError):
                lkg_step, replay_range = 0, None
            if lkg_step > 0:
                env[RESUME_STEP_ENV] = str(lkg_step)
            if replay_range:
                env[REPLAY_RANGE_ENV] = str(replay_range)
        from ..runtime.compile_cache import (COMPILE_CACHE_ENV,
                                             SHARED_CACHE_ROOT_ENV,
                                             default_cache_dir,
                                             namespace_cache_dir)
        # cache-dir precedence: an explicit spec.compileCacheDir wins;
        # then the CLUSTER-SHARED compile-cache service (the operator
        # deployment carries KFTPU_SHARED_CACHE_ROOT, backed by a
        # shared cache volume — every gang of a namespace shares one
        # kernel build cache, so the first job to build warms every
        # later job/rebind/resize, not just its own pod restarts); then
        # the per-job default on the checkpoint volume
        shared_root = os.environ.get(SHARED_CACHE_ROOT_ENV, "")
        cache_dir = job.compile_cache_dir or (
            namespace_cache_dir(shared_root, job.namespace)
            if shared_root else "") or (
            default_cache_dir(job.checkpoint_dir)
            if job.checkpoint_dir else "")
        if cache_dir:
            # the persistent kernel build cache on the checkpoint volume:
            # a restarted gang loads its kernels instead of running nvcc
            # (runtime/compile_cache.py)
            env[COMPILE_CACHE_ENV] = cache_dir
        # spec.warmStart → KFTPU_AOT / KFTPU_AOT_DIR: the serialized-
        # executable rung above the cache (runtime/aot.py). With AOT on
        # but no explicit dir, executables live beside the active cache
        # so a shared cache volume shares them across jobs too.
        env.update(job.warm_start.to_env())
        if job.warm_start.aot and not job.warm_start.aot_dir \
                and cache_dir:
            from ..runtime.aot import AOT_DIR_ENV, default_aot_dir
            volume = job.compile_cache_dir or (
                namespace_cache_dir(shared_root, job.namespace)
                if shared_root else job.checkpoint_dir)
            env.setdefault(AOT_DIR_ENV, default_aot_dir(volume))
        if env:
            self._add_env(pod, env)
        return pod

    def _add_env(self, pod: dict, env: dict[str, str]) -> None:
        for c in pod["spec"]["containers"]:
            cenv = c.setdefault("env", [])
            present = {e.get("name") for e in cenv}
            for k, v in env.items():
                if k not in present:
                    cenv.append({"name": k, "value": v})

    def _build_gpu_pod(self, job: TrainingJob, manifest: dict,
                       rs: ReplicaSpec, contract: TopologyContract,
                       name: str, rect: SliceRect | None = None,
                       node: str = "") -> dict:
        pod = self._base_pod(job, manifest, rs, name, "GPU",
                             str(contract.process_id))
        spec = pod["spec"]
        # GPU placement: the product label GPU feature discovery puts on
        # the node, and one GPU of it — one pod a GPU, as the worker's
        # bootstrap drives one card a rank
        sel = spec.setdefault("nodeSelector", {})
        sel.setdefault(GPU_PRODUCT_LABEL,
                       contract.slice_topology.generation.product)
        if rect is not None:
            # slice-scheduler binding: pin to the ASSIGNED pool and, since
            # one slice is one node, to the node of the binding's row;
            # the run rides along as a pod annotation for operators and
            # debuggers reading kubectl
            sel.setdefault(POOL_LABEL, rect.pool)
            if node:
                sel.setdefault(HOSTNAME_LABEL, node)
            pod["metadata"]["annotations"][SLICE_ANNOTATION] = \
                json.dumps(rect.to_dict())
        for c in spec["containers"]:
            res = c.setdefault("resources", {})
            res.setdefault("limits", {})[GPU_RESOURCE] = 1
        # gang group: one group per job covering every slice of the replica
        group = f"{job.namespace}/{job.name}"
        pod["metadata"]["labels"][POD_GROUP_LABEL] = group.replace("/", ".")
        pod["metadata"]["annotations"]["scheduling.kubeflow.org/min-member"] = \
            str(rs.pod_count)
        env = contract.to_env()
        env["KFTPU_SHARDING"] = json.dumps(job.sharding.resolve(
            contract.num_devices))
        env["KFTPU_JOB_NAME"] = job.name
        env["KFTPU_JOB_KIND"] = job.kind
        env.update(self._torch_env(contract))
        self._add_env(pod, env)
        if job.kind in ("MPIJob", "ChainerJob"):
            self._add_env(pod, self._mpi_env(job))
        return pod

    @staticmethod
    def _torch_env(contract: TopologyContract) -> dict:
        """The torch.distributed env of the same contract, under the names
        the PyTorchJob contract renders (``_pytorch_env``): the rendezvous
        is the coordinator, the rank the process id, the world the
        process count. No LOCAL_RANK: each pod sees one GPU."""
        host, port = contract.coordinator_address.rsplit(":", 1)
        return {"MASTER_ADDR": host, "MASTER_PORT": port,
                "RANK": str(contract.process_id),
                "WORLD_SIZE": str(contract.num_processes)}

    def _build_replica_pod(self, job: TrainingJob, manifest: dict,
                           rs: ReplicaSpec, rtype: str, index: int,
                           name: str) -> dict:
        pod = self._base_pod(job, manifest, rs, name, rtype, str(index))
        if job.kind == "TFJob":
            self._add_env(pod, {"TF_CONFIG": json.dumps(
                self._tf_config(job, rtype, index))})
        elif job.kind == "PyTorchJob":
            self._add_env(pod, self._pytorch_env(job, rtype, index))
        elif job.kind in ("MPIJob", "ChainerJob"):
            # ChainerMN drives workers over MPI (chainer-operator.libsonnet
            # renders an mpiexec hostfile); same hostlist contract
            self._add_env(pod, self._mpi_env(job))
        elif job.kind == "MXJob":
            self._add_env(pod, self._mxnet_env(job, rtype, index))
        elif job.kind == "PaddleJob":
            self._add_env(pod, self._paddle_env(job, rtype, index))
        return pod

    # ---------------------------------------------------- legacy contracts

    def _addr(self, job: TrainingJob, pod_name: str, port: int = DEFAULT_PORT) -> str:
        return f"{pod_name}.{_workers_service_name(job)}.{job.namespace}:{port}"

    def _tf_config(self, job: TrainingJob, rtype: str, index: int) -> dict:
        """TF_CONFIG rendered the way tf-operator does (launcher.py:68-88
        consumes exactly this shape)."""
        cluster: dict[str, list[str]] = {}
        for t, rs in job.replica_specs.items():
            if t == "GPU":
                cluster["worker"] = [
                    self._addr(job, _gpu_pod_name(job, s, g))
                    for s in range(rs.num_slices)
                    for g in range(rs.topology.pods_per_slice)]
            else:
                cluster[t.lower()] = [
                    self._addr(job, _replica_pod_name(job, t, i))
                    for i in range(rs.replicas)]
        return {"cluster": cluster,
                "task": {"type": rtype.lower(), "index": index}}

    def _pytorch_env(self, job: TrainingJob, rtype: str, index: int) -> dict:
        master = _replica_pod_name(job, "Master", 0)
        world = job.total_pods()
        rank = 0 if rtype == "Master" else index + 1
        return {"MASTER_ADDR": f"{master}.{_workers_service_name(job)}.{job.namespace}",
                "MASTER_PORT": str(DEFAULT_PORT),
                "RANK": str(rank), "WORLD_SIZE": str(world)}

    def _mpi_env(self, job: TrainingJob) -> dict:
        """Hostlist env replacing the reference's kubectl-delivery hostfile
        (mpi-operator.libsonnet:116-135). Hosts come from the JOB's compute
        replicas — GPU gang if present, else Worker — the same list on
        every pod (launcher/master included)."""
        gpu = job.gpu_spec
        if gpu is not None and gpu.topology is not None:
            hosts = [_gpu_pod_name(job, s, g)
                     for s in range(gpu.num_slices)
                     for g in range(gpu.topology.pods_per_slice)]
        else:
            worker = job.replica_specs.get("Worker")
            hosts = [_replica_pod_name(job, "Worker", i)
                     for i in range(worker.replicas)] if worker else []
        fqdn = [f"{h}.{_workers_service_name(job)}.{job.namespace}" for h in hosts]
        return {"KFTPU_MPI_HOSTS": ",".join(fqdn),
                "KFTPU_MPI_NUM_HOSTS": str(len(fqdn))}

    def _mxnet_env(self, job: TrainingJob, rtype: str, index: int) -> dict:
        """DMLC env the way mxnet-operator renders it
        (mxnet-operator.libsonnet): one Scheduler roots the PS tracker."""
        scheduler = _replica_pod_name(job, "Scheduler", 0)
        counts = {t: rs.replicas for t, rs in job.replica_specs.items()}
        return {
            "DMLC_PS_ROOT_URI":
                f"{scheduler}.{_workers_service_name(job)}.{job.namespace}",
            "DMLC_PS_ROOT_PORT": str(DEFAULT_PORT),
            "DMLC_ROLE": rtype.lower(),
            "DMLC_NUM_SERVER": str(counts.get("Server", 0)),
            "DMLC_NUM_WORKER": str(counts.get("Worker", 0)),
        }

    def _paddle_env(self, job: TrainingJob, rtype: str, index: int) -> dict:
        """PADDLE_* env the way paddle-operator renders it
        (kubeflow/paddle-job/*.libsonnet): pserver endpoints + trainer id."""
        pservers = job.replica_specs.get("Pserver")
        endpoints = [
            self._addr(job, _replica_pod_name(job, "Pserver", i))
            for i in range(pservers.replicas)] if pservers else []
        trainers = job.replica_specs.get("Trainer")
        env = {
            "PADDLE_PSERVERS": ",".join(endpoints),
            "PADDLE_PSERVER_PORT": str(DEFAULT_PORT),
            "PADDLE_TRAINERS": str(trainers.replicas if trainers else 0),
            "PADDLE_TRAINING_ROLE":
                "PSERVER" if rtype == "Pserver" else "TRAINER",
        }
        if rtype == "Trainer":
            env["PADDLE_TRAINER_ID"] = str(index)
        return env

    # ------------------------------------------------------------- failure

    def _chief_pod_name(self, job: TrainingJob) -> str:
        # MXNet's Scheduler and Paddle's Pserver run until shutdown; job
        # completion is signaled by the first worker/trainer (the operator
        # semantics of mxnet-operator/paddle-operator)
        preferred = {"MXJob": ("Worker",),
                     "PaddleJob": ("Trainer",)}.get(job.kind, ())
        for t in (*preferred, "Chief", "Master", "Launcher", "Coordinator"):
            if t in job.replica_specs:
                return _replica_pod_name(job, t, 0)
        if job.gpu_spec is not None:
            return _gpu_pod_name(job, 0, 0)
        first = sorted(job.replica_specs)[0]
        return _replica_pod_name(job, first, 0)

    def _deadline_remaining(self, job: TrainingJob,
                            manifest: dict) -> float | None:
        """Seconds until activeDeadlineSeconds lands (negative = already
        over), or None when no deadline applies / the job never started."""
        deadline = job.run_policy.active_deadline_seconds
        if deadline is None:
            return None
        created = k8s.get_condition(manifest, COND_CREATED)
        if not created or created.get("status") != "True":
            return None
        try:
            started = float(created.get("lastTransitionTime") or 0)
        except (TypeError, ValueError):
            return None
        if not started:
            return None
        return started + deadline - _now()

    def _restart_backoff_remaining(self, manifest: dict) -> float:
        nb = k8s.annotations_of(manifest).get(RESTART_NOT_BEFORE_ANNOTATION)
        try:
            return float(nb) - _now() if nb else 0.0
        except (TypeError, ValueError):
            return 0.0

    @staticmethod
    def _beat_of(pod: dict | None) -> tuple[float, int] | None:
        """The pod's heartbeat (time, step), or None when absent or
        malformed — a bad annotation must degrade to "no heartbeat",
        never crash the reconcile loop."""
        if pod is None:
            return None
        raw = k8s.annotations_of(pod).get(HEARTBEAT_ANNOTATION)
        if not raw:
            return None
        try:
            d = json.loads(raw)
            beat = float(d.get("time", 0))
            step = int(d.get("step", 0))
        except (AttributeError, TypeError, ValueError):
            # AttributeError: valid JSON that isn't an object ("3",
            # "null")
            return None
        return (beat, step) if beat else None

    def _beat_age(self, namespace: str, pod_name: str, beat: float,
                  now: float) -> float:
        """Heartbeat staleness with the clock-skew clamp. A beat
        stamped in the FUTURE (worker clock ahead of the controller's)
        is clamped to the moment we first observed that value — without
        the clamp a hung worker with, say, an hour of skew reads as
        infinitely fresh for an hour and the stall watchdog never fires
        on time. A fresh (changing) beat clears the clamp state. The
        first-seen map is in-memory: a controller restart re-clamps a
        still-future beat to the restart time, delaying detection by at
        most one stall timeout — the safe direction."""
        key = (namespace, pod_name)
        if beat <= now:
            self._future_beats.pop(key, None)
            return now - beat
        seen = self._future_beats.get(key)
        if seen is None or seen[0] != beat:
            self._future_beats[key] = (beat, now)
            return 0.0
        return now - seen[1]

    def _stalled_chief(self, job: TrainingJob, manifest: dict,
                       by_name: dict[str, dict], chief: str) -> bool:
        """Whether the chief's heartbeat annotation is staler than
        runPolicy.stallTimeoutSeconds. A pod with NO heartbeat is never
        declared stalled (non-instrumented images must keep working)."""
        timeout = job.run_policy.stall_timeout_seconds
        if not timeout or k8s.condition_true(manifest, COND_RESTARTING):
            return False
        pod = by_name.get(chief)
        if pod is None or \
                pod.get("status", {}).get("phase") != POD_RUNNING:
            return False
        beat = self._beat_of(pod)
        if beat is None:
            return False
        return self._beat_age(job.namespace, chief, beat[0],
                              _now()) > timeout

    def _stalled_workers(self, job: TrainingJob, manifest: dict,
                         by_name: dict[str, dict],
                         gpu_names: list[str], chief: str) -> list[str]:
        """Per-worker stall: Running non-chief members whose heartbeat
        is staler than stallTimeoutSeconds. Catches the straggler
        failure mode the chief-only watchdog is blind to — one wedged
        worker, healthy chief (the chief keeps beating while the
        collective stalls inside the step). Same contract as the chief
        watchdog: no heartbeat, no verdict."""
        timeout = job.run_policy.stall_timeout_seconds
        if not timeout or k8s.condition_true(manifest, COND_RESTARTING):
            return []
        now = _now()
        stalled = []
        for name in gpu_names:
            if name == chief:
                continue
            pod = by_name.get(name)
            if pod is None or \
                    pod.get("status", {}).get("phase") != POD_RUNNING:
                continue
            beat = self._beat_of(pod)
            if beat is None:
                continue
            if self._beat_age(job.namespace, name, beat[0], now) > timeout:
                stalled.append(name)
        return stalled

    def _note_step_skew(self, job: TrainingJob, by_name: dict[str, dict],
                        gpu_names: list[str], chief: str,
                        client: KubeClient) -> None:
        """Straggler scoring from per-worker heartbeat steps: a worker
        whose FRESH heartbeat trails the chief's step by
        health.STEP_SKEW_MIN_STEPS on STEP_SKEW_STREAK consecutive
        reconciles folds one step-skew event into its host's health
        score (scheduler/health.py) — soft evidence that accumulates
        toward quarantine without tearing anything down. The max skew
        is exported as a gauge so dashboards see the straggler before
        the score moves."""
        now = _now()
        # freshness bound: the stall timeout when the job runs a
        # watchdog, the shared default otherwise — a STALE beat is a
        # hung worker (the watchdogs' business), not a slow host
        fresh_s = job.run_policy.stall_timeout_seconds or \
            health.STEP_SKEW_FRESH_S
        chief_beat = self._beat_of(by_name.get(chief))
        if chief_beat is None or \
                self._beat_age(job.namespace, chief,
                               chief_beat[0], now) > fresh_s:
            return
        max_skew = 0
        for name in gpu_names:
            if name == chief:
                continue
            key = (job.namespace, job.name, name)
            beat = self._beat_of(by_name.get(name))
            fresh = beat is not None and self._beat_age(
                job.namespace, name, beat[0], now) <= fresh_s
            skew = (chief_beat[1] - beat[1]) if fresh else 0
            if not fresh or skew < health.STEP_SKEW_MIN_STEPS:
                self._skew_streak.pop(key, None)
                continue
            max_skew = max(max_skew, skew)
            streak = self._skew_streak.get(key, 0) + 1
            if streak >= health.STEP_SKEW_STREAK:
                self._skew_streak[key] = 0
                node = by_name[name].get("spec", {}).get("nodeName")
                if node:
                    health.record_host_event(
                        client, node, health.EVENT_STEP_SKEW,
                        job_key=f"{job.namespace}/{job.name}")
            else:
                self._skew_streak[key] = streak
        obsreg.gauge(
            "kftpu_job_step_skew",
            "chief step minus the slowest worker's heartbeat step",
            labels=("namespace", "name")).labels(
                namespace=job.namespace, name=job.name).set(max_skew)

    @staticmethod
    def _suspect_node(by_name: dict[str, dict],
                      pod_names: list[str]) -> str | None:
        """The single host a failure is attributable to: every failed/
        stalled pod ran on the same node. Multi-host failures (a whole
        pool losing power, a fleet preemption) attribute to nobody —
        migrating off one host would not help."""
        nodes = {by_name[n].get("spec", {}).get("nodeName")
                 for n in pod_names if n in by_name}
        nodes.discard(None)
        nodes.discard("")
        return nodes.pop() if len(nodes) == 1 else None

    # ------------------------------------------------- numeric integrity

    @staticmethod
    def _anomaly_of(by_name: dict[str, dict], failed: list[str]):
        """(pod_name, AnomalyEvidence) from the first failed pod carrying
        a parseable sentinel evidence annotation, else (None, None).
        Evidence is on the POD (the worker annotates itself before
        exiting) so it survives the worker process and arrives with the
        same Failed phase the reconcile loop already watches."""
        from ..runtime.sentinel import AnomalyEvidence
        for name in failed:
            pod = by_name.get(name)
            if pod is None:
                continue
            raw = k8s.annotations_of(pod).get(ANOMALY_ANNOTATION)
            if not raw:
                continue
            ev = AnomalyEvidence.from_json(raw)
            if ev is not None:
                return name, ev
        return None, None

    def _handle_anomaly(self, client: KubeClient, job: TrainingJob,
                        manifest: dict, pods: list[dict],
                        failed: list[str], anomaly,
                        suspect: str | None = None) -> Result:
        """The LKG rollback path. A sentinel trip is a DELIBERATE exit,
        not a crash: the rollback budget (runPolicy.maxAnomalyRollbacks)
        is separate from backoffLimit and the gang restart does not
        count against it. The rollback directive annotation pins the
        recreated gang's restore to the last-known-good step (not the
        newest checkpoint, which may carry the corruption), and a SECOND
        trip over the same LKG arms the replay-bisection window — the
        worker re-runs the suspect step range deterministically with the
        suspect host's health event already folded, converting "this job
        is cursed" into "host N is bad"."""
        anns = k8s.annotations_of(manifest)
        count = int(anns.get(ANOMALY_COUNT_ANNOTATION, "0"))
        budget = job.run_policy.max_anomaly_rollbacks
        summary = (f"{anomaly.kind} at step {anomaly.step} "
                   f"(lkg {anomaly.lkg})")
        if count >= budget:
            self._set_condition(
                client, manifest, COND_FAILED, "True",
                "AnomalyBudgetExceeded",
                f"numeric anomaly {summary}; rolled back {count} times "
                f"(runPolicy.maxAnomalyRollbacks={budget})")
            self._cleanup_pods(client, job, pods)
            return Result()
        # replay bisection arms on the SECOND trip against the same LKG:
        # same range re-failing means the fault reproduces — re-run it
        # deterministically and let the verdict blame (or clear) the host
        prev_lkg = None
        try:
            prev = json.loads(anns.get(ANOMALY_ROLLBACK_ANNOTATION) or "")
            prev_lkg = int(prev.get("lkgStep"))
        except (AttributeError, TypeError, ValueError):
            prev_lkg = None
        lkg = int(anomaly.lkg or 0)
        replay = (f"{lkg}:{int(anomaly.step)}"
                  if prev_lkg is not None and prev_lkg == lkg
                  and int(anomaly.step) > lkg else None)
        for p in pods:
            try:
                client.delete("v1", "Pod", k8s.namespace_of(p, job.namespace),
                              k8s.name_of(p))
            except NotFoundError:
                pass
        applied = {"count": count}

        def _mutate(obj: dict) -> dict | None:
            fresh = int(k8s.annotations_of(obj).get(
                ANOMALY_COUNT_ANNOTATION, "0"))
            applied["count"] = fresh
            directive: dict = {"lkgStep": lkg,
                               "tripStep": int(anomaly.step),
                               "kind": anomaly.kind,
                               "count": fresh + 1}
            if replay:
                directive["replay"] = replay
            updates = {ANOMALY_COUNT_ANNOTATION: str(fresh + 1),
                       ANOMALY_ROLLBACK_ANNOTATION: json.dumps(directive)}
            if suspect and job.scheduling_policy is not None:
                # same failure-domain contract as crash restarts: the
                # scheduler replans the rebind excluding the SDC suspect
                updates[SUSPECT_ANNOTATION] = suspect
            apply_annotations(obj, updates)
            if job.checkpoint_dir and \
                    not obj.setdefault("spec", {}).get("resumeFrom"):
                obj["spec"]["resumeFrom"] = job.checkpoint_dir
            return obj

        try:
            patched = update_with_conflict_retry(
                client, *k8s.key_of(manifest), _mutate)
        except NotFoundError:
            return Result()
        if suspect:
            # SDC evidence onto the host the anomalous worker ran on:
            # two trips cross health's quarantine threshold, so a
            # repeat-offender host drains out of the placement pool
            health.record_host_event(
                client, suspect, health.EVENT_NUMERIC_ANOMALY,
                job_key=f"{job.namespace}/{job.name}", now=_now())
        obsreg.counter(
            "kftpu_gang_restarts_total",
            "whole-gang restarts by trigger (failed pod, vanish, resize, "
            "stall)", labels=("kind", "reason")).labels(
                kind=self.kind, reason="NumericAnomaly").inc()
        used = applied["count"] + 1
        mode = f", replaying {replay} for bisection" if replay else ""
        self._trace_event(patched, "anomaly-rollback", kind=anomaly.kind,
                          step=int(anomaly.step), lkg=lkg, count=used,
                          **({"replay": replay} if replay else {}),
                          **({"suspect": suspect} if suspect else {}))
        self._set_condition(
            client, patched, COND_RESTARTING, "True", "NumericAnomaly",
            f"{summary}: rolling back to LKG step {lkg} "
            f"({used}/{budget} rollbacks){mode}")
        return Result(requeue=True)

    def _clear_rollback_annotation(self, client: KubeClient,
                                   job: TrainingJob, manifest: dict,
                                   by_name: dict[str, dict],
                                   chief: str) -> None:
        """Consume the rollback directive once the chief's FRESH
        heartbeat shows training advanced past the trip step — the
        suspect range re-ran clean, so future restarts must resume from
        the newest checkpoint, not stay pinned to the old LKG."""
        raw = k8s.annotations_of(manifest).get(ANOMALY_ROLLBACK_ANNOTATION)
        if not raw:
            return
        try:
            trip = int(json.loads(raw).get("tripStep", 0))
        except (AttributeError, TypeError, ValueError):
            trip = 0
        beat = self._beat_of(by_name.get(chief))
        if beat is None:
            return
        fresh_s = job.run_policy.stall_timeout_seconds or \
            health.STEP_SKEW_FRESH_S
        if self._beat_age(job.namespace, chief, beat[0], _now()) > fresh_s \
                or beat[1] <= trip:
            return
        try:
            update_with_conflict_retry(
                client, *k8s.key_of(manifest),
                lambda obj: apply_annotations(
                    obj, {ANOMALY_ROLLBACK_ANNOTATION: None})
                if ANOMALY_ROLLBACK_ANNOTATION in k8s.annotations_of(obj)
                else None)
        except NotFoundError:
            pass

    def _note_numeric_health(self, job: TrainingJob,
                             by_name: dict[str, dict],
                             gpu_names: list[str],
                             client: KubeClient) -> None:
        """The heartbeat numeric canary: a worker whose FRESH heartbeat
        reports a non-finite lastLoss/lastGradNorm gets flagged (host
        health event + anomaly counter) even when spec.integrity is
        disabled — the payload rides the liveness beat for free, so
        non-instrumented detection costs nothing extra. Freshness is
        clamped the same way the stall watchdog's is: a stale or
        future-stamped beat is not evidence."""
        now = _now()
        fresh_s = job.run_policy.stall_timeout_seconds or \
            health.STEP_SKEW_FRESH_S
        for name in gpu_names:
            pod = by_name.get(name)
            if pod is None:
                continue
            raw = k8s.annotations_of(pod).get(HEARTBEAT_ANNOTATION)
            if not raw:
                continue
            try:
                d = json.loads(raw)
                beat = float(d.get("time", 0))
                step = int(d.get("step", 0))
            except (AttributeError, TypeError, ValueError):
                continue
            if not beat or self._beat_age(job.namespace, name,
                                          beat, now) > fresh_s:
                continue
            bad = None
            for field in ("lastLoss", "lastGradNorm"):
                v = d.get(field)
                if v is None:
                    continue
                try:
                    val = float(v)
                except (TypeError, ValueError):
                    continue
                if not math.isfinite(val):
                    bad = (field, v)
                    break
            key = (job.namespace, name)
            if bad is None:
                continue
            if self._numeric_flagged.get(key) == step:
                continue
            self._numeric_flagged[key] = step
            log.warning("pod %s/%s heartbeat reports non-finite %s=%s "
                        "at step %d", job.namespace, name, bad[0], bad[1],
                        step)
            from ..runtime.sentinel import KIND_HEARTBEAT_NAN, \
                anomaly_counter
            anomaly_counter().labels(kind=KIND_HEARTBEAT_NAN).inc()
            node = pod.get("spec", {}).get("nodeName")
            if node:
                health.record_host_event(
                    client, node, health.EVENT_NUMERIC_ANOMALY,
                    job_key=f"{job.namespace}/{job.name}", now=now)

    def _handle_gang_failure(self, client: KubeClient, job: TrainingJob,
                             manifest: dict, pods: list[dict],
                             failed: list[str],
                             reason: str = "GangRestart",
                             count_restart: bool = True,
                             suspect: str | None = None,
                             evidence: str | None = None) -> Result:
        restarts = int(k8s.annotations_of(manifest).get(
            RESTART_COUNT_ANNOTATION, "0"))
        if count_restart and restarts >= job.run_policy.backoff_limit:
            self._set_condition(
                client, manifest, COND_FAILED, "True", "BackoffLimitExceeded",
                f"pods {failed} failed; gang restarted {restarts} times")
            self._cleanup_pods(client, job, pods)
            return Result()
        # Gang restart: delete every pod of the job (the slice is the failure
        # domain), bump the restart counter, requeue to recreate.
        for p in pods:
            try:
                client.delete("v1", "Pod", k8s.namespace_of(p, job.namespace),
                              k8s.name_of(p))
            except NotFoundError:
                pass
        rp = job.run_policy
        # mutable cell: the RMW below recomputes restarts/delay from the
        # FRESH object each attempt, and the tail of this method needs
        # the values the WINNING attempt actually wrote
        applied = {"restarts": restarts, "delay": 0.0}

        def _mutate(obj: dict) -> dict | None:
            # recompute from the fresh read: a concurrent writer (the
            # scheduler's binding/state rewrites, a sibling operator
            # replica in a brief two-leader window) may have landed
            # between our reconcile-start read and this write — the
            # blind patch this replaces silently double-counted or lost
            # the restart counter in exactly that interleaving
            fresh_restarts = int(k8s.annotations_of(obj).get(
                RESTART_COUNT_ANNOTATION, "0"))
            applied["restarts"] = fresh_restarts
            updates: dict = {}
            if count_restart:
                updates[RESTART_COUNT_ANNOTATION] = str(fresh_restarts + 1)
            if suspect and job.scheduling_policy is not None:
                # failure-domain-aware rebind: record the node this
                # teardown is attributable to; the scheduler replans the
                # binding EXCLUDING its cells (scheduler/core.py) so the
                # gang migrates instead of crash-looping in place
                updates[SUSPECT_ANNOTATION] = suspect
            applied["delay"] = 0.0
            if count_restart and rp.restart_backoff_seconds > 0:
                # exponential backoff + deterministic jitter (seeded by
                # job identity and attempt, so reconcile retries compute
                # the same schedule): spreads a fleet-wide preemption's
                # restarts out instead of stampeding the apiserver
                d = min(rp.restart_backoff_seconds * (2 ** fresh_restarts),
                        rp.restart_backoff_max_seconds)
                d *= random.Random(
                    f"{job.namespace}/{job.name}:"
                    f"{fresh_restarts}").uniform(1.0, 1.5)
                applied["delay"] = d
                updates[RESTART_NOT_BEFORE_ANNOTATION] = \
                    f"{_now() + d:.3f}"
            dirty = bool(updates)
            apply_annotations(obj, updates)
            if job.checkpoint_dir and \
                    not obj.setdefault("spec", {}).get("resumeFrom"):
                # close the resume loop: the recreated gang restores from
                # the job's own checkpoints and continues from the last
                # step (SURVEY §5 — checkpoint-resume makes gang
                # restarts cheap)
                obj["spec"]["resumeFrom"] = job.checkpoint_dir
                dirty = True
            return obj if dirty else None

        try:
            patched = update_with_conflict_retry(
                client, *k8s.key_of(manifest), _mutate)
        except NotFoundError:
            return Result()   # job deleted mid-teardown: nothing to restart
        restarts, delay = applied["restarts"], applied["delay"]
        if suspect and evidence:
            # fold the failure into the host's health score (the
            # quarantine feedback loop); best-effort by contract —
            # evidence must never block the restart itself
            health.record_host_event(client, suspect, evidence,
                                     job_key=f"{job.namespace}/{job.name}",
                                     now=_now())
        # counted AFTER the deletes/patch succeeded: a transient error in
        # the side effects above requeues and re-runs this path, and the
        # retry must not read as a second restart
        obsreg.counter(
            "kftpu_gang_restarts_total",
            "whole-gang restarts by trigger (failed pod, vanish, resize, "
            "stall)", labels=("kind", "reason")).labels(
                kind=self.kind, reason=reason).inc()
        budget = (f" ({restarts + 1}/{job.run_policy.backoff_limit})"
                  if count_restart else " (not counted against backoff)")
        wait = f", next attempt in {delay:.1f}s" if delay else ""
        self._set_condition(
            client, patched, COND_RESTARTING, "True", reason,
            f"pods {failed}: restarting whole gang{budget}{wait}")
        return Result(requeue_after=delay) if delay else Result(requeue=True)

    def _handle_finished(self, client: KubeClient, job: TrainingJob,
                         manifest: dict) -> Result:
        """ttlSecondsAfterFinished: reap the finished job object (and its
        children via cascade) once the TTL passes — measured from the
        terminal condition's transition time."""
        ttl = job.run_policy.ttl_seconds_after_finished
        if ttl is None:
            return Result()
        cond = k8s.get_condition(manifest, COND_SUCCEEDED)
        if not (cond and cond.get("status") == "True"):
            cond = k8s.get_condition(manifest, COND_FAILED)
        try:
            finished = float((cond or {}).get("lastTransitionTime") or 0)
        except (TypeError, ValueError):
            finished = 0.0
        if not finished:
            return Result()
        remaining = finished + ttl - _now()
        if remaining > 0:
            return Result(requeue_after=remaining)
        log.info("job %s/%s finished %ds ago (> ttl %ds): deleting",
                 job.namespace, job.name, int(_now() - finished), ttl)
        try:
            client.delete(*k8s.key_of(manifest))
        except NotFoundError:
            pass
        return Result()

    def _gc_orphans(self, client: KubeClient, namespace: str,
                    name: str) -> None:
        """Reap children whose owner job no longer exists. The job-name
        selector is the ownership scope (the same labels _base_pod
        stamps); everything matching it after the owner's deletion is
        an orphan pinning GPUs — delete it, count it."""
        selector = {"kubeflow.org/job-name": name,
                    "kubeflow.org/job-kind": self.kind.lower()}
        reaped = 0
        for kind_av in (("v1", "Pod"), ("v1", "Service")):
            for obj in client.list(*kind_av, namespace,
                                   selector=selector):
                try:
                    client.delete(*kind_av,
                                  k8s.namespace_of(obj, namespace),
                                  k8s.name_of(obj))
                    reaped += 1
                except NotFoundError:
                    pass
        if reaped:
            obsreg.counter(
                "kftpu_orphan_pods_gced_total",
                "orphaned gang children reaped after their owner job "
                "vanished (crash-consistency GC)",
                labels=("kind",)).labels(kind=self.kind).inc(reaped)
            log.info("gc: reaped %d orphaned children of %s/%s",
                     reaped, namespace, name)

    def _cleanup_pods(self, client: KubeClient, job: TrainingJob,
                      pods: list[dict]) -> None:
        """Reap pods per cleanPodPolicy: Running keeps terminal pods for
        debugging, All reaps everything, None keeps everything."""
        policy = job.run_policy.clean_pod_policy
        if policy == CLEAN_POD_NONE:
            return
        for p in pods:
            phase = p.get("status", {}).get("phase")
            if policy == CLEAN_POD_RUNNING and phase not in (POD_RUNNING, None,
                                                             "Pending"):
                continue
            if policy not in (CLEAN_POD_ALL, CLEAN_POD_RUNNING):
                continue
            try:
                client.delete("v1", "Pod", k8s.namespace_of(p, job.namespace),
                              k8s.name_of(p))
            except NotFoundError:
                pass

    # --------------------------------------------------------------- status

    def _set_condition(self, client: KubeClient, manifest: dict, ctype: str,
                       status: str, reason: str, message: str) -> None:
        fresh = client.get_or_none(*k8s.key_of(manifest)) or manifest
        existing = k8s.get_condition(fresh, ctype)
        if existing and existing.get("status") == status and \
                existing.get("reason") == reason and \
                existing.get("message") == message:
            manifest["status"] = fresh.get("status", {})
            return  # idempotent: no write, no MODIFIED event, no requeue loop
        k8s.set_condition(fresh, k8s.Condition(ctype, status, reason, message))
        client.update_status(fresh)
        manifest["status"] = fresh["status"]
        # observability rides the idempotence guard: a condition TRANSITION
        # is exactly one trace event (queued/created/running/succeeded/...)
        # and one metrics update — steady-state reconciles emit nothing
        self._trace_event(
            manifest,
            ctype.lower() if status == "True" else f"{ctype.lower()}-cleared",
            reason=reason, message=message)
        if status == "True" and ctype in (COND_SUCCEEDED, COND_FAILED):
            obsreg.counter(
                "kftpu_jobs_finished_total",
                "training jobs reaching a terminal condition",
                labels=("kind", "condition")).labels(
                    kind=self.kind, condition=ctype).inc()
            self._finalize_ledger(client, fresh)
        self._export_phase((k8s.namespace_of(manifest, "default"),
                            k8s.name_of(manifest)), manifest)

    def _finalize_ledger(self, client: KubeClient, manifest: dict) -> None:
        """On the terminal transition: fold the job's span stream into
        its final goodput ledger (obs/goodput.py) — stamped as the
        goodput annotation so the decomposition survives span-sink
        rotation, and exported as the kftpu_job_goodput_ratio /
        kftpu_job_badput_seconds_total gauges. Rides the _set_condition
        idempotence guard, so it runs exactly once per completion.
        Best-effort by contract: accounting must never fail the job it
        accounts for."""
        try:
            from ..obs.goodput import (GOODPUT_ANNOTATION,
                                       annotation_payload,
                                       export_job_ledger, ledger_for)
            span_path = os.environ.get(SPAN_PATH_ENV)
            trace_id = k8s.annotations_of(manifest).get(TRACE_ID_ANNOTATION)
            if not span_path or not trace_id:
                return
            ledger = ledger_for(span_path, trace_id)
            if not ledger["wallSeconds"]:
                return
            namespace = k8s.namespace_of(manifest, "default")
            name = k8s.name_of(manifest)
            export_job_ledger(namespace, name, ledger)
            # conflict-safe: the terminal transition window is busy
            # (scheduler state writes, TTL bookkeeping) — the final
            # ledger must neither lose nor clobber a concurrent write
            update_with_conflict_retry(
                client, *k8s.key_of(manifest),
                lambda obj: apply_annotations(obj, {
                    GOODPUT_ANNOTATION: annotation_payload(ledger)}))
            self._trace_event(manifest, "goodput-ledger",
                              goodput_ratio=ledger["goodputRatio"],
                              wall_seconds=ledger["wallSeconds"])
        except Exception as e:  # noqa: BLE001 — accounting is best-effort
            log.warning("final goodput ledger for %s failed: %s",
                        k8s.name_of(manifest), e)

    def _finalize_status(self, client: KubeClient, manifest: dict,
                         pods: list[dict], *, all_running: bool) -> None:
        """Steady-state status tail: the Running condition AND the
        replicaStatuses counts in ONE get+put per reconcile pass (the
        single-update-per-reconcile idiom — two sequential get+puts race
        with concurrent writers and double the apiserver traffic)."""
        counts: dict[str, dict[str, int]] = {}
        for p in pods:
            rtype = k8s.labels_of(p).get(REPLICA_TYPE_LABEL, "unknown")
            phase = p.get("status", {}).get("phase", "Pending")
            bucket = {"Running": "active", "Pending": "active",
                      "Succeeded": "succeeded", "Failed": "failed"}.get(
                          phase, "active")
            counts.setdefault(rtype, {"active": 0, "succeeded": 0,
                                      "failed": 0})[bucket] += 1
        fresh = client.get_or_none(*k8s.key_of(manifest))
        if fresh is None:
            return
        dirty = False
        if all_running:
            existing = k8s.get_condition(fresh, COND_RUNNING)
            if not (existing and existing.get("status") == "True" and
                    existing.get("reason") == "JobRunning"):
                k8s.set_condition(fresh, k8s.Condition(
                    COND_RUNNING, "True", "JobRunning",
                    "all replicas running"))
                dirty = True
                # the Running TRANSITION (guarded above) is the
                # pod-start→running edge of the job's trace timeline
                self._trace_event(fresh, "running", reason="JobRunning")
                self._export_phase((k8s.namespace_of(fresh, "default"),
                                    k8s.name_of(fresh)), fresh)
        if fresh.get("status", {}).get("replicaStatuses") != counts:
            fresh.setdefault("status", {})["replicaStatuses"] = counts
            dirty = True
        if dirty:
            client.update_status(fresh)
        manifest["status"] = fresh.get("status", {})


def all_reconcilers() -> list[TrainingJobReconciler]:
    return [TrainingJobReconciler(k) for k in JOB_KINDS]
