"""Priority queues with namespace quotas for the slice scheduler.

The port's copy of ``kubeflow_tpu/scheduler/queue.py``, reading the GPU
replica (``TrainingJob.gpu_spec``) where the JAX package reads the TPU
one. Every scheduler-managed job names a queue
(``spec.schedulingPolicy.queue``, default "default"); jobs are ordered by
(priority desc, submission order) — strict priority with FIFO ties — and
each queue may cap the GPUs a NAMESPACE can hold bound at once (the
multi-tenant fairness floor). Quota counts BOUND GPUs only: queued demand
is free. The policy's fields keep the JAX names (``minChips``,
``quotaChips``): on a GPU job a chip is a GPU.

Stdlib only; consumed by scheduler/core.py.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Optional

from ..api import k8s
from ..api.topology import GpuTopology, parse_topology
from ..api.trainingjob import (BINDING_ANNOTATION, DEFAULT_QUEUE,
                               RESIZE_HISTORY_ANNOTATION, TrainingJob)
from .health import HealthConfig
from .inventory import Placement


@dataclass
class QueueSpec:
    """One queue's policy: per-namespace bound-GPU quotas.

    ``quota_chips`` maps namespace → max GPUs bound at once; the "*" key
    is the default for namespaces not named; absent/None = unlimited.
    """

    name: str
    quota_chips: dict = field(default_factory=dict)

    def quota_for(self, namespace: str) -> Optional[int]:
        q = self.quota_chips.get(namespace, self.quota_chips.get("*"))
        return int(q) if q is not None else None


@dataclass
class SchedulerConfig:
    """The scheduler's whole policy surface (rendered as the
    tpu-scheduler ConfigMap by manifests/training.py, which the deployed
    scheduler reads back through ``from_dict``)."""

    queues: dict = field(default_factory=dict)   # name -> QueueSpec
    # backfill: once the head-of-line job is blocked, later jobs may
    # still bind — but never into the head's reserved region
    backfill: bool = True
    # preemption: a blocked higher-priority job may reclaim preemptible
    # lower-priority gangs (cheapest victims first)
    preemption: bool = True
    # strict priority ordering; off = pure submission order (FIFO)
    priority_order: bool = True
    # node-health policy (scheduler/health.py): decay half-life,
    # quarantine/release thresholds, and the enabled master switch for
    # the whole feedback loop (scoring, quarantine, suspect evacuation)
    health: HealthConfig = field(default_factory=HealthConfig)
    # elastic gang resizing (jobs carrying schedulingPolicy minChips/
    # maxChips): the master switch for every resize plan — shrink a
    # lower-priority gang to admit a blocked head, shrink a gang whose
    # node lost GPUs, grow into idle GPUs, migrate to defragment. Off =
    # elastic bounds are ignored and every gang keeps its fixed shape.
    elastic: bool = True
    # grow-to-fill: bound elastic gangs may expand into idle GPUs once
    # the queue has drained (each grow is a checkpointed gang restart)
    grow: bool = True
    # defragmentation: migrate a bound elastic gang when re-placing it
    # strictly enlarges the cluster's largest free aligned run
    defrag: bool = True
    # a gang is not grown/migrated again until this long after its last
    # resize (restart-storm hysteresis; shrinks are urgent and exempt)
    grow_cooldown_s: float = 300.0
    # warm-pod pool size: the scheduler keeps pre-initialized pods on up
    # to this many idle nodes (scheduler/warmpool.py) and prefers
    # placements that adopt them. 0 = no warm pool (the default: warm
    # pods hold GPUs idle-but-initialized, an explicit capacity trade).
    warm_pods: int = 0

    def queue(self, name: str) -> QueueSpec:
        return self.queues.get(name) or QueueSpec(name)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "SchedulerConfig":
        d = dict(d or {})
        queues = {}
        for name, spec in (d.get("queues") or {}).items():
            queues[name] = QueueSpec(
                name=name, quota_chips=dict((spec or {}).get(
                    "quotaChips", {})))
        return cls(queues=queues,
                   backfill=bool(d.get("backfill", True)),
                   preemption=bool(d.get("preemption", True)),
                   priority_order=bool(d.get("priorityOrder", True)),
                   health=HealthConfig.from_dict(d.get("health")),
                   elastic=bool(d.get("elastic", True)),
                   grow=bool(d.get("grow", True)),
                   defrag=bool(d.get("defrag", True)),
                   grow_cooldown_s=float(
                       d.get("growCooldownSeconds", 300.0)),
                   warm_pods=int(d.get("warmPods", 0)))


@dataclass
class JobRequest:
    """The scheduler's view of one gang: what it needs and where it sits
    in the order. ``seq`` is the FIFO tiebreaker (submission order) —
    any totally-ordered value; the k8s loop uses submission_seq()'s
    (creationTimestamp, uid-tail) tuple."""

    namespace: str
    name: str
    queue: str
    priority: int
    preemptible: bool
    topology: GpuTopology
    num_slices: int
    seq: object
    # elastic bounds (schedulingPolicy.minChips/maxChips): total-GPU
    # envelope the scheduler may resize this gang within; None = that
    # bound pins to the nominal shape (both None = fixed-shape job)
    min_chips: Optional[int] = None
    max_chips: Optional[int] = None
    # grow/defrag hysteresis: False while the job's last resize is
    # younger than the config cooldown (the k8s loop computes this from
    # the resize-history annotation)
    grow_ok: bool = True

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def chips(self) -> int:
        """NOMINAL gang size in GPUs (the spec shape) — quota and
        ordering use this; a resized gang's ACTUAL size lives on its
        Placement."""
        return self.topology.num_gpus * self.num_slices

    @property
    def elastic(self) -> bool:
        return self.min_chips is not None or self.max_chips is not None


def elastic_topologies(req: JobRequest) -> list[GpuTopology]:
    """Every slice topology an elastic gang may run at: its generation's
    supported slice sizes whose TOTAL (x num_slices) falls inside the
    [minChips, maxChips] envelope, LARGEST first. Empty for fixed-shape
    jobs. The nominal shape is always a member (admission pins the
    envelope around it)."""
    if not req.elastic:
        return []
    gen = req.topology.generation
    nominal = req.topology.num_gpus * req.num_slices
    lo = req.min_chips if req.min_chips is not None else nominal
    hi = req.max_chips if req.max_chips is not None else nominal
    out = []
    for c in sorted(gen.supported_gpu_counts, reverse=True):
        if lo <= c * req.num_slices <= hi:
            out.append(parse_topology(f"{gen.name}-{c}"))
    return out


def placement_slice_chips(placement: Placement) -> int:
    """Per-slice GPU count of a (possibly resized) placement."""
    return placement.slices[0].chips if placement.slices \
        else placement.chips


def resize_history(manifest: dict) -> list[dict]:
    """Parse the resize-history annotation; [] when absent/malformed (a
    corrupt history only costs the audit trail + grow hysteresis, never
    a pass)."""
    raw = k8s.annotations_of(manifest).get(RESIZE_HISTORY_ANNOTATION)
    if not raw:
        return []
    try:
        hist = json.loads(raw)
    except ValueError:
        return []
    return [h for h in hist if isinstance(h, dict)] \
        if isinstance(hist, list) else []


_UID_NUM = re.compile(r"(\d+)$")


def submission_seq(manifest: dict) -> tuple:
    """Stable submission order for a job manifest: (creationTimestamp,
    uid numeric tail). A real apiserver stamps creationTimestamp
    (RFC3339 — lexicographic == chronological); FakeCluster sets none
    but mints "uid-N" monotonically, so the numeric uid tail orders its
    jobs (parsed, not lexical — "uid-10" must follow "uid-9")."""
    meta = manifest.get("metadata", {})
    ts = str(meta.get("creationTimestamp", "") or "")
    m = _UID_NUM.search(str(meta.get("uid", "")))
    return (ts, int(m.group(1)) if m else 0)


def request_of(job: TrainingJob, manifest: dict) -> Optional[JobRequest]:
    """JobRequest for a scheduler-managed job with a GPU gang; None for
    jobs the scheduler does not own (no schedulingPolicy, or no GPU
    replica — CPU-only legacy kinds keep the legacy path)."""
    policy = job.scheduling_policy
    gpu = job.gpu_spec
    if policy is None or gpu is None or gpu.topology is None:
        return None
    return JobRequest(
        namespace=job.namespace, name=job.name,
        queue=policy.queue or DEFAULT_QUEUE,
        priority=policy.priority, preemptible=policy.preemptible,
        topology=gpu.topology, num_slices=gpu.num_slices,
        seq=submission_seq(manifest),
        min_chips=policy.min_chips, max_chips=policy.max_chips)


def binding_of(manifest: dict) -> Optional[Placement]:
    """Parse the binding annotation; None when absent or malformed (a
    corrupt binding reads as unbound — the scheduler re-places). THE one
    parse of the scheduling.kubeflow.org/binding wire contract: the
    operator's gate (controllers/tpujob.py) and the scheduler's pass
    (scheduler/core.py) both consume this + binding_matches, so the two
    sides of the annotation cannot drift."""
    raw = k8s.annotations_of(manifest).get(BINDING_ANNOTATION)
    if not raw:
        return None
    try:
        return Placement.from_dict(json.loads(raw))
    except (ValueError, KeyError, TypeError):
        return None


def binding_matches(placement: Placement, job: TrainingJob) -> bool:
    """Whether a persisted binding still describes a shape this job may
    RUN at. Fixed-shape jobs: exactly the spec shape — a spec reshaped
    under its binding reads as unbound on both sides. ELASTIC jobs
    (schedulingPolicy minChips/maxChips) additionally accept a
    scheduler-resized shape: same generation, same slice count, total
    GPUs inside the envelope — that binding is the resize plan the
    operator executes, not drift."""
    gpu = job.gpu_spec
    if gpu is None or gpu.topology is None:
        return False
    if placement.topology == gpu.topology.name \
            and placement.num_slices == gpu.num_slices:
        return True
    policy = job.scheduling_policy
    if policy is None or not policy.elastic \
            or placement.num_slices != gpu.num_slices:
        return False
    try:
        topo = parse_topology(placement.topology)
    except ValueError:
        return False
    if topo.generation.name != gpu.topology.generation.name:
        return False
    total = topo.num_gpus * placement.num_slices
    if placement.slices and placement.chips != total:
        return False   # rects disagree with the claimed topology
    lo, hi = policy.chip_bounds(gpu.topology.num_gpus * gpu.num_slices)
    return lo <= total <= hi


def ordered(requests: list[JobRequest],
            config: SchedulerConfig) -> list[JobRequest]:
    """The scheduling order: strict priority then submission order (and
    pure FIFO when priority_order is off). One merged order across
    queues: queues scope QUOTA and dashboards, not ordering."""
    if config.priority_order:
        return sorted(requests, key=lambda r: (-r.priority, r.seq, r.key))
    return sorted(requests, key=lambda r: (r.seq, r.key))


def bound_chips(bound: list, queue: str, namespace: str) -> int:
    """GPUs currently bound for (queue, namespace) — the quota meter.
    ``bound`` is [(JobRequest, Placement)]."""
    return sum(p.chips for r, p in bound
               if r.queue == queue and r.namespace == namespace)


def over_quota(req: JobRequest, bound: list,
               config: SchedulerConfig) -> bool:
    quota = config.queue(req.queue).quota_for(req.namespace)
    if quota is None:
        return False
    return bound_chips(bound, req.queue, req.namespace) + req.chips > quota
