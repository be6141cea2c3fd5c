"""Training packages: the job operator, legacy-kind CRDs and examples.

The port's copy of ``kubeflow_tpu/manifests/training.py``: the same
components under the same registry names, with the GPU replica where the
JAX package has its TPU one — ``GPU`` with ``gpuTopology: h100-N`` in the
CRD schemas' replica vocabulary and in the example job, the port's
``SchedulerConfig``/``HealthConfig`` rendered into the
``tpu-scheduler-config`` ConfigMap that ``scheduler/core.py``
``SliceScheduler`` reads, the Lease names of ``cluster/lease.py`` passed
to ``python -m kubeflow_tpu_torch.controllers --leader-elect``, and the
port's worker (``kubeflow_tpu_torch.runtime.worker``) in the example
job's command.

Reference packages: kubeflow/tf-training (tf-job-operator.libsonnet),
kubeflow/pytorch-job, kubeflow/mpi-job, kubeflow/examples/prototypes.
"""

from __future__ import annotations

from ..api import k8s
from ..obs.trace import SPAN_MAX_BYTES_ENV
from ..api.trainingjob import (KF_API_VERSION_V1BETA2,
                               TPU_API_VERSION)
from . import helpers as H
from .registry import register

VERSION = "v0.1.0"
# per-image pin the auto-update bot retags independently (image_update.py)
WORKER_VERSION = "v0.1.0"
IMG = "ghcr.io/kubeflow-tpu"

# Replica-count validation mirrored from the reference CRD schemas
# (tf-job-operator.libsonnet:14-46: Chief max 1, deliberately no pod-template
# validation per k8s#54579).
_REPLICA_SCHEMA = {
    "type": "object",
    "properties": {
        "replicas": {"type": "integer", "minimum": 1},
        "gpuTopology": {"type": "string", "pattern": r"^h100-\d+$"},
        "numSlices": {"type": "integer", "minimum": 1},
    },
}


def _job_schema(specs_key: str, max_one: list[str]) -> dict:
    props = {specs_key: {
        "type": "object",
        "properties": {
            t: ({**_REPLICA_SCHEMA,
                 "properties": {**_REPLICA_SCHEMA["properties"],
                                "replicas": {"type": "integer", "minimum": 1,
                                             "maximum": 1}}}
                if t in max_one else _REPLICA_SCHEMA)
            for t in ("GPU", "Chief", "Master", "Worker", "PS", "Launcher",
                      "Evaluator", "Coordinator", "Scheduler", "Server",
                      "Pserver", "Trainer")
        },
    },
        # step-engine knobs the operator renders into worker env
        # (tests/test_torch_manifests.py checks this schema names every
        # spec field the port's TrainingJob parses)
        "weightUpdate": {"type": "string",
                         "enum": ["replicated", "sharded"]},
        # input-pipeline knobs (api/trainingjob.py InputSpec → the
        # KFTPU_INPUT_WORKERS / KFTPU_DEVICE_PREFETCH worker env)
        "input": {"type": "object", "properties": {
            "workers": {"type": "integer", "minimum": 0},
            "devicePrefetch": {"type": "integer", "minimum": 0},
        }},
        # gang-scheduling knobs (api/trainingjob.py SchedulingPolicy →
        # the slice scheduler's queue/priority/preemptible; a job
        # carrying this block waits in Queued until the scheduler binds
        # it).
        # minChips/maxChips make the gang ELASTIC: the scheduler may
        # resize its binding inside the envelope at checkpoint
        # boundaries (shrink-to-survive/-admit, grow-to-fill, defrag —
        # docs/operations.md "Elastic resizing")
        "schedulingPolicy": {"type": "object", "properties": {
            "queue": {"type": "string"},
            "priority": {"type": "integer"},
            "preemptible": {"type": "boolean"},
            "minChips": {"type": "integer", "minimum": 1},
            "maxChips": {"type": "integer", "minimum": 1},
        }},
        # observability knobs (api/trainingjob.py ObsSpec → the worker's
        # KFTPU_SPAN_PATH span sink and KFTPU_OBS_METRICS_PORT /metrics
        # port)
        "observability": {"type": "object", "properties": {
            "spanPath": {"type": "string"},
            "metricsPort": {"type": "integer", "minimum": 0,
                            "maximum": 65535},
        }},
        # warm-start knobs (api/trainingjob.py WarmStartSpec → KFTPU_AOT
        # / KFTPU_AOT_DIR: the AOT serialized-executable rung above the
        # kernel build cache — runtime/aot.py)
        "warmStart": {"type": "object", "properties": {
            "aot": {"type": "boolean"},
            "aotDir": {"type": "string"},
        }},
        # multi-slice execution knobs (api/trainingjob.py MultisliceSpec
        # → KFTPU_MULTISLICE_PIPELINE / KFTPU_MULTISLICE_MICROBATCHES:
        # the MPMD pipeline-over-DCN path, one program per slice with
        # explicit activation transfers — parallel/multislice.py)
        "multislice": {"type": "object", "properties": {
            "pipeline": {"type": "boolean"},
            "microbatches": {"type": "integer", "minimum": 1},
        }},
        # kernel-tier knobs (api/trainingjob.py KernelSpec →
        # KFTPU_KERNEL_ATTENTION / KFTPU_KERNEL_OPTIMIZER /
        # KFTPU_KERNEL_SERVING: flash attention, the fused-Adam
        # update, int8 quantized serving — every set knob is baked into
        # the recipe fingerprint + AOT step key)
        "kernels": {"type": "object", "properties": {
            "attention": {"type": "string",
                          "enum": ["einsum", "flash", "ring"]},
            "optimizer": {"type": "string",
                          "enum": ["stock", "fused_adam"]},
            "serving": {"type": "string",
                        "enum": ["stock", "int8"]},
        }},
        # numeric-integrity sentinel knobs (api/trainingjob.py
        # IntegritySpec → KFTPU_INTEGRITY / _SPIKE_Z / _WINDOW /
        # _CHECK_EVERY: in-step NaN/Inf + loss-spike detection with LKG
        # rollback — runtime/sentinel.py; deliberately EXCLUDED from the
        # recipe fingerprint)
        "integrity": {"type": "object", "properties": {
            "enabled": {"type": "boolean"},
            "spikeZ": {"type": "number", "exclusiveMinimum": 0},
            "windowSteps": {"type": "integer", "minimum": 2},
            "checkEverySteps": {"type": "integer", "minimum": 1},
        }},
        # kernel build cache dir override (defaults to the namespace's
        # shared cache when the operator carries KFTPU_SHARED_CACHE_ROOT,
        # else the per-job default under the checkpoint volume)
        "compileCacheDir": {"type": "string"},
    }
    return {"type": "object",
            "properties": {"spec": {"type": "object", "properties": props}}}


def _operator_deployment(namespace: str, gang_scheduling: bool,
                         shared_cache_root: str = "",
                         span_max_bytes: int = 0,
                         replicas: int = 2,
                         leader_elect: bool = True) -> list[dict]:
    from ..cluster.lease import OPERATOR_LEASE
    sa = H.service_account("tpu-job-operator", namespace)
    role = H.cluster_role("tpu-job-operator", [
        {"apiGroups": ["tpu.kubeflow.org", "kubeflow.org"],
         "resources": ["*"], "verbs": ["*"]},
        {"apiGroups": [""],
         "resources": ["pods", "services", "events", "configmaps"],
         "verbs": ["*"]},
        # node-health evidence: the operator folds failure events into
        # the kubeflow.org/health node annotation (scheduler/health.py)
        {"apiGroups": [""], "resources": ["nodes"],
         "verbs": ["get", "list", "watch", "patch"]},
        # gang-scheduling RBAC, the kube-batch podgroups rule analog
        # (tf-job-operator.libsonnet:298-307)
        *([{"apiGroups": ["scheduling.kubeflow.org"],
            "resources": ["podgroups"], "verbs": ["*"]}]
          if gang_scheduling else []),
    ])
    binding = H.cluster_role_binding("tpu-job-operator", "tpu-job-operator",
                                     "tpu-job-operator", namespace)
    from .observability import METRICS_PORT, scrape_annotations
    args = ["--controller=trainingjobs",
            f"--metrics-port={METRICS_PORT}"]
    if gang_scheduling:
        args.append("--enable-gang-scheduling")
    extra: list[dict] = []
    if leader_elect:
        # HA replica set: every replica watches, exactly one (the lease
        # holder) writes — controllers/__main__.py gates on the lease
        # named here (cluster/lease.py; identity = the pod name)
        args += ["--leader-elect", f"--lease-name={OPERATOR_LEASE}",
                 f"--lease-namespace={namespace}"]
        # lease RBAC is NAMESPACED (the lease lives beside the
        # deployment), like the scheduler's warm-pool role
        extra = [
            H.role("tpu-job-operator-leases", namespace, [
                {"apiGroups": ["coordination.k8s.io"],
                 "resources": ["leases"],
                 "verbs": ["get", "list", "watch", "create", "update"]},
            ]),
            H.role_binding("tpu-job-operator-leases", namespace,
                           "tpu-job-operator-leases",
                           "tpu-job-operator", namespace),
        ]
    dep = H.deployment("tpu-job-operator", namespace,
                       f"{IMG}/tpu-job-operator:{VERSION}", args=args,
                       service_account="tpu-job-operator", port=8443,
                       replicas=replicas if leader_elect else 1,
                       pod_annotations=scrape_annotations(METRICS_PORT),
                       # shared compile-cache service: with the root set
                       # the operator points every gang of a namespace
                       # at <root>/<namespace> on the tpu-compile-cache
                       # volume (runtime/compile_cache.py); the span
                       # rotation cap bounds the shared JSONL sink on
                       # long-lived deployments (obs/trace.py — the
                       # operator forwards it into every worker)
                       env=({**({"KFTPU_SHARED_CACHE_ROOT":
                                 shared_cache_root}
                                if shared_cache_root else {}),
                             **({SPAN_MAX_BYTES_ENV:
                                 str(int(span_max_bytes))}
                                if span_max_bytes else {})} or None))
    cm = H.config_map("tpu-job-operator-config", namespace, {
        "gang-scheduling": str(gang_scheduling).lower(),
        "coordinator-port": "8476",
    })
    return [sa, role, binding, *extra, cm, dep]


@register("tpu-job-operator", "TPUJob CRD + the gang-scheduling operator")
def tpu_job_operator(namespace: str = "kubeflow",
                     gang_scheduling: bool = True,
                     shared_cache_root: str = "",
                     span_max_bytes: int = 0,
                     replicas: int = 2,
                     leader_elect: bool = True) -> list[dict]:
    """``shared_cache_root`` (e.g. ``/mnt/kftpu-cache``) turns on the
    cluster-shared compile-cache service: the operator renders
    KFTPU_COMPILE_CACHE_DIR=<root>/<namespace> into every gang (one
    cache per namespace on the tpu-compile-cache volume — deploy that
    component alongside) instead of the per-job checkpoint-volume
    default (docs/operations.md "Warm starts and the compile cache").
    ``span_max_bytes`` caps the trace-span JSONL sink: at the cap the
    active file rotates to ``.1`` (one prior generation) so long-lived
    deployments never grow the sink unbounded; the operator forwards
    the cap into every worker (docs/operations.md "Goodput
    accounting").
    ``replicas``/``leader_elect`` are the control-plane HA knobs
    (docs/operations.md "Control-plane HA"): with leader election on
    (the default) the operator runs ``replicas`` pods behind a
    coordination.k8s.io Lease — every replica watches, only the lease
    holder writes, and a crashed leader fails over within one lease
    duration. ``leader_elect=False`` drops back to a single replica
    (two un-elected replicas would double-drive every gang)."""
    job_crd = H.crd("tpujobs", "TPUJob", "tpu.kubeflow.org", ["v1alpha1"],
                    schema=_job_schema("replicaSpecs", ["Coordinator"]))
    return [job_crd, *_operator_deployment(namespace, gang_scheduling,
                                           shared_cache_root,
                                           span_max_bytes,
                                           replicas=replicas,
                                           leader_elect=leader_elect)]


@register("tpu-compile-cache", "Cluster-shared XLA compile-cache volume: "
                               "one persistent cache per namespace, "
                               "mounted by every gang (warm starts)")
def tpu_compile_cache(namespace: str = "kubeflow",
                      size: str = "50Gi",
                      storage_class: str = "") -> list[dict]:
    """The volume behind the shared compile-cache service
    (runtime/compile_cache.py): a ReadWriteMany claim the operator's
    shared_cache_root points into. Workers mount it via their pod
    template; the operator only renders the env — a gang whose template
    lacks the mount degrades to its checkpoint-volume cache."""
    pvc = k8s.make("v1", "PersistentVolumeClaim", "tpu-compile-cache",
                   namespace)
    pvc["spec"] = {
        "accessModes": ["ReadWriteMany"],
        "resources": {"requests": {"storage": size}},
        **({"storageClassName": storage_class} if storage_class else {}),
    }
    return [pvc]


@register("tf-job-operator", "TFJob CRD served by the TPU operator "
                             "(kubeflow/tf-training parity)")
def tf_job_operator(namespace: str = "kubeflow") -> list[dict]:
    return [H.crd("tfjobs", "TFJob", "kubeflow.org", ["v1beta2", "v1beta1"],
                  schema=_job_schema("tfReplicaSpecs", ["Chief", "Master"]))]


@register("pytorch-operator", "PyTorchJob CRD served by the TPU operator "
                              "(kubeflow/pytorch-job parity)")
def pytorch_operator(namespace: str = "kubeflow") -> list[dict]:
    return [H.crd("pytorchjobs", "PyTorchJob", "kubeflow.org", ["v1beta2"],
                  schema=_job_schema("pytorchReplicaSpecs", ["Master"]))]


@register("mpi-operator", "MPIJob CRD (oneOf{gpuTopology,replicas}) served "
                          "by the TPU operator (kubeflow/mpi-job parity)")
def mpi_operator(namespace: str = "kubeflow") -> list[dict]:
    # The oneOf resource-quantity-first API (mpi-operator.libsonnet:27-77)
    schema = {
        "type": "object",
        "properties": {"spec": {
            "type": "object",
            "oneOf": [
                {"required": ["gpuTopology"]},
                {"required": ["replicas"]},
                {"required": ["replicaSpecs"]},
            ],
        }},
    }
    return [H.crd("mpijobs", "MPIJob", "kubeflow.org", ["v1alpha1"],
                  schema=schema)]


@register("chainer-operator", "ChainerJob CRD (ChainerMN over the MPI "
                              "hostlist contract) served by the TPU operator "
                              "(kubeflow/chainer-job parity)")
def chainer_operator(namespace: str = "kubeflow") -> list[dict]:
    return [H.crd("chainerjobs", "ChainerJob", "kubeflow.org", ["v1alpha1"],
                  schema=_job_schema("chainerReplicaSpecs", ["Master"]))]


@register("mxnet-operator", "MXJob CRD (DMLC scheduler/server/worker env) "
                            "served by the TPU operator "
                            "(kubeflow/mxnet-job parity)")
def mxnet_operator(namespace: str = "kubeflow") -> list[dict]:
    return [H.crd("mxjobs", "MXJob", "kubeflow.org", ["v1alpha1"],
                  schema=_job_schema("mxReplicaSpecs", ["Scheduler"]))]


@register("paddle-operator", "PaddleJob CRD (PADDLE_* pserver/trainer env) "
                             "served by the TPU operator "
                             "(kubeflow/paddle-job parity)")
def paddle_operator(namespace: str = "kubeflow") -> list[dict]:
    return [H.crd("paddlejobs", "PaddleJob", "kubeflow.org", ["v1alpha1"],
                  schema=_job_schema("paddleReplicaSpecs", []))]


@register("tpu-scheduler", "Gang-scheduling queue: the quota-aware slice "
                           "scheduler binding TPUJobs to ICI sub-slices "
                           "(the kube-batch/Volcano slot of the reference)")
def tpu_scheduler(namespace: str = "kubeflow",
                  backfill: bool = True,
                  preemption: bool = True,
                  queues: dict | None = None,
                  health: dict | None = None,
                  elastic: bool = True,
                  grow: bool = True,
                  defrag: bool = True,
                  grow_cooldown_seconds: float = 300.0,
                  warm_pods: int = 0,
                  replicas: int = 2,
                  leader_elect: bool = True) -> list[dict]:
    """``queues`` is the SchedulerConfig wire shape
    (scheduler/queue.py), e.g. ``{"research": {"quotaChips":
    {"team-a": 32, "*": 64}}}`` — per-queue, per-namespace bound-chip
    quotas ("*" is the default for unlisted namespaces). ``health`` is
    the node-health policy block (scheduler/health.py HealthConfig wire
    shape): ``{"enabled": true, "halfLifeSeconds": 600,
    "quarantineThreshold": 3, "releaseThreshold": 1,
    "quarantineSeconds": 900}`` — omitted keys keep the defaults;
    ``{"enabled": false}`` turns the whole quarantine feedback loop
    off (docs/operations.md "Node health and quarantine").
    ``elastic``/``grow``/``defrag``/``grow_cooldown_seconds`` are the
    elastic-resizing policy switches (scheduler/queue.py
    SchedulerConfig; docs/operations.md "Elastic resizing"): the
    master resize switch, grow-to-fill, defrag migration, and the
    per-gang hysteresis between grows/migrations. ``warm_pods`` sizes
    the warm-pod pool (scheduler/warmpool.py): the scheduler keeps up
    to N pre-initialized pods on idle hosts and binds prefer adopting
    them — rebinds/resizes start warm (docs/operations.md "Warm starts
    and the compile cache"). ``replicas``/``leader_elect``: the
    control-plane HA knobs — see tpu_job_operator; the scheduler's
    replicas elect through the tpu-scheduler Lease (cluster/lease.py,
    docs/operations.md "Control-plane HA")."""
    import json

    from ..cluster.lease import SCHEDULER_LEASE
    from ..scheduler.health import HealthConfig
    sa = H.service_account("tpu-scheduler", namespace)
    role = H.cluster_role("tpu-scheduler", [
        {"apiGroups": ["tpu.kubeflow.org"],
         "resources": ["tpujobs"], "verbs": ["get", "list", "watch",
                                             "patch", "update"]},
        {"apiGroups": [""],
         "resources": ["pods", "configmaps"],
         "verbs": ["get", "list", "watch"]},
        # nodes are read AND written: the health pass patches the
        # quarantine / health-score annotations (scheduler/health.py)
        {"apiGroups": [""], "resources": ["nodes"],
         "verbs": ["get", "list", "watch", "patch"]},
    ])
    binding = H.cluster_role_binding("tpu-scheduler", "tpu-scheduler",
                                     "tpu-scheduler", namespace)
    # warm-pod pool writes are NAMESPACED: the pool's pods and the
    # tpu-warm-pool slots ConfigMap live only in the scheduler's own
    # namespace (scheduler/warmpool.py WARM_POOL_NAMESPACE), so the
    # create/delete/patch verbs ride a Role there instead of widening
    # the cluster-wide read grant above
    warm_role = H.role("tpu-scheduler-warm-pool", namespace, [
        {"apiGroups": [""], "resources": ["pods", "configmaps"],
         "verbs": ["create", "delete", "patch"]},
    ])
    warm_binding = H.role_binding("tpu-scheduler-warm-pool", namespace,
                                  "tpu-scheduler-warm-pool",
                                  "tpu-scheduler", namespace)
    cm = H.config_map("tpu-scheduler-config", namespace, {
        "config.json": json.dumps({
            "backfill": backfill, "preemption": preemption,
            "elastic": elastic, "grow": grow, "defrag": defrag,
            "growCooldownSeconds": grow_cooldown_seconds,
            "warmPods": warm_pods,
            "queues": queues or {},
            # render the FULL health block (defaults made explicit) so
            # the deployed knobs are discoverable with kubectl, and
            # round-trip through HealthConfig so a typo'd key fails at
            # render time, not silently at scheduler parse time
            "health": HealthConfig.from_dict(health).to_dict()},
            indent=1),
    })
    from .observability import METRICS_PORT, scrape_annotations
    args = ["--controllers=scheduler",
            f"--metrics-port={METRICS_PORT}"]
    extra: list[dict] = []
    if leader_elect:
        # HA: N replicas, one lease holder writes (cluster/lease.py;
        # controllers/__main__.py --leader-elect gates every hosted
        # controller on the lease named here)
        args += ["--leader-elect", f"--lease-name={SCHEDULER_LEASE}",
                 f"--lease-namespace={namespace}"]
        extra = [
            H.role("tpu-scheduler-leases", namespace, [
                {"apiGroups": ["coordination.k8s.io"],
                 "resources": ["leases"],
                 "verbs": ["get", "list", "watch", "create", "update"]},
            ]),
            H.role_binding("tpu-scheduler-leases", namespace,
                           "tpu-scheduler-leases",
                           "tpu-scheduler", namespace),
        ]
    dep = H.deployment("tpu-scheduler", namespace,
                       f"{IMG}/tpu-job-operator:{VERSION}",
                       args=args,
                       service_account="tpu-scheduler", port=8443,
                       replicas=replicas if leader_elect else 1,
                       pod_annotations=scrape_annotations(METRICS_PORT))
    return [sa, role, binding, warm_role, warm_binding, *extra, cm, dep]


@register("openmpi-controller", "Slice-sidecar config: lifecycle hooks for "
                                "gang workers (components/openmpi-controller analog)")
def openmpi_controller(namespace: str = "kubeflow") -> list[dict]:
    # The reference's sidecar sequenced MPI workers via SIGCONT files and
    # master-phase polling (controller.py:17-23). The gang's analog is
    # the coordinator barrier of its process group; this ships the
    # sidecar config used for payloads needing start sequencing.
    return [H.config_map("slice-sidecar-config", namespace, {
        "wait-mode": "coordinator-barrier",
        "poll-interval-s": "10",
    })]


@register("tpu-job-simple", "Example TPUJob: ResNet-50 synthetic benchmark "
                            "(examples/prototypes/tf-job-simple-v1.jsonnet analog)")
def tpu_job_simple(namespace: str = "kubeflow", name: str = "tpu-job-simple",
                   topology: str = "h100-8", steps: int = 100,
                   global_batch: int = 1024,
                   fused_blocks: bool = False,
                   fused_routing: dict | None = None,
                   weight_update: str = "",
                   input_workers: int | None = None,
                   device_prefetch: int | None = None,
                   backoff_limit: int = 3,
                   clean_pod_policy: str = "Running",
                   gang_scheduling: bool = True,
                   active_deadline_seconds: int | None = None,
                   ttl_seconds_after_finished: int | None = None,
                   restart_backoff_seconds: float = 0.0,
                   restart_backoff_max_seconds: float = 300.0,
                   stall_timeout_seconds: int | None = None,
                   max_anomaly_rollbacks: int = 2,
                   integrity: bool | None = None,
                   integrity_spike_z: float | None = None,
                   integrity_window_steps: int | None = None,
                   integrity_check_every_steps: int | None = None,
                   queue: str | None = None,
                   priority: int | None = None,
                   preemptible: bool | None = None,
                   min_chips: int | None = None,
                   max_chips: int | None = None,
                   span_path: str | None = None,
                   obs_metrics_port: int | None = None,
                   aot: bool | None = None,
                   aot_dir: str | None = None,
                   num_slices: int = 1,
                   multislice_pipeline: bool | None = None,
                   multislice_microbatches: int | None = None
                   ) -> list[dict]:
    """fused_blocks opts into the ghost-BN fused bottleneck kernels
    (docs/training.md --fused-blocks; per-block batch/spatial routing).
    ``fused_routing`` pins the per-geometry kernel routing to a
    chip-measured table (the ``bench.py --mode fused-blocks`` output's
    ``routes`` dict): it renders as a ConfigMap mounted into the worker
    with KFTPU_FUSED_ROUTING_TABLE pointing at it — measured beats
    modeled (PERF.md round 5). ``weight_update="sharded"`` opts the gang
    into the ZeRO-2 cross-replica sharded weight update (spec.weightUpdate
    → KFTPU_WEIGHT_UPDATE; PERF.md "Weight-update sharding").
    ``input_workers``/``device_prefetch`` render the overlapped input
    pipeline's spec.input knobs (→ KFTPU_INPUT_WORKERS /
    KFTPU_DEVICE_PREFETCH; docs/training.md "Input pipeline") — set
    input_workers when the job reads record shards (spec.dataDir).

    The run-policy knobs mirror RunPolicy (api/trainingjob.py) one-to-one
    and render through it, so the example manifest can express the FULL
    failure-handling surface (docs/operations.md "Failure handling"):
    ``backoff_limit``/``clean_pod_policy``/``gang_scheduling``/
    ``active_deadline_seconds``/``ttl_seconds_after_finished`` (the
    classic tf-operator policy), ``restart_backoff_seconds`` +
    ``restart_backoff_max_seconds`` (exponential backoff with jitter
    between gang restarts — restart-storm protection; spec
    restartBackoffSeconds/restartBackoffMaxSeconds), and
    ``stall_timeout_seconds`` (the hung-chief stall watchdog; spec
    stallTimeoutSeconds), and ``max_anomaly_rollbacks`` (the numeric-
    integrity sentinel's LKG-rollback budget, separate from
    backoffLimit; spec maxAnomalyRollbacks — docs/operations.md
    "Numeric integrity").

    ``integrity`` + ``integrity_spike_z``/``integrity_window_steps``/
    ``integrity_check_every_steps`` render spec.integrity
    (api/trainingjob.py IntegritySpec → KFTPU_INTEGRITY / _SPIKE_Z /
    _WINDOW / _CHECK_EVERY): the in-step NaN/Inf + loss-spike sentinel
    with last-known-good rollback (docs/operations.md "Numeric
    integrity").

    ``queue``/``priority``/``preemptible`` render spec.schedulingPolicy
    (api/trainingjob.py SchedulingPolicy): set ANY of them — including
    explicitly to a default value like ``priority=0`` — and the job
    becomes scheduler-managed: it waits in ``Queued`` until the slice
    scheduler (kubeflow_tpu/scheduler/) binds its gang, and a
    ``preemptible`` gang may be reclaimed (checkpoint + requeue) for a
    higher-priority job (docs/operations.md "Scheduling, queues, and
    quotas"). ``min_chips``/``max_chips`` make the gang ELASTIC: the
    scheduler may resize its binding anywhere inside the envelope at
    checkpoint boundaries — shrink to survive a lost host or admit a
    blocked head, grow into idle chips, migrate to defragment
    (docs/operations.md "Elastic resizing"). Leave every scheduling
    knob unset (None) for the legacy immediate-create path.

    ``span_path``/``obs_metrics_port`` render spec.observability
    (api/trainingjob.py ObsSpec → KFTPU_SPAN_PATH /
    KFTPU_OBS_METRICS_PORT): the worker's trace-span JSONL sink and its
    own /metrics port (docs/operations.md "Observability").

    ``aot``/``aot_dir`` render spec.warmStart (api/trainingjob.py
    WarmStartSpec → KFTPU_AOT / KFTPU_AOT_DIR): the AOT serialized-
    executable warm start — rebinds/resizes load the keyed compiled
    step and skip XLA entirely (docs/operations.md "Warm starts and
    the compile cache").

    ``num_slices`` + ``multislice_pipeline``/``multislice_microbatches``
    render a multi-slice gang and spec.multislice (api/trainingjob.py
    MultisliceSpec → KFTPU_MULTISLICE_PIPELINE /
    KFTPU_MULTISLICE_MICROBATCHES): the MPMD pipeline-over-DCN path —
    one program per slice, explicit activation transfers, 1F1B
    microbatch schedule (docs/training.md "Multi-slice training")."""
    command = ["python", "-m", "kubeflow_tpu_torch.runtime.worker",
               "--workload", "resnet50",
               "--steps", str(steps),
               "--global-batch", str(global_batch)]
    if fused_blocks:
        command.append("--fused-blocks")
    container: dict = {
        "name": "worker",
        "image": f"{IMG}/worker:{WORKER_VERSION}",
        "command": command,
    }
    pod_spec: dict = {"containers": [container]}
    out: list[dict] = []
    if fused_routing is not None:
        if not fused_blocks:
            # a mounted table the worker never reads is a silent no-op
            # the user would mistake for pinned routing
            raise ValueError("fused_routing requires fused_blocks=True "
                             "(only the fused path consults the table)")
        import json
        mount_dir = "/etc/kubeflow/fused-routing"
        cm = H.config_map(f"{name}-fused-routing", namespace, {
            "routing.json": json.dumps({"routes": fused_routing},
                                       indent=1)})
        out.append(cm)
        container["env"] = [{"name": "KFTPU_FUSED_ROUTING_TABLE",
                             "value": f"{mount_dir}/routing.json"}]
        container["volumeMounts"] = [{"name": "fused-routing",
                                      "mountPath": mount_dir,
                                      "readOnly": True}]
        pod_spec["volumes"] = [{"name": "fused-routing",
                                "configMap": {
                                    "name": cm["metadata"]["name"]}}]
    from ..api.trainingjob import RunPolicy
    run_policy = RunPolicy(
        clean_pod_policy=clean_pod_policy,
        backoff_limit=backoff_limit,
        active_deadline_seconds=active_deadline_seconds,
        gang_scheduling=gang_scheduling,
        ttl_seconds_after_finished=ttl_seconds_after_finished,
        restart_backoff_seconds=restart_backoff_seconds,
        restart_backoff_max_seconds=restart_backoff_max_seconds,
        stall_timeout_seconds=stall_timeout_seconds,
        max_anomaly_rollbacks=max_anomaly_rollbacks)
    job = k8s.make(TPU_API_VERSION, "TPUJob", name, namespace)
    gpu_spec: dict = {
        "gpuTopology": topology,
        "template": {"spec": pod_spec},
    }
    if num_slices != 1:
        gpu_spec["numSlices"] = num_slices
    job["spec"] = {
        "replicaSpecs": {"GPU": gpu_spec},
        "runPolicy": run_policy.to_dict(),
        "sharding": {"data": -1},
    }
    if weight_update:
        from ..api.trainingjob import validate_weight_update
        job["spec"]["weightUpdate"] = validate_weight_update(weight_update)
    if input_workers is not None or device_prefetch is not None:
        from ..api.trainingjob import InputSpec
        ispec = InputSpec(workers=input_workers,
                          device_prefetch=device_prefetch)
        ispec.validate()
        job["spec"]["input"] = ispec.to_dict()
    if integrity is not None or integrity_spike_z is not None or \
            integrity_window_steps is not None or \
            integrity_check_every_steps is not None:
        from ..api.trainingjob import IntegritySpec
        sspec = IntegritySpec(
            enabled=integrity, spike_z=integrity_spike_z,
            window_steps=integrity_window_steps,
            check_every_steps=integrity_check_every_steps)
        sspec.validate()
        job["spec"]["integrity"] = sspec.to_dict()
    if queue is not None or priority is not None or \
            preemptible is not None or min_chips is not None or \
            max_chips is not None:
        from ..api.trainingjob import SchedulingPolicy
        policy = SchedulingPolicy(queue=queue or "",
                                  priority=priority or 0,
                                  preemptible=bool(preemptible),
                                  min_chips=min_chips,
                                  max_chips=max_chips)
        policy.validate()
        job["spec"]["schedulingPolicy"] = policy.to_dict()
    if span_path is not None or obs_metrics_port is not None:
        from ..api.trainingjob import ObsSpec
        ospec = ObsSpec(span_path=span_path,
                        metrics_port=obs_metrics_port)
        ospec.validate()
        job["spec"]["observability"] = ospec.to_dict()
    if aot is not None or aot_dir is not None:
        from ..api.trainingjob import WarmStartSpec
        wspec = WarmStartSpec(aot=aot, aot_dir=aot_dir)
        wspec.validate()
        job["spec"]["warmStart"] = wspec.to_dict()
    if multislice_pipeline is not None or \
            multislice_microbatches is not None:
        from ..api.trainingjob import MultisliceSpec
        mspec = MultisliceSpec(pipeline=multislice_pipeline,
                               microbatches=multislice_microbatches)
        mspec.validate()
        job["spec"]["multislice"] = mspec.to_dict()
        if mspec.pipeline_enabled:
            if fused_blocks:
                # the wholesale command rewrite below would silently
                # drop --fused-blocks (and the MPMD path stages the
                # pipelined LM, not a resnet) — same rule as
                # fused_routing-without-fused_blocks above
                raise ValueError(
                    "fused_blocks and multislice_pipeline are mutually "
                    "exclusive (the MPMD path runs the pipelined LM, "
                    "not the fused-resnet workload)")
            # the MPMD path stages the pipelined LM, not the image
            # model; the CLI flag only rides along when the pipeline is
            # actually ON (pipeline=False blocks keep the default
            # command — the env render carries the knobs either way)
            container["command"] = [
                "python", "-m", "kubeflow_tpu_torch.runtime.worker",
                "--workload", "transformer-pipelined",
                "--steps", str(steps),
                "--global-batch", str(global_batch),
                "--multislice-pipeline"]
    out.append(job)
    return out


@register("tf-job-simple", "Example TFJob: 1 chief + 1 worker CPU benchmark "
                           "(tf-job-simple-v1.jsonnet parity)")
def tf_job_simple(namespace: str = "kubeflow",
                  name: str = "tf-job-simple") -> list[dict]:
    tmpl = {"spec": {"containers": [{
        "name": "tensorflow", "image": f"{IMG}/tf-cnn-benchmark:{VERSION}",
        "args": ["--model=resnet50", "--device=cpu", "--batch_size=32",
                 "--data_name=synthetic"]}],
        "restartPolicy": "OnFailure"}}
    job = k8s.make(KF_API_VERSION_V1BETA2, "TFJob", name, namespace)
    job["spec"] = {"tfReplicaSpecs": {
        "Chief": {"replicas": 1, "template": tmpl},
        "Worker": {"replicas": 1, "template": tmpl},
    }}
    return [job]
