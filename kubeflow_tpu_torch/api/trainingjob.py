"""Training-job CRD types: TPUJob plus TFJob/PyTorchJob/MPIJob compatibility.

The port's copy of ``kubeflow_tpu/api/trainingjob.py`` with a GPU
accelerator replica. The kinds and apiVersions stay the JAX package's
(``tpu.kubeflow.org/v1alpha1`` ``TPUJob``, and the legacy ``TFJob``,
``PyTorchJob``, ``MPIJob``, ``ChainerJob``, ``MXJob``, ``PaddleJob``), so
manifests and Katib templates carry over; the accelerator replica is
``GPU`` with ``gpuTopology`` (``api/topology.py``: ``h100-N``, one pod a
GPU) wherever the JAX package has ``TPU``/``tpuTopology``, the MPIJob
shorthand included. A ``TPU`` replica is refused with a message naming
``GPU``.

All kinds are reconciled by the same operator (``controllers/tpujob.py``);
the only kind-specific behavior is the replica-type vocabulary and the
legacy env rendering (TF_CONFIG for TFJob CPU replicas, MASTER_ADDR for
PyTorchJob), so templates written against the reference kinds run
unmodified. Stdlib only: admission never imports the runtime.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any, Optional

from . import k8s
from .topology import GpuTopology, parse_topology

TPU_API_VERSION = "tpu.kubeflow.org/v1alpha1"
KF_API_VERSION_V1BETA2 = "kubeflow.org/v1beta2"
KF_API_VERSION_V1ALPHA1 = "kubeflow.org/v1alpha1"

JOB_KINDS = ("TPUJob", "TFJob", "PyTorchJob", "MPIJob",
             "ChainerJob", "MXJob", "PaddleJob")

# How the worker lays the optimizer update out across data-parallel
# replicas (spec.weightUpdate → KFTPU_WEIGHT_UPDATE → TrainStepBuilder;
# runtime/recipe.py re-exports this vocabulary for the step engine):
# "replicated" = every chip reads/writes the full optimizer state after a
# gradient all-reduce; "sharded" = ZeRO-2 (reduce-scatter gradients, each
# replica updates a 1/N shard of the state, all-gather the new params).
# Same losses/params, ~1/N the optimizer HBM traffic per chip (PERF.md).
# Defined HERE, not in runtime/: admission-time validation must stay
# importable without pulling the runtime into the operator layer.
WEIGHT_UPDATE_MODES = ("replicated", "sharded")


def validate_weight_update(mode: str) -> str:
    if mode not in WEIGHT_UPDATE_MODES:
        raise ValueError(
            f"weight_update {mode!r} not one of {WEIGHT_UPDATE_MODES}")
    return mode


# Kernel-tier vocabularies (spec.kernels → KFTPU_KERNEL_* → the recipe
# fingerprint and the AOT step key). Each names an optimized execution
# path for one segment of the compute: which attention implementation
# transformer workloads run, whether the (shard-local) optimizer update
# runs as the fused kernel (K3) or the stock optimizer, and whether
# a served model is int8-quantized behind the parity gate. Defined HERE,
# like WEIGHT_UPDATE_MODES: admission must not import the
# runtime. docs/training.md "Kernel tier".
ATTENTION_KERNELS = ("einsum", "flash", "ring")
OPTIMIZER_KERNELS = ("stock", "fused_adam")
SERVING_KERNELS = ("stock", "int8")


@dataclass
class InputSpec:
    """Input-pipeline knobs (``spec.input``): how the worker feeds the
    chips. Each field is plumbed the full operator path — parsed here at
    admission, rendered by controllers/tpujob.py as the env named in its
    metadata, consumed by runtime/worker.py via the CLI flag named there
    (tests/test_lint.py enforces every layer). ``None`` = unset, worker
    default. Defined HERE, like WEIGHT_UPDATE_MODES: admission
    must not import the runtime."""

    # decode+augment worker processes feeding the shared-memory input
    # ring (data/mp_augment.py); 0 = the in-process prefetch thread
    workers: Optional[int] = field(default=None, metadata={
        "spec_field": "workers", "env": "KFTPU_INPUT_WORKERS",
        "cli": "--input-workers"})
    # device batches staged ahead of the step by async device_put
    # (data/device_prefetch.py); 0 = place on the critical path
    device_prefetch: Optional[int] = field(default=None, metadata={
        "spec_field": "devicePrefetch", "env": "KFTPU_DEVICE_PREFETCH",
        "cli": "--device-prefetch"})

    def validate(self) -> None:
        for f in fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(
                    f"input.{f.metadata['spec_field']} must be a "
                    f"non-negative integer, got {v!r}")

    def to_dict(self) -> dict:
        return {f.metadata["spec_field"]: getattr(self, f.name)
                for f in fields(self) if getattr(self, f.name) is not None}

    def to_env(self) -> dict[str, str]:
        """The controller-rendered worker env for every SET knob."""
        return {f.metadata["env"]: str(getattr(self, f.name))
                for f in fields(self) if getattr(self, f.name) is not None}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "InputSpec":
        if d is not None and not isinstance(d, dict):
            # a YAML list/scalar typo must get the same clean
            # admission-time rejection as a bad knob value
            raise ValueError(
                f"spec.input must be a mapping of input-pipeline knobs, "
                f"got {type(d).__name__}: {d!r}")
        d = dict(d or {})
        by_spec = {f.metadata["spec_field"]: f.name for f in fields(cls)}
        unknown = set(d) - set(by_spec)
        if unknown:
            raise ValueError(
                f"unknown input-pipeline knobs {sorted(unknown)}; "
                f"valid: {sorted(by_spec)}")
        spec = cls(**{by_spec[k]: v for k, v in d.items()})
        spec.validate()
        return spec

@dataclass
class ObsSpec:
    """Observability knobs (``spec.observability``): where this job's
    workers stream trace spans and whether they expose their own
    ``/metrics``. Plumbed the full operator path like InputSpec — parsed
    here at admission, rendered by controllers/tpujob.py as the env
    named in each field's metadata, consumed by runtime/worker.py via
    the CLI flag named there (tests/test_lint.py enforces every layer).
    The job's ``trace_id`` is NOT a spec field: it is minted by the
    control plane (observability.kubeflow.org/trace-id annotation) and
    rendered as KFTPU_TRACE_ID alongside these. ``None`` = unset, obs
    off. Defined HERE: admission must not import the
    runtime."""

    # JSONL sink for trace spans (obs/trace.py SpanWriter): the worker
    # appends window/checkpoint/profile spans the control plane's
    # queued/bound/running events stitch into one timeline
    span_path: Optional[str] = field(default=None, metadata={
        "spec_field": "spanPath", "env": "KFTPU_SPAN_PATH",
        "cli": "--span-path"})
    # port for the worker's own /metrics exposition (obs/http.py);
    # 0/unset = no worker scrape surface
    metrics_port: Optional[int] = field(default=None, metadata={
        "spec_field": "metricsPort", "env": "KFTPU_OBS_METRICS_PORT",
        "cli": "--obs-metrics-port"})

    def validate(self) -> None:
        if self.span_path is not None and \
                not isinstance(self.span_path, str):
            raise ValueError(
                f"observability.spanPath must be a string, got "
                f"{self.span_path!r}")
        p = self.metrics_port
        if p is not None and (not isinstance(p, int) or
                              isinstance(p, bool) or
                              p < 0 or p > 65535):
            raise ValueError(
                f"observability.metricsPort must be a port number, got "
                f"{p!r}")

    def to_dict(self) -> dict:
        return {f.metadata["spec_field"]: getattr(self, f.name)
                for f in fields(self) if getattr(self, f.name) is not None}

    def to_env(self) -> dict[str, str]:
        """The controller-rendered worker env for every SET knob."""
        return {f.metadata["env"]: str(getattr(self, f.name))
                for f in fields(self) if getattr(self, f.name) is not None}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ObsSpec":
        if d is not None and not isinstance(d, dict):
            raise ValueError(
                f"spec.observability must be a mapping of observability "
                f"knobs, got {type(d).__name__}: {d!r}")
        d = dict(d or {})
        by_spec = {f.metadata["spec_field"]: f.name for f in fields(cls)}
        unknown = set(d) - set(by_spec)
        if unknown:
            raise ValueError(
                f"unknown observability knobs {sorted(unknown)}; "
                f"valid: {sorted(by_spec)}")
        spec = cls(**{by_spec[k]: v for k, v in d.items()})
        spec.validate()
        return spec


@dataclass
class WarmStartSpec:
    """Warm-start knobs (``spec.warmStart``): how this job's workers cut
    the startup→first-step cost on every (re)start. Plumbed the full
    operator path like InputSpec — parsed here at admission, rendered by
    controllers/tpujob.py as the env named in each field's metadata,
    consumed by runtime/worker.py via the CLI flag named there
    (tests/test_lint.py enforces every layer). ``None`` = unset, worker
    default. Defined HERE: admission must not import the
    runtime. The persistent compile cache is NOT a knob here — it is
    always on when a cache volume exists (spec.compileCacheDir /
    checkpointDir); warmStart adds the AOT executable rung above it
    (docs/operations.md "Warm starts and the compile cache")."""

    # AOT executable export/load (runtime/aot.py): the worker loads a
    # keyed serialized step executable on rebind/resize — no trace, no
    # lower, no XLA — and exports it at first bind; falls back to the
    # compile cache, then a fresh compile
    aot: Optional[bool] = field(default=None, metadata={
        "spec_field": "aot", "env": "KFTPU_AOT", "cli": "--aot"})
    # where the serialized executables live; defaults to
    # <checkpointDir>/.jax-aot-executables (the volume the gang mounts)
    aot_dir: Optional[str] = field(default=None, metadata={
        "spec_field": "aotDir", "env": "KFTPU_AOT_DIR",
        "cli": "--aot-dir"})

    def validate(self) -> None:
        if self.aot is not None and not isinstance(self.aot, bool):
            raise ValueError(
                f"warmStart.aot must be a boolean, got {self.aot!r}")
        if self.aot_dir is not None and \
                not isinstance(self.aot_dir, str):
            raise ValueError(
                f"warmStart.aotDir must be a string, got "
                f"{self.aot_dir!r}")

    def to_dict(self) -> dict:
        return {f.metadata["spec_field"]: getattr(self, f.name)
                for f in fields(self) if getattr(self, f.name) is not None}

    def to_env(self) -> dict[str, str]:
        """The controller-rendered worker env for every SET knob
        (booleans render "1"/"0" — the worker's _env_int contract)."""
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            out[f.metadata["env"]] = ("1" if v else "0") \
                if isinstance(v, bool) else str(v)
        return out

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "WarmStartSpec":
        if d is not None and not isinstance(d, dict):
            raise ValueError(
                f"spec.warmStart must be a mapping of warm-start knobs, "
                f"got {type(d).__name__}: {d!r}")
        d = dict(d or {})
        by_spec = {f.metadata["spec_field"]: f.name for f in fields(cls)}
        unknown = set(d) - set(by_spec)
        if unknown:
            raise ValueError(
                f"unknown warm-start knobs {sorted(unknown)}; "
                f"valid: {sorted(by_spec)}")
        spec = cls(**{by_spec[k]: v for k, v in d.items()})
        spec.validate()
        return spec


@dataclass
class MultisliceSpec:
    """Multi-slice execution knobs (``spec.multislice``): how a job
    spanning ``numSlices > 1`` runs across the DCN boundary. Plumbed the
    full operator path like InputSpec — parsed here at admission,
    rendered by controllers/tpujob.py as the env named in each field's
    metadata, consumed by runtime/worker.py via the CLI flag named there
    (tests/test_lint.py enforces every layer). ``None`` = unset, worker
    default (the single-program GSPMD path with DCN-aware sharding
    rules). Defined HERE: admission must not import the
    runtime. docs/training.md "Multi-slice training"."""

    # MPMD pipeline-over-DCN (parallel/multislice.py): one program PER
    # SLICE — pipeline stages with explicit activation/grad send-recv
    # over DCN and a microbatched 1F1B-style schedule — instead of one
    # SPMD program resharding across the slow link
    pipeline: Optional[bool] = field(default=None, metadata={
        "spec_field": "pipeline", "env": "KFTPU_MULTISLICE_PIPELINE",
        "cli": "--multislice-pipeline"})
    # microbatches per step for the MPMD schedule; the pipeline bubble
    # fraction is (S-1)/(M+S-1), so M >= 4*S keeps it under 20%
    microbatches: Optional[int] = field(default=None, metadata={
        "spec_field": "microbatches",
        "env": "KFTPU_MULTISLICE_MICROBATCHES",
        "cli": "--multislice-microbatches"})

    @property
    def pipeline_enabled(self) -> bool:
        return bool(self.pipeline)

    def validate(self) -> None:
        if self.pipeline is not None and \
                not isinstance(self.pipeline, bool):
            raise ValueError(
                f"multislice.pipeline must be a boolean, got "
                f"{self.pipeline!r}")
        m = self.microbatches
        if m is not None and (not isinstance(m, int) or
                              isinstance(m, bool) or m < 1):
            raise ValueError(
                f"multislice.microbatches must be a positive integer, "
                f"got {m!r}")
        if m is not None and not self.pipeline:
            # only the MPMD schedule consumes the knob — accepting it
            # without the pipeline would be a silent no-op the user
            # mistakes for a pinned schedule (the fused_routing-
            # without-fused_blocks rule)
            raise ValueError(
                "multislice.microbatches requires multislice.pipeline: "
                "true (only the MPMD schedule consumes it)")

    def to_dict(self) -> dict:
        return {f.metadata["spec_field"]: getattr(self, f.name)
                for f in fields(self) if getattr(self, f.name) is not None}

    def to_env(self) -> dict[str, str]:
        """The controller-rendered worker env for every SET knob
        (booleans render "1"/"0" — the worker's _env_int contract)."""
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            out[f.metadata["env"]] = ("1" if v else "0") \
                if isinstance(v, bool) else str(v)
        return out

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "MultisliceSpec":
        if d is not None and not isinstance(d, dict):
            raise ValueError(
                f"spec.multislice must be a mapping of multi-slice "
                f"knobs, got {type(d).__name__}: {d!r}")
        d = dict(d or {})
        by_spec = {f.metadata["spec_field"]: f.name for f in fields(cls)}
        unknown = set(d) - set(by_spec)
        if unknown:
            raise ValueError(
                f"unknown multislice knobs {sorted(unknown)}; "
                f"valid: {sorted(by_spec)}")
        spec = cls(**{by_spec[k]: v for k, v in d.items()})
        spec.validate()
        return spec


@dataclass
class KernelSpec:
    """Kernel-tier knobs (``spec.kernels``): which optimized execution
    path each compute segment runs (the raw-speed kernel tier).
    Plumbed the full operator path like InputSpec — parsed here at
    admission, rendered by controllers/tpujob.py as the env named in
    each field's metadata, consumed by runtime/worker.py via the CLI
    flag named there (tests/test_lint.py enforces every layer).
    ``None`` = unset, worker default (stock/einsum — the tier is opt-in).
    Every set knob is baked into ``recipe_fingerprint`` and the AOT
    ``step_key`` so a tier flip can never alias a cached executable.
    Defined HERE: admission must not import the runtime."""

    # attention implementation for transformer workloads: "einsum"
    # (plain PyTorch), "flash" (ops/flash_attention.py, K1/K2), or
    # "ring" (sequence-parallel, ops/ring_attention.py)
    attention: Optional[str] = field(default=None, metadata={
        "spec_field": "attention", "env": "KFTPU_KERNEL_ATTENTION",
        "cli": "--kernel-attention"})
    # optimizer update: "stock" (torch.optim) or "fused_adam"
    # (ops/fused_adam.py — one CUDA kernel for decay+moments+step over
    # the shard-local slab; requires --optimizer adam)
    optimizer: Optional[str] = field(default=None, metadata={
        "spec_field": "optimizer", "env": "KFTPU_KERNEL_OPTIMIZER",
        "cli": "--kernel-optimizer"})
    # serving path: "stock" (f32 weights) or "int8" (per-channel absmax
    # quantized matmul weights behind the accuracy parity gate —
    # serving/servable.py)
    serving: Optional[str] = field(default=None, metadata={
        "spec_field": "serving", "env": "KFTPU_KERNEL_SERVING",
        "cli": "--kernel-serving"})

    def validate(self) -> None:
        for name, value, vocab in (
                ("attention", self.attention, ATTENTION_KERNELS),
                ("optimizer", self.optimizer, OPTIMIZER_KERNELS),
                ("serving", self.serving, SERVING_KERNELS)):
            if value is not None and value not in vocab:
                raise ValueError(
                    f"kernels.{name} {value!r} not one of {vocab}")

    def to_dict(self) -> dict:
        return {f.metadata["spec_field"]: getattr(self, f.name)
                for f in fields(self) if getattr(self, f.name) is not None}

    def to_env(self) -> dict[str, str]:
        """The controller-rendered worker env for every SET knob."""
        return {f.metadata["env"]: str(getattr(self, f.name))
                for f in fields(self)
                if getattr(self, f.name) is not None}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "KernelSpec":
        if d is not None and not isinstance(d, dict):
            raise ValueError(
                f"spec.kernels must be a mapping of kernel-tier knobs, "
                f"got {type(d).__name__}: {d!r}")
        d = dict(d or {})
        by_spec = {f.metadata["spec_field"]: f.name for f in fields(cls)}
        unknown = set(d) - set(by_spec)
        if unknown:
            raise ValueError(
                f"unknown kernel-tier knobs {sorted(unknown)}; "
                f"valid: {sorted(by_spec)}")
        spec = cls(**{by_spec[k]: v for k, v in d.items()})
        spec.validate()
        return spec


@dataclass
class IntegritySpec:
    """Numeric-integrity sentinel knobs (``spec.integrity``): in-step
    NaN/Inf and loss-spike detection with last-known-good rollback
    (runtime/sentinel.py). Plumbed the full operator path like
    InputSpec — parsed here at admission, rendered by
    controllers/tpujob.py as the env named in each field's metadata,
    consumed by runtime/worker.py via the CLI flag named there
    (tests/test_lint.py enforces every layer). ``None`` = unset, worker
    default (sentinel OFF). Deliberately EXCLUDED from the recipe
    fingerprint and the AOT step key: the sentinel observes the metrics
    the worker already fetches and changes no math, so flipping it must
    never invalidate a cached executable. Defined HERE:
    admission must not import the runtime. docs/operations.md "Numeric
    integrity"."""

    # master switch: NaN/Inf checks on loss / global grad norm, the
    # rolling z-score spike detector, and the cross-replica agreement
    # check (ZeRO-2 path) ride the worker's window drain
    enabled: Optional[bool] = field(default=None, metadata={
        "spec_field": "enabled", "env": "KFTPU_INTEGRITY",
        "cli": "--integrity"})
    # one-sided z-score threshold for the loss-spike detector (EWMA
    # mean/variance); default 8 — the false-positive budget is zero
    spike_z: Optional[float] = field(default=None, metadata={
        "spec_field": "spikeZ", "env": "KFTPU_INTEGRITY_SPIKE_Z",
        "cli": "--integrity-spike-z"})
    # EWMA window (steps) the spike baseline averages over; the detector
    # arms only after the window has filled
    window_steps: Optional[int] = field(default=None, metadata={
        "spec_field": "windowSteps", "env": "KFTPU_INTEGRITY_WINDOW",
        "cli": "--integrity-window"})
    # detection cadence: the worker closes a metrics window at least
    # every this many steps so a trip is caught within the bound
    check_every_steps: Optional[int] = field(default=None, metadata={
        "spec_field": "checkEverySteps",
        "env": "KFTPU_INTEGRITY_CHECK_EVERY",
        "cli": "--integrity-check-every"})

    @property
    def is_enabled(self) -> bool:
        return bool(self.enabled)

    def validate(self) -> None:
        if self.enabled is not None and \
                not isinstance(self.enabled, bool):
            raise ValueError(
                f"integrity.enabled must be a boolean, got "
                f"{self.enabled!r}")
        z = self.spike_z
        if z is not None and (isinstance(z, bool) or
                              not isinstance(z, (int, float)) or z <= 0):
            raise ValueError(
                f"integrity.spikeZ must be a positive number, got {z!r}")
        for name, v, lo in (("windowSteps", self.window_steps, 2),
                            ("checkEverySteps",
                             self.check_every_steps, 1)):
            if v is not None and (not isinstance(v, int) or
                                  isinstance(v, bool) or v < lo):
                raise ValueError(
                    f"integrity.{name} must be an integer >= {lo}, "
                    f"got {v!r}")
        if not self.enabled and (z is not None or
                                 self.window_steps is not None or
                                 self.check_every_steps is not None):
            # only the sentinel consumes the tuning knobs — accepting
            # them without enabled: true would be a silent no-op the
            # user mistakes for armed detection (the
            # multislice.microbatches-without-pipeline rule)
            raise ValueError(
                "integrity.spikeZ/windowSteps/checkEverySteps require "
                "integrity.enabled: true (only the sentinel consumes "
                "them)")

    def to_dict(self) -> dict:
        return {f.metadata["spec_field"]: getattr(self, f.name)
                for f in fields(self) if getattr(self, f.name) is not None}

    def to_env(self) -> dict[str, str]:
        """The controller-rendered worker env for every SET knob
        (booleans render "1"/"0" — the worker's _env_int contract)."""
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            out[f.metadata["env"]] = ("1" if v else "0") \
                if isinstance(v, bool) else str(v)
        return out

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "IntegritySpec":
        if d is not None and not isinstance(d, dict):
            raise ValueError(
                f"spec.integrity must be a mapping of integrity-sentinel "
                f"knobs, got {type(d).__name__}: {d!r}")
        d = dict(d or {})
        by_spec = {f.metadata["spec_field"]: f.name for f in fields(cls)}
        unknown = set(d) - set(by_spec)
        if unknown:
            raise ValueError(
                f"unknown integrity knobs {sorted(unknown)}; "
                f"valid: {sorted(by_spec)}")
        spec = cls(**{by_spec[k]: v for k, v in d.items()})
        spec.validate()
        return spec


@dataclass
class SchedulingPolicy:
    """Gang-scheduling knobs (``spec.schedulingPolicy``): how the slice
    scheduler queues, places, and — when
    ``preemptible`` — reclaims this job's slices. A job that carries the
    block is SCHEDULER-MANAGED: the operator creates no pods until the
    scheduler writes the slice binding annotation (the job sits in a
    visible ``Queued`` condition instead of half-creating a gang). A job
    without the block keeps the legacy admission==placement path. The
    slice scheduler (``scheduler/core.py``) writes the binding."""

    # scheduler queue this job submits to ("" = the default queue);
    # quotas are enforced per (queue, namespace) — scheduler/queue.py
    queue: str = ""
    # higher binds first; ties break by submission order (FIFO)
    priority: int = 0
    # a preemptible gang may be reclaimed for a higher-priority job via
    # the graceful path (SIGTERM → forced checkpoint → exit 75) and is
    # RE-QUEUED by the scheduler, not failed
    preemptible: bool = False
    # Elastic gang bounds (minChips/maxChips): either set makes the job
    # ELASTIC — the scheduler may resize the gang's binding at checkpoint
    # boundaries anywhere in [minChips, maxChips] total chips (shrink to
    # survive a lost host or admit a blocked head, grow into idle chips,
    # migrate to defragment). Global batch size stays FIXED across
    # resizes: only the data-parallel replica degree changes, and the
    # checkpoint restore reshapes optimizer state across degrees
    # (runtime/checkpoint.py). None = that bound pins to the nominal
    # spec shape; both None = fixed-shape (the pre-elastic contract).
    min_chips: Optional[int] = None
    max_chips: Optional[int] = None

    ENV_QUEUE = "KFTPU_SCHED_QUEUE"
    ENV_PRIORITY = "KFTPU_SCHED_PRIORITY"
    ENV_PREEMPTIBLE = "KFTPU_SCHED_PREEMPTIBLE"
    ENV_MIN_CHIPS = "KFTPU_SCHED_MIN_CHIPS"
    ENV_MAX_CHIPS = "KFTPU_SCHED_MAX_CHIPS"

    @property
    def elastic(self) -> bool:
        """Whether the scheduler may resize this gang's binding."""
        return self.min_chips is not None or self.max_chips is not None

    def chip_bounds(self, nominal: int) -> tuple[int, int]:
        """The [min, max] total-chip envelope around the spec's nominal
        gang size (an unset bound pins to nominal — the spec shape is
        always inside its own envelope)."""
        return (self.min_chips if self.min_chips is not None else nominal,
                self.max_chips if self.max_chips is not None else nominal)

    def validate(self) -> None:
        if not isinstance(self.queue, str):
            raise ValueError(
                f"schedulingPolicy.queue must be a string, got "
                f"{self.queue!r}")
        if not isinstance(self.priority, int) or \
                isinstance(self.priority, bool):
            raise ValueError(
                f"schedulingPolicy.priority must be an integer, got "
                f"{self.priority!r}")
        if not isinstance(self.preemptible, bool):
            raise ValueError(
                f"schedulingPolicy.preemptible must be a boolean, got "
                f"{self.preemptible!r}")
        for label, v in (("minChips", self.min_chips),
                         ("maxChips", self.max_chips)):
            if v is None:
                continue
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(
                    f"schedulingPolicy.{label} must be a positive "
                    f"integer, got {v!r}")
        if self.min_chips is not None and self.max_chips is not None \
                and self.min_chips > self.max_chips:
            raise ValueError(
                f"schedulingPolicy.minChips ({self.min_chips}) must not "
                f"exceed maxChips ({self.max_chips})")

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"priority": self.priority,
                             "preemptible": self.preemptible}
        if self.queue:
            d["queue"] = self.queue
        if self.min_chips is not None:
            d["minChips"] = self.min_chips
        if self.max_chips is not None:
            d["maxChips"] = self.max_chips
        return d

    def to_env(self) -> dict[str, str]:
        """Rendered into every worker pod: informational for the queue
        name/priority and the elastic bounds, behavioral for preemptible
        (the worker's SIGTERM handler knows a reclaim is a requeue, not
        a failure)."""
        env = {
            self.ENV_QUEUE: self.queue or DEFAULT_QUEUE,
            self.ENV_PRIORITY: str(self.priority),
            self.ENV_PREEMPTIBLE: "1" if self.preemptible else "0",
        }
        if self.min_chips is not None:
            env[self.ENV_MIN_CHIPS] = str(self.min_chips)
        if self.max_chips is not None:
            env[self.ENV_MAX_CHIPS] = str(self.max_chips)
        return env

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["SchedulingPolicy"]:
        """None (absent block) = NOT scheduler-managed — the distinction
        the operator gates pod creation on, so it must survive the
        parse/serialize round trip exactly."""
        if d is None:
            return None
        if not isinstance(d, dict):
            raise ValueError(
                f"spec.schedulingPolicy must be a mapping, got "
                f"{type(d).__name__}: {d!r}")
        known = {"queue", "priority", "preemptible", "minChips", "maxChips"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown schedulingPolicy fields {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        policy = cls(queue=d.get("queue", "") or "",
                     priority=d.get("priority", 0),
                     preemptible=d.get("preemptible", False),
                     min_chips=d.get("minChips"),
                     max_chips=d.get("maxChips"))
        policy.validate()
        return policy


# the queue a schedulingPolicy without an explicit queue submits to
DEFAULT_QUEUE = "default"

# Slice-binding contract between the gang scheduler and the operator
# (scheduler/core.py writes, controllers/tpujob.py consumes): the binding
# annotation carries the JSON placement (per-slice pool + node-row run,
# scheduler/inventory.py Placement wire format). A scheduler-managed job
# WITHOUT the annotation is queued — the operator creates no pods for it.
BINDING_ANNOTATION = "scheduling.kubeflow.org/binding"
# scheduler-visible state for dashboards/kubectl: queued | bound | preempted
SCHED_STATE_ANNOTATION = "scheduling.kubeflow.org/state"
# human-readable reason a job is still queued (quota, capacity, ...)
SCHED_REASON_ANNOTATION = "scheduling.kubeflow.org/reason"
# times this job's gang was preempted (reclaimed, not failed)
PREEMPTED_COUNT_ANNOTATION = "scheduling.kubeflow.org/preempted-count"
# Elastic-resize event history (scheduler/core.py writes): a JSON list of
# {"time", "fromChips", "toChips", "reason"} records, newest last, capped
# — the audit trail of every shrink / grow / defrag migration the
# scheduler applied to this gang's binding.
RESIZE_HISTORY_ANNOTATION = "scheduling.kubeflow.org/resize-history"

# Node-health contract between the operator (evidence writer) and the
# scheduler (policy actor) — scheduler/health.py owns the parse/fold
# helpers, BOTH sides consume them (the binding_of pattern: one wire
# contract, no string drift; tests/test_lint.py enforces single
# definition). All three ride on annotations so the two processes
# coordinate through the apiserver only:
#
# - HEALTH_ANNOTATION (on Nodes): exponential-decay failure score, JSON
#   {"score": s, "time": unix, "events": n, "last": kind}. The operator
#   folds runtime failure evidence in (pod crash attributed to the host
#   it ran on, stalled worker, step-time skew); the scheduler decays and
#   reads it each pass.
# - QUARANTINE_ANNOTATION (on Nodes): set by the scheduler when a
#   host's score crosses the threshold (or by a human, reason
#   "manual"), JSON {"reason": r, "score": s, "since": unix, "until":
#   unix|null}. Quarantined hosts are carved out of placeable
#   rectangles (scheduler/inventory.py); expiry + score decay below the
#   release threshold auto-releases (probation), manual quarantines
#   never auto-release.
# - SUSPECT_ANNOTATION (on TPUJobs): the host the operator attributes a
#   gang teardown to (crash loop on one pod, stalled single worker).
#   The scheduler replans the job's binding EXCLUDING the suspect's
#   cells — the gang migrates instead of crash-looping in place — and
#   clears the annotation on the rebind.
HEALTH_ANNOTATION = "kubeflow.org/health"
QUARANTINE_ANNOTATION = "kubeflow.org/quarantine"
SUSPECT_ANNOTATION = "scheduling.kubeflow.org/suspect-host"

# apiVersion per kind (reference CRD groups/versions)
API_VERSIONS = {
    "TPUJob": TPU_API_VERSION,
    "TFJob": KF_API_VERSION_V1BETA2,
    "PyTorchJob": KF_API_VERSION_V1BETA2,
    "MPIJob": KF_API_VERSION_V1ALPHA1,
    "ChainerJob": KF_API_VERSION_V1ALPHA1,
    "MXJob": KF_API_VERSION_V1ALPHA1,
    "PaddleJob": KF_API_VERSION_V1ALPHA1,
}

# replica-spec key inside .spec, per kind (reference CRD field names)
_SPECS_KEY = {
    "TFJob": "tfReplicaSpecs",
    "PyTorchJob": "pytorchReplicaSpecs",
    "TPUJob": "replicaSpecs",
    "MPIJob": "replicaSpecs",
    "ChainerJob": "chainerReplicaSpecs",
    "MXJob": "mxReplicaSpecs",
    "PaddleJob": "paddleReplicaSpecs",
}

# Replica-type vocabulary per kind. "GPU" (the accelerator gang) is valid in
# every kind, where the JAX package has "TPU". Validation constraints mirror the reference CRD
# schemas (Chief/Master max 1: tf-job-operator.libsonnet:14-46).
REPLICA_TYPES: dict[str, tuple[str, ...]] = {
    "TPUJob": ("GPU", "Coordinator", "Evaluator"),
    "TFJob": ("GPU", "Chief", "Master", "Worker", "PS", "Evaluator"),
    "PyTorchJob": ("GPU", "Master", "Worker"),
    "MPIJob": ("GPU", "Launcher", "Worker"),
    # reference operators: kubeflow/chainer-job/chainer-operator.libsonnet,
    # kubeflow/mxnet-job/mxnet-operator.libsonnet,
    # kubeflow/paddle-job/*.libsonnet
    "ChainerJob": ("GPU", "Master", "Worker"),
    "MXJob": ("GPU", "Scheduler", "Server", "Worker"),
    "PaddleJob": ("GPU", "Pserver", "Trainer"),
}
_MAX_ONE = {"Chief", "Master", "Coordinator", "Launcher", "Scheduler"}

# Condition types, mirroring tf-operator's JobCondition vocabulary.
# Queued is the TPU-native addition: a scheduler-managed job admitted but
# not yet bound to slices (visible in kubectl/dashboard instead of a
# half-created gang).
COND_QUEUED = "Queued"
COND_CREATED = "Created"
COND_RUNNING = "Running"
COND_RESTARTING = "Restarting"
COND_SUCCEEDED = "Succeeded"
COND_FAILED = "Failed"

# Pod phases we consume (fake or real apiserver).
POD_PENDING = "Pending"
POD_RUNNING = "Running"
POD_SUCCEEDED = "Succeeded"
POD_FAILED = "Failed"

CLEAN_POD_ALL = "All"
CLEAN_POD_RUNNING = "Running"
CLEAN_POD_NONE = "None"

RESTART_POLICY_NEVER = "Never"
RESTART_POLICY_ON_FAILURE = "OnFailure"
# Gang restart: any worker failure restarts the whole slice (SURVEY §5
# "failure detection": a dead worker kills the gang).
RESTART_POLICY_GANG = "GangOnFailure"

# Worker liveness contract (the stall watchdog, SURVEY §5 hung-not-dead):
# workers annotate their own pod with a JSON {"step": N, "time": unix}
# heartbeat (runtime/metrics.py HeartbeatReporter); the controller restarts
# a gang whose CHIEF heartbeat is staler than runPolicy.stallTimeoutSeconds.
# Defined here, not in runtime/: the controller layer must stay importable
# without pulling the runtime into the operator process.
# The heartbeat payload MAY also carry "lastLoss"/"lastGradNorm" (the
# last drained window's host floats, stringified so NaN/Inf survive
# strict-JSON consumers): the operator flags a NaN-emitting worker even
# when that worker's own sentinel is disabled — after the same
# freshness clamp the stall watchdog applies (a future-stamped beat
# must not be trusted).
HEARTBEAT_ANNOTATION = "kubeflow.org/worker-heartbeat"

# Numeric-integrity anomaly contract (runtime/sentinel.py is
# the worker side, controllers/tpujob.py the operator side):
#
# - ANOMALY_ANNOTATION (on Pods): a worker whose sentinel trips patches
#   its own pod with the AnomalyEvidence JSON {"kind", "step", "value",
#   "lkg", "detail"} BEFORE exiting ANOMALY_EXIT_CODE. The operator's
#   failed-pod branch reads it to route the gang failure down the
#   rollback path instead of the plain restart path.
# - ANOMALY_COUNT_ANNOTATION (on TPUJobs): rollbacks consumed so far;
#   compared against runPolicy.maxAnomalyRollbacks — exhausted → the
#   job Fails with the evidence in the condition.
# - ANOMALY_ROLLBACK_ANNOTATION (on TPUJobs): the ACTIVE rollback, JSON
#   {"lkgStep", "tripStep", "kind", "count", "replay"?}. The controller
#   renders it into the recreated gang as KFTPU_RESUME_STEP (restore
#   the newest intact step <= LKG, not newest overall) and — on the
#   second trip at the same LKG, when "replay" is set — as
#   KFTPU_REPLAY_RANGE (replay bisection over the suspect steps with
#   the suspect host evacuated). Cleared once the chief's heartbeat
#   advances past the trip step.
ANOMALY_ANNOTATION = "kubeflow.org/numeric-anomaly"
ANOMALY_COUNT_ANNOTATION = "kubeflow.org/anomaly-rollback-count"
ANOMALY_ROLLBACK_ANNOTATION = "kubeflow.org/anomaly-rollback"


@dataclass
class ReplicaSpec:
    """One replica group. Either a pod-count replica (CPU roles) or a
    topology replica (the GPU gang)."""

    replica_type: str
    replicas: int = 1
    topology: Optional[GpuTopology] = None     # set iff replica_type == "GPU"
    num_slices: int = 1
    template: dict = field(default_factory=dict)  # corev1.PodTemplateSpec
    restart_policy: str = RESTART_POLICY_GANG

    @property
    def is_gpu(self) -> bool:
        return self.replica_type == "GPU"

    @property
    def pod_count(self) -> int:
        """Pods this replica group schedules (GPU: one pod per GPU per slice)."""
        if self.is_gpu and self.topology is not None:
            return self.topology.pods_per_slice * self.num_slices
        return self.replicas

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"replicas": self.replicas,
                             "restartPolicy": self.restart_policy,
                             "template": self.template}
        if self.is_gpu and self.topology is not None:
            d["gpuTopology"] = self.topology.name
            d["numSlices"] = self.num_slices
            d.pop("replicas")
        return d


@dataclass
class RunPolicy:
    """Job-level execution policy (tf-operator RunPolicy analog)."""

    clean_pod_policy: str = CLEAN_POD_RUNNING
    backoff_limit: int = 3                      # gang restarts before Failed
    active_deadline_seconds: Optional[int] = None
    gang_scheduling: bool = True                # mandatory for GPU replicas
    ttl_seconds_after_finished: Optional[int] = None
    # Restart-storm protection: delay between gang restarts grows
    # base * 2^restarts (capped at max), with deterministic jitter, and the
    # next-eligible time is persisted as a job annotation so a controller
    # restart cannot shortcut the wait. 0 = restart immediately (the
    # pre-backoff behavior, and the default).
    restart_backoff_seconds: float = 0.0
    restart_backoff_max_seconds: float = 300.0
    # Stall watchdog: restart a gang whose chief heartbeat annotation
    # (HEARTBEAT_ANNOTATION) is staler than this — hung-but-not-dead
    # workers (wedged collective, dead TPU runtime with a live pod) never
    # produce a Failed phase on their own. None = watchdog off.
    stall_timeout_seconds: Optional[int] = None
    # Anomaly budget: last-known-good rollbacks (a worker exiting
    # ANOMALY_EXIT_CODE with evidence in ANOMALY_ANNOTATION) before the
    # job Fails with the evidence in the condition. Separate from
    # backoffLimit — a rollback is a recovery, not a crash — and
    # tracked in ANOMALY_COUNT_ANNOTATION. docs/operations.md "Numeric
    # integrity".
    max_anomaly_rollbacks: int = 2

    def to_dict(self) -> dict:
        d: dict[str, Any] = {
            "cleanPodPolicy": self.clean_pod_policy,
            "backoffLimit": self.backoff_limit,
            "gangScheduling": self.gang_scheduling,
        }
        if self.active_deadline_seconds is not None:
            d["activeDeadlineSeconds"] = self.active_deadline_seconds
        if self.ttl_seconds_after_finished is not None:
            d["ttlSecondsAfterFinished"] = self.ttl_seconds_after_finished
        if self.restart_backoff_seconds:
            d["restartBackoffSeconds"] = self.restart_backoff_seconds
            d["restartBackoffMaxSeconds"] = self.restart_backoff_max_seconds
        if self.stall_timeout_seconds is not None:
            d["stallTimeoutSeconds"] = self.stall_timeout_seconds
        if self.max_anomaly_rollbacks != 2:
            d["maxAnomalyRollbacks"] = self.max_anomaly_rollbacks
        return d


@dataclass
class ShardingSpec:
    """Parallelism as job-spec data (``spec.sharding``, rendered as
    ``KFTPU_SHARDING``). Axis sizes multiply to the global device count;
    -1 means "fill with the remaining devices" (at most one axis). The
    port lowers it to ``parallel/mesh.py``'s mesh over the ranks."""

    data: int = -1        # pure data parallel
    fsdp: int = 1         # data parallel with sharded params
    tensor: int = 1       # op sharding
    pipeline: int = 1     # pipeline stages
    sequence: int = 1     # sequence/context parallelism
    expert: int = 1       # MoE expert parallelism

    AXES = ("data", "fsdp", "expert", "pipeline", "sequence", "tensor")

    def axis_sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in self.AXES}

    def resolve(self, num_devices: int) -> dict[str, int]:
        """Axis sizes against ``num_devices``, the wildcard filled."""
        sizes = self.axis_sizes()
        wildcards = [a for a, s in sizes.items() if s == -1]
        if len(wildcards) > 1:
            raise ValueError(
                f"at most one sharding axis may be -1, got {wildcards}")
        fixed = 1
        for a, s in sizes.items():
            if s != -1:
                if s < 1:
                    raise ValueError(
                        f"sharding axis {a} must be >=1 or -1, got {s}")
                fixed *= s
        if wildcards:
            if num_devices % fixed:
                raise ValueError(
                    f"fixed sharding axes product {fixed} does not divide "
                    f"{num_devices} devices")
            sizes[wildcards[0]] = num_devices // fixed
        elif fixed != num_devices:
            raise ValueError(
                f"sharding axes product {fixed} != total device count "
                f"{num_devices}")
        return sizes

    def to_dict(self) -> dict:
        return self.axis_sizes()

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ShardingSpec":
        d = d or {}
        unknown = set(d) - set(cls.AXES)
        if unknown:
            raise ValueError(f"unknown sharding axes {sorted(unknown)}; "
                             f"valid: {list(cls.AXES)}")
        return cls(**{a: int(d.get(a, -1 if a == "data" else 1))
                      for a in cls.AXES})


# Mesh axes a multi-slice layout may legally place across the DCN
# boundary: data/fsdp collectives are once-per-step gradient traffic
# (latency-tolerant), pipeline's send/recv is deliberate stage transfer.
# tensor/sequence are PER-LAYER collectives — a layout that puts them
# across slices pays the slow link inside every matmul, and the GSPMD
# partitioner's fallback for the resulting layout conflicts is the
# "involuntary full rematerialization" reshard (MULTICHIP_r05).
DCN_LEGAL_AXES = ("data", "fsdp", "expert", "pipeline")


def dcn_crossing_axes(sizes: dict, num_slices: int,
                      axes: tuple = ShardingSpec.AXES) -> tuple:
    """Mesh axes whose coordinate change crosses a slice boundary.

    DCN-major device order (parallel/mesh.py): flat participant position
    = row-major index over ``axes``; slice id = position // chips_per_
    slice. An axis crosses DCN iff two positions differing only in that
    axis's coordinate land in different slices. Pure arithmetic, stdlib
    — admission (validate() below) rejects layouts the partitioner would
    only fail at compile time, deep inside the gang."""
    if num_slices <= 1:
        return ()
    total = 1
    for a in axes:
        total *= int(sizes.get(a, 1))
    if total % num_slices:
        raise ValueError(
            f"sharding axes product {total} not divisible by "
            f"{num_slices} slices")
    cps = total // num_slices
    # strides of the row-major enumeration (innermost axis stride 1)
    strides = {}
    inner = 1
    for a in reversed(axes):
        strides[a] = inner
        inner *= int(sizes.get(a, 1))
    crossing = []
    for a in axes:
        size = int(sizes.get(a, 1))
        if size <= 1:
            continue
        stride = strides[a]
        # exact: two positions differing only in this axis's coordinate
        # land in different slices. The sweep from any base covers
        # base + c*stride, c in [0, size); bases are every position
        # with this coordinate zero.
        found = False
        for base in range(total):
            if (base // stride) % size:
                continue   # not a coordinate-zero base for this axis
            s0 = base // cps
            if any((base + c * stride) // cps != s0
                   for c in range(1, size)):
                found = True
                break
        if found:
            crossing.append(a)
    return tuple(crossing)


@dataclass
class TrainingJob:
    """Typed view over a training-job manifest (any of the four kinds)."""

    kind: str
    name: str
    namespace: str
    replica_specs: dict[str, ReplicaSpec]
    run_policy: RunPolicy = field(default_factory=RunPolicy)
    sharding: ShardingSpec = field(default_factory=ShardingSpec)
    # checkpoint/resume contract (SURVEY §5: "checkpoint-resume makes
    # slice-level failure domains cheap"): checkpointDir is where workers
    # write (rendered as KFTPU_CHECKPOINT_DIR); resumeFrom is where they
    # restore before the loop (KFTPU_RESUME_FROM) — set by the user for
    # warm starts, or by the operator on gang restart so a restarted gang
    # continues from the last step
    checkpoint_dir: str = ""
    resume_from: str = ""
    # dataset shard dir (rendered as KFTPU_DATA_DIR; the launcher.py
    # --data_dir analog) — workers train on real records when set
    data_dir: str = ""
    # held-out shard dir for the eval pass (KFTPU_EVAL_DATA_DIR)
    eval_data_dir: str = ""
    # TensorBoard event dir (KFTPU_TB_DIR) — the tensorboard component's
    # --logdir; process 0 streams scalar events there
    tensorboard_dir: str = ""
    # persistent XLA compilation cache dir (KFTPU_COMPILE_CACHE_DIR) —
    # warm restarts skip the multi-ten-second first-step compile
    # (BASELINE.md north-star #2). Defaults to a subdir of checkpointDir
    # when that is set (same volume the gang already mounts).
    compile_cache_dir: str = ""
    # input-pipeline knobs (spec.input → KFTPU_INPUT_WORKERS /
    # KFTPU_DEVICE_PREFETCH): augment worker processes and device
    # prefetch depth — the overlapped input pipeline (docs/training.md
    # "Input pipeline")
    input_spec: InputSpec = field(default_factory=InputSpec)
    # observability knobs (spec.observability → KFTPU_SPAN_PATH /
    # KFTPU_OBS_METRICS_PORT): trace-span sink and the worker's own
    # /metrics port (docs/operations.md "Observability")
    obs_spec: ObsSpec = field(default_factory=ObsSpec)
    # warm-start knobs (spec.warmStart → KFTPU_AOT / KFTPU_AOT_DIR):
    # the AOT serialized-executable rung of the warm-start ladder
    # (docs/operations.md "Warm starts and the compile cache")
    warm_start: WarmStartSpec = field(default_factory=WarmStartSpec)
    # multi-slice execution knobs (spec.multislice → KFTPU_MULTISLICE_*):
    # the MPMD pipeline-over-DCN path and its microbatch schedule
    # (docs/training.md "Multi-slice training")
    multislice: MultisliceSpec = field(default_factory=MultisliceSpec)
    # kernel-tier knobs (spec.kernels → KFTPU_KERNEL_*): which optimized
    # execution path each compute segment runs — attention / optimizer /
    # serving (docs/training.md "Kernel tier"); every set knob is baked
    # into the recipe fingerprint and AOT step key
    kernels: KernelSpec = field(default_factory=KernelSpec)
    # numeric-integrity sentinel knobs (spec.integrity →
    # KFTPU_INTEGRITY_*): in-step anomaly detectors + LKG rollback
    # (docs/operations.md "Numeric integrity"); deliberately EXCLUDED
    # from the recipe fingerprint — the sentinel changes no math
    integrity: IntegritySpec = field(default_factory=IntegritySpec)
    # gang-scheduling knobs (spec.schedulingPolicy → the slice
    # scheduler's queue/priority/preemptible; None = not
    # scheduler-managed, the legacy immediate-create path)
    scheduling_policy: Optional[SchedulingPolicy] = None
    # optimizer-update layout across data-parallel replicas (rendered as
    # KFTPU_WEIGHT_UPDATE; WEIGHT_UPDATE_MODES above):
    # "sharded" = ZeRO-2 cross-replica sharded weight update — reduce-
    # scatter grads, 1/N optimizer state per replica, all-gather params
    # (Xu et al.; PERF.md "Weight-update sharding"). "" = worker default
    # (replicated).
    weight_update: str = ""
    raw: dict = field(default_factory=dict)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_manifest(cls, obj: dict) -> "TrainingJob":
        kind = obj.get("kind", "")
        if kind not in JOB_KINDS:
            raise ValueError(f"not a training-job kind: {kind!r}")
        spec = obj.get("spec", {}) or {}
        # TFJob v1beta2 uses tfReplicaSpecs, PyTorchJob pytorchReplicaSpecs,
        # MPIJob replicas/gpus shorthand, TPUJob replicaSpecs.
        specs_key = _SPECS_KEY[kind]
        raw_specs = spec.get(specs_key) or {}
        if kind == "MPIJob" and not raw_specs:
            raw_specs = cls._mpi_shorthand(spec)
        replica_specs: dict[str, ReplicaSpec] = {}
        for rtype, rs in raw_specs.items():
            rs = rs or {}
            if rtype == "TPU" or "tpuTopology" in rs:
                raise ValueError(
                    f"{kind}: replica {rtype!r} names a TPU slice; this "
                    f"package runs a GPU replica: GPU with gpuTopology "
                    f"(e.g. h100-8)")
            topo_name = rs.get("gpuTopology")
            topo = parse_topology(topo_name) if topo_name else None
            if rtype == "GPU" and topo is None:
                raise ValueError("GPU replica spec requires gpuTopology (e.g. h100-8)")
            replica_specs[rtype] = ReplicaSpec(
                replica_type=rtype,
                replicas=int(rs.get("replicas", 1)),
                topology=topo,
                num_slices=int(rs.get("numSlices", 1)),
                template=rs.get("template") or {},
                restart_policy=rs.get(
                    "restartPolicy",
                    RESTART_POLICY_GANG if rtype == "GPU" else RESTART_POLICY_ON_FAILURE,
                ),
            )
        rp = spec.get("runPolicy", {}) or {}
        job = cls(
            kind=kind,
            name=k8s.name_of(obj),
            namespace=k8s.namespace_of(obj, "default"),
            replica_specs=replica_specs,
            run_policy=RunPolicy(
                clean_pod_policy=rp.get("cleanPodPolicy", CLEAN_POD_RUNNING),
                backoff_limit=int(rp.get("backoffLimit", 3)),
                active_deadline_seconds=rp.get("activeDeadlineSeconds"),
                gang_scheduling=bool(rp.get("gangScheduling", True)),
                ttl_seconds_after_finished=rp.get("ttlSecondsAfterFinished"),
                restart_backoff_seconds=float(
                    rp.get("restartBackoffSeconds", 0.0)),
                restart_backoff_max_seconds=float(
                    rp.get("restartBackoffMaxSeconds", 300.0)),
                stall_timeout_seconds=rp.get("stallTimeoutSeconds"),
                max_anomaly_rollbacks=int(rp.get("maxAnomalyRollbacks", 2)),
            ),
            sharding=ShardingSpec.from_dict(spec.get("sharding")),
            checkpoint_dir=spec.get("checkpointDir", "") or "",
            resume_from=spec.get("resumeFrom", "") or "",
            data_dir=spec.get("dataDir", "") or "",
            eval_data_dir=spec.get("evalDataDir", "") or "",
            tensorboard_dir=spec.get("tensorboardDir", "") or "",
            compile_cache_dir=spec.get("compileCacheDir", "") or "",
            input_spec=InputSpec.from_dict(spec.get("input")),
            obs_spec=ObsSpec.from_dict(spec.get("observability")),
            warm_start=WarmStartSpec.from_dict(spec.get("warmStart")),
            multislice=MultisliceSpec.from_dict(spec.get("multislice")),
            kernels=KernelSpec.from_dict(spec.get("kernels")),
            integrity=IntegritySpec.from_dict(spec.get("integrity")),
            scheduling_policy=SchedulingPolicy.from_dict(
                spec.get("schedulingPolicy")),
            weight_update=spec.get("weightUpdate", "") or "",
            raw=obj,
        )
        job.validate()
        return job

    @staticmethod
    def _mpi_shorthand(spec: dict) -> dict:
        """MPIJob `oneOf{gpuTopology, replicas}` shorthand → replica specs.

        Reference API shape: mpi-operator.libsonnet:27-77 (`oneOf{gpus,
        replicas}`); here `gpuTopology: h100-8` names the whole gang.
        """
        if "tpuTopology" in spec:
            raise ValueError(
                "MPIJob spec names a tpuTopology; this package runs a GPU "
                "gang: gpuTopology (e.g. h100-8)")
        if "gpuTopology" in spec:
            return {"GPU": {"gpuTopology": spec["gpuTopology"],
                            "numSlices": spec.get("numSlices", 1),
                            "template": spec.get("template", {})}}
        if "replicas" in spec:
            return {"Launcher": {"replicas": 1, "template": spec.get("template", {})},
                    "Worker": {"replicas": int(spec["replicas"]),
                               "template": spec.get("template", {})}}
        raise ValueError("MPIJob spec requires one of gpuTopology or replicas")

    # -- validation ---------------------------------------------------------

    # Derived names ("<name>-worker-<slice>-<host>" pod hostnames,
    # "<name>-workers" service) must each fit a 63-char DNS label; reserve
    # headroom for the longest suffix the operator generates.
    MAX_NAME_LEN = 45

    def validate(self) -> None:
        k8s.validate_name(self.name, max_len=self.MAX_NAME_LEN)
        if self.weight_update:
            # admission-time rejection: a typo'd mode must fail at apply,
            # not at worker startup deep inside the gang
            validate_weight_update(self.weight_update)
        self.input_spec.validate()
        self.obs_spec.validate()
        self.warm_start.validate()
        self.multislice.validate()
        self.kernels.validate()
        self.integrity.validate()
        if self.scheduling_policy is not None:
            self.scheduling_policy.validate()
        vocab = REPLICA_TYPES[self.kind]
        if not self.replica_specs:
            raise ValueError(f"{self.kind} {self.name}: no replica specs")
        for rtype, rs in self.replica_specs.items():
            if rtype not in vocab:
                raise ValueError(
                    f"{self.kind} {self.name}: invalid replica type {rtype!r}; "
                    f"valid: {vocab}"
                )
            if rtype in _MAX_ONE and rs.replicas > 1:
                raise ValueError(f"{self.kind} {self.name}: at most one {rtype} replica")
            if rs.is_gpu:
                if rs.topology is None:
                    raise ValueError(
                        f"{self.kind} {self.name}: GPU replica spec requires "
                        "gpuTopology (e.g. h100-8)")
                # Resolving the sharding spec against the slice validates the
                # axis product here, at admission time, not at runtime.
                sizes = self.sharding.resolve(
                    rs.topology.num_gpus * rs.num_slices)
                if rs.num_slices > 1:
                    # DCN-aware layout rejection: a tensor/sequence axis
                    # crossing the slice boundary puts PER-LAYER
                    # collectives on the slow link and forces the SPMD
                    # partitioner's involuntary-full-rematerialization
                    # fallback (MULTICHIP_r05) — reject at apply, not at
                    # compile deep inside the gang.
                    bad = tuple(a for a in dcn_crossing_axes(
                        sizes, rs.num_slices)
                        if a not in DCN_LEGAL_AXES)
                    if bad:
                        raise ValueError(
                            f"{self.kind} {self.name}: sharding axes "
                            f"{list(bad)} would cross the DCN slice "
                            f"boundary ({rs.num_slices} slices x "
                            f"{rs.topology.num_gpus} GPUs); only "
                            f"{list(DCN_LEGAL_AXES)} may span slices — "
                            f"move the parallelism intra-slice or use "
                            f"spec.multislice.pipeline")
                if self.multislice.pipeline_enabled and rs.num_slices < 2:
                    raise ValueError(
                        f"{self.kind} {self.name}: "
                        f"multislice.pipeline requires numSlices >= 2 "
                        f"(one program per slice needs slices to "
                        f"program)")
                policy = self.scheduling_policy
                if policy is not None and policy.elastic:
                    # Elastic admission contract: the nominal shape must
                    # sit inside its own [min, max] envelope, and the
                    # sharding must leave a data-parallel axis as the -1
                    # wildcard — a resized gang re-resolves the mesh
                    # against its new chip count, which a fully pinned
                    # axis product cannot do. Rejected at apply, not at
                    # the first resize deep inside the scheduler.
                    nominal = rs.topology.num_gpus * rs.num_slices
                    lo, hi = policy.chip_bounds(nominal)
                    if not lo <= nominal <= hi:
                        raise ValueError(
                            f"{self.kind} {self.name}: nominal gang size "
                            f"{nominal} chips outside schedulingPolicy "
                            f"minChips/maxChips [{lo}, {hi}]")
                    sizes = self.sharding.axis_sizes()
                    if sizes.get("data") != -1 and sizes.get("fsdp") != -1:
                        raise ValueError(
                            f"{self.kind} {self.name}: elastic resizing "
                            "(minChips/maxChips) requires a -1 wildcard "
                            "on the data or fsdp sharding axis — a "
                            "pinned axis product cannot follow the "
                            "resized chip count")
                    # ...and EVERY shape inside the envelope must
                    # resolve: the scheduler may legally bind any
                    # supported slice size in [min, max], and a fixed
                    # axis product (e.g. tensor=4) that does not divide
                    # one of them would crash-loop the gang at the
                    # scheduler-chosen shape — reject at apply, not at
                    # the first resize
                    for c in rs.topology.generation.supported_gpu_counts:
                        total = c * rs.num_slices
                        if not lo <= total <= hi:
                            continue
                        try:
                            self.sharding.resolve(total)
                        except ValueError as e:
                            raise ValueError(
                                f"{self.kind} {self.name}: elastic "
                                f"envelope admits a {total}-chip gang "
                                f"the sharding spec cannot resolve "
                                f"({e}); tighten minChips/maxChips or "
                                f"relax the pinned axes") from None
        if "GPU" in self.replica_specs and not self.run_policy.gang_scheduling:
            raise ValueError(
                f"{self.kind} {self.name}: GPU replicas require gangScheduling "
                "(the slice is the atomic unit)"
            )

    # -- helpers ------------------------------------------------------------

    @property
    def gpu_spec(self) -> Optional[ReplicaSpec]:
        return self.replica_specs.get("GPU")

    def total_pods(self) -> int:
        return sum(rs.pod_count for rs in self.replica_specs.values())

    def selector(self) -> dict[str, str]:
        return {"kubeflow.org/job-name": self.name,
                "kubeflow.org/job-kind": self.kind.lower()}

    def to_manifest(self) -> dict:
        """Serialize from the typed fields (always — a job parsed from a
        manifest and then mutated must serialize its mutations). Metadata
        extras from the source manifest (labels, uid, ...) are preserved."""
        api_version = API_VERSIONS[self.kind]
        specs_key = _SPECS_KEY[self.kind]
        out = k8s.make(
            api_version, self.kind, self.name, self.namespace,
            spec={
                specs_key: {t: rs.to_dict() for t, rs in self.replica_specs.items()},
                "runPolicy": self.run_policy.to_dict(),
                "sharding": self.sharding.to_dict(),
            },
        )
        if self.checkpoint_dir:
            out["spec"]["checkpointDir"] = self.checkpoint_dir
        if self.resume_from:
            out["spec"]["resumeFrom"] = self.resume_from
        if self.data_dir:
            out["spec"]["dataDir"] = self.data_dir
        if self.eval_data_dir:
            out["spec"]["evalDataDir"] = self.eval_data_dir
        if self.tensorboard_dir:
            out["spec"]["tensorboardDir"] = self.tensorboard_dir
        if self.compile_cache_dir:
            out["spec"]["compileCacheDir"] = self.compile_cache_dir
        if self.input_spec.to_dict():
            out["spec"]["input"] = self.input_spec.to_dict()
        if self.obs_spec.to_dict():
            out["spec"]["observability"] = self.obs_spec.to_dict()
        if self.warm_start.to_dict():
            out["spec"]["warmStart"] = self.warm_start.to_dict()
        if self.multislice.to_dict():
            out["spec"]["multislice"] = self.multislice.to_dict()
        if self.kernels.to_dict():
            out["spec"]["kernels"] = self.kernels.to_dict()
        if self.integrity.to_dict():
            out["spec"]["integrity"] = self.integrity.to_dict()
        if self.scheduling_policy is not None:
            out["spec"]["schedulingPolicy"] = self.scheduling_policy.to_dict()
        if self.weight_update:
            out["spec"]["weightUpdate"] = self.weight_update
        if self.raw:
            out["apiVersion"] = self.raw.get("apiVersion", out["apiVersion"])
            meta = dict(self.raw.get("metadata", {}))
            meta.update(out["metadata"])
            out["metadata"] = meta
            if "status" in self.raw:
                out["status"] = self.raw["status"]
        return out
