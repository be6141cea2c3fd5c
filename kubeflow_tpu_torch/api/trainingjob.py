"""Job-spec vocabularies the training path validates against.

The port's copy of what it needs from ``kubeflow_tpu/api/trainingjob.py``:
the weight-update layouts (``spec.weightUpdate``), the kernel-tier
vocabularies (``spec.kernels``), the pod annotations the worker patches
(``HEARTBEAT_ANNOTATION``, ``ANOMALY_ANNOTATION``) and ``ShardingSpec``
(``spec.sharding``), with the same values, so a manifest admitted by the
JAX package's operator selects the same path here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# How the worker lays the optimizer update out across data-parallel
# replicas: "replicated" = every device holds the full optimizer state
# after a gradient all-reduce; "sharded" = ZeRO-2 (reduce-scatter
# gradients, each replica updates a 1/N shard, all-gather the params).
WEIGHT_UPDATE_MODES = ("replicated", "sharded")


def validate_weight_update(mode: str) -> str:
    if mode not in WEIGHT_UPDATE_MODES:
        raise ValueError(
            f"weight_update {mode!r} not one of {WEIGHT_UPDATE_MODES}")
    return mode


# Kernel tiers (spec.kernels → KFTPU_KERNEL_*): which attention the
# transformer workloads run, whether the optimizer update runs as the
# fused kernel or the stock chain, and whether a served model is
# int8-quantized behind the parity gate.
ATTENTION_KERNELS = ("einsum", "flash", "ring")
OPTIMIZER_KERNELS = ("stock", "fused_adam")
SERVING_KERNELS = ("stock", "int8")


# The worker's liveness annotation on its own pod (runtime/metrics.py
# HeartbeatReporter): JSON {"step", "time", "lastLoss"?, "lastGradNorm"?},
# the two optional values as repr() strings so NaN and Inf survive strict
# JSON parsers. The operator's stall watchdog reads it.
HEARTBEAT_ANNOTATION = "kubeflow.org/worker-heartbeat"

# The numeric-integrity evidence a worker posts on its own pod before it
# exits for an anomaly (the sentinel is not ported yet; the channel is,
# through HeartbeatReporter.annotate).
ANOMALY_ANNOTATION = "kubeflow.org/numeric-anomaly"


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
