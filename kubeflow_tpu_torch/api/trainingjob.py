"""Job-spec vocabularies the training path validates against.

The port's copy of ``kubeflow_tpu/api/trainingjob.py:50-70``: the
weight-update layouts (``spec.weightUpdate``) and the kernel-tier
vocabularies (``spec.kernels``), with the same values, so a manifest
admitted by the JAX package's operator selects the same path here.
"""

from __future__ import annotations

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
