"""The card's spec sheet and the FLOP model the perf surfaces share
(``workflows/kubebench.py`` matrix rows).

The port of ``kubeflow_tpu/utils/chips.py``, for NVIDIA cards: the same
names, keyed by the name ``torch.cuda.get_device_name`` gives. One table,
so the MFU denominator never disagrees between reports. The CPU, and a
card the table does not know, get no peak and so no MFU.
"""

from __future__ import annotations

from typing import Optional

import torch

# The port's first light: ResNet-50 on the default path (exact BN,
# cuDNN), 224 px, batch 64, synthetic data, through runtime/worker.py
# train() on one NVIDIA H100 80GB HBM3 at a 700 W power limit, as
# chip_smoke.py's phase 6 measures it. The vs_baseline denominator of the
# kubebench matrix. The JAX package's value was measured at batch 256 on
# another accelerator and is not used here.
BASELINE_IMG_S = 757.2

# dense bf16 tensor-core peak TFLOP/s by device-name substring (NVIDIA
# datasheets): "NVIDIA H100 80GB HBM3" is the SXM5 part
PEAK_TFLOPS = {
    "h100 80gb hbm3": 989.4,
}

# ResNet-50 @224 fwd ≈ 4.09 GFLOP/image; fwd+bwd ≈ 3x fwd (dgrad + wgrad
# each cost ~one fwd). Conventional MFU flop model (matmul/conv MACs only).
RESNET50_TRAIN_GFLOP_PER_IMAGE = 3 * 4.09


def device_kind(device) -> str:
    """The card's name, as ``torch.cuda.get_device_name`` gives it;
    "cpu" for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    return torch.cuda.get_device_name(dev)


def detect_peak_tflops(device) -> Optional[float]:
    """Spec-sheet bf16 peak for a torch device, by the longest name
    substring that matches; None on the CPU and for an unknown card."""
    if torch.device(device).type != "cuda":
        return None
    kind = device_kind(device).lower()
    for key in sorted(PEAK_TFLOPS, key=len, reverse=True):
        if key in kind:
            return PEAK_TFLOPS[key]
    return None


def resnet50_train_mfu(images_per_sec_per_chip: float,
                       device) -> Optional[float]:
    peak = detect_peak_tflops(device)
    if not peak:
        return None
    flops = images_per_sec_per_chip * RESNET50_TRAIN_GFLOP_PER_IMAGE * 1e9
    return flops / (peak * 1e12)
