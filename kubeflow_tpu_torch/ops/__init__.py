"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- :mod:`flash_attention` — fused attention: the forward (K1,
  csrc/flash_attention_fwd.cu) and the backward (K2a dq and K2b dk/dv,
  csrc/flash_attention_bwd.cu) as CUDA kernels for sm_90a, the
  counterparts of the JAX package's Pallas ``_fwd_kernel``,
  ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``, joined by a
  ``torch.autograd.Function``.
- :mod:`fused_adam` — the fused Adam update (K3, csrc/fused_adam.cu), the
  counterpart of the Pallas ``_adam_kernel``, and the ``FusedAdam``
  optimizer around it.
- :mod:`fused_block_train` and :mod:`fused_block_train_spatial` — the
  fused ghost-BN ResNet bottleneck for training, batch-tiled (K4) and
  (batch x row-strip)-tiled with a 1-row halo (K5), forward and backward,
  one CUDA implementation (csrc/fused_block_train.cu), the counterparts of
  the Pallas kernels of the same modules.
- :mod:`fused_block` — the fused ResNet bottleneck for inference, BN
  folded to an affine (K6, csrc/fused_block.cu), the counterpart of the
  Pallas ``_kernel`` of ``kubeflow_tpu/ops/fused_block.py``; run by
  ``models/resnet.py`` ``fused_eval_apply``. K4–K6 share the pipelined
  bf16 tensor-core product of csrc/tc_gemm.cuh.
- :mod:`_build` — builds ``csrc/*.cu`` with nvcc and loads them with
  ctypes.
"""

from .flash_attention import flash_attention, reference_attention  # noqa: F401
from .fused_adam import FusedAdam, fused_adam  # noqa: F401
