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
- :mod:`_build` — builds ``csrc/*.cu`` with nvcc and loads them with
  ctypes.
"""

from .flash_attention import flash_attention, reference_attention  # noqa: F401
from .fused_adam import FusedAdam, fused_adam  # noqa: F401
