"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- :mod:`flash_attention` — fused attention forward, a CUDA kernel for
  sm_90a (csrc/flash_attention_fwd.cu), the counterpart of the JAX
  package's Pallas ``_fwd_kernel``.
- :mod:`_build` — builds ``csrc/*.cu`` with nvcc and loads them with
  ctypes.
"""

from .flash_attention import flash_attention, reference_attention  # noqa: F401
