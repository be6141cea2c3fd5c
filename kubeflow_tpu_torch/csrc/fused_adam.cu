// Fused Adam update for Hopper (sm_90a), behind a plain C interface that
// kubeflow_tpu_torch/ops/fused_adam.py binds with ctypes.
//
// Replaces: kubeflow_tpu/ops/fused_adam.py `_adam_kernel`, run per leaf by
// `_fused_leaf_update` through `pl.pallas_call`. Same function, per
// element of one parameter tensor:
//
//     g  <- g + wd * p                  (L2 folded into the gradient)
//     m' =  b1 * m + (1 - b1) * g
//     v' =  b2 * v + (1 - b2) * g * g
//     dp = -lr * (m' / bc1) / (sqrt(v' / bc2) + eps)
//
// with f32 moments. The TPU kernel emits dp and leaves `p + dp` to the
// next op (optax.apply_updates); this kernel writes p + dp in place of p,
// the same f32 sum, so the update reads p, g, m, v once and writes p, m,
// v once (28 bytes per element). lr, wd, bc1 and bc2 are launch
// arguments (the TPU kernel's SMEM scalars); b1, b2 and eps are fixed by
// the optimizer. (1 - b1) and (1 - b2) arrive computed on the host, as
// the JAX code computes them from Python floats.
//
// What bounds it on the H100: about 15 FLOPs per 28 bytes, so the memory
// rate (3.35 TB/s) bounds it. The design is a grid-stride loop over the
// flat length: neighbouring threads read neighbouring elements, every
// operand is touched once, and the ragged edge is a bounds check (the
// TPU's (8, 128) zero padding has no counterpart). Each operation is
// rounded on its own (no FMA contraction), as the plain PyTorch version
// rounds it, so the two agree to the last bit except where sqrt or
// division differ. One launch per tensor; one launch over all tensors is
// a later step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;  // 8 resident blocks on each of 132 SMs

__global__ void __launch_bounds__(THREADS)
fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                  float* __restrict__ m, float* __restrict__ v, int64_t n,
                  float lr, float wd, float bc1, float bc2, float b1,
                  float one_minus_b1, float b2, float one_minus_b2,
                  float eps) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const float pi = p[i];
    const float gi = __fadd_rn(g[i], __fmul_rn(wd, pi));
    const float mi = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(one_minus_b1, gi));
    const float vi = __fadd_rn(__fmul_rn(b2, v[i]),
                               __fmul_rn(one_minus_b2, __fmul_rn(gi, gi)));
    const float step = __fdiv_rn(__fmul_rn(-lr, __fdiv_rn(mi, bc1)),
                                 __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, bc2)), eps));
    p[i] = __fadd_rn(pi, step);
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

// p, g, m, v: contiguous f32 of n elements each, updated in place (p, m,
// v). Returns the launch's cudaError_t; the caller checks it.
extern "C" int kftpu_fused_adam(float* p, const float* g, float* m, float* v,
                                int64_t n, float lr, float wd, float bc1,
                                float bc2, float b1, float one_minus_b1,
                                float b2, float one_minus_b2, float eps,
                                void* stream) {
  if (n <= 0) return cudaSuccess;
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  fused_adam_kernel<<<static_cast<int>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      p, g, m, v, n, lr, wd, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2,
      eps);
  return cudaGetLastError();
}

extern "C" const char* kftpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
