// Fused Adam update for Hopper (sm_90a), behind a plain C interface that
// kubeflow_tpu_torch/ops/fused_adam.py binds with ctypes.
//
// Replaces: kubeflow_tpu/ops/fused_adam.py `_adam_kernel`, run per leaf by
// `_fused_leaf_update` through `pl.pallas_call`, and the
// `optax.clip_by_global_norm` before it in the recipe's chain. Same
// function, per element of every parameter tensor of one optimizer step:
//
//     g  <- (norm < max_norm) ? g : (g / norm) * max_norm   (optax's clip)
//     g  <- g + wd * p                  (L2 folded into the gradient)
//     m' =  b1 * m + (1 - b1) * g
//     v' =  b2 * v + (1 - b2) * g * g
//     dp = -lr * (m' / bc1) / (sqrt(v' / bc2) + eps)
//
// with f32 moments. The clip is optional: it reads the pre-clip global
// norm from device memory (computed once a step by the caller), so the
// host never waits for it, and it keeps optax's trigger and rounding
// order, division first. The TPU kernel emits dp and leaves `p + dp` to
// the next op (optax.apply_updates); this kernel writes p + dp in place
// of p, the same f32 sum, so the update reads p, g, m, v once and writes
// p, m, v once (28 bytes per element). lr, bc1 and bc2 are launch
// arguments (the TPU kernel's SMEM scalars), wd one per tensor (the decay
// mask); b1, b2 and eps are fixed by the optimizer. (1 - b1) and (1 - b2)
// arrive computed on the host, as the JAX code computes them from Python
// floats.
//
// What bounds it on the H100: about 15 FLOPs per 28 bytes, so the memory
// rate (3.35 TB/s) bounds it. The design:
// - One launch over every tensor of the step: a table of (p, g, m, v,
//   length, wd) entries goes in as one `__grid_constant__` parameter
//   (CAPACITY entries, about 19.5 KB of the 32,764 bytes sm_90 takes
//   since CUDA 12.1). Only past CAPACITY tensors does the host launch
//   again.
// - Each block takes one fixed chunk of CHUNK elements of one tensor; the
//   table holds the prefix sum of the tensors' chunk counts, and a block
//   finds its tensor by binary search over it. (Blocks that take 4, 8 or
//   32 chunks, or streaming cache hints, measured no faster.)
// - Neighbouring threads read neighbouring 16-byte vectors, each thread 4
//   of them per operand, all loaded before any is computed; a tensor
//   whose four pointers are not 16-byte aligned takes 4-byte accesses,
//   and so does the last partial vector of a tensor. The ragged edge is a
//   bounds check (the TPU's (8, 128) zero padding has no counterpart).
// - Each operation is rounded on its own (no FMA contraction), as the
//   plain PyTorch version rounds it, so the two agree to the last bit
//   except where sqrt or division differ.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;         // floats in a 16-byte access
constexpr int PER_THREAD = 4;  // 16-byte accesses per thread and operand
constexpr int CHUNK = THREADS * VEC * PER_THREAD;  // elements per block
constexpr int CAPACITY = 384;  // tensors per launch

struct Entry {
  float* p;
  const float* g;
  float* m;
  float* v;
  int64_t n;
  float wd;
  int vec;  // all four pointers 16-byte aligned
};

struct Table {
  Entry e[CAPACITY];
  int first[CAPACITY];  // the first block of each entry's chunks
  int count;
};

struct Hyper {
  float lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps, max_norm;
};

__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     float wd, const Hyper& h, bool clip,
                                     float norm) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, norm), h.max_norm);
  g = __fadd_rn(g, __fmul_rn(wd, p));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v),
                __fmul_rn(h.one_minus_b2, __fmul_rn(g, g)));
  const float step =
      __fdiv_rn(__fmul_rn(-h.lr, __fdiv_rn(m, h.bc1)),
                __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  p = __fadd_rn(p, step);
}

__device__ __forceinline__ void adam4(float4& p, float4 g, float4& m,
                                      float4& v, float wd, const Hyper& h,
                                      bool clip, float norm) {
  adam(p.x, g.x, m.x, v.x, wd, h, clip, norm);
  adam(p.y, g.y, m.y, v.y, wd, h, clip, norm);
  adam(p.z, g.z, m.z, v.z, wd, h, clip, norm);
  adam(p.w, g.w, m.w, v.w, wd, h, clip, norm);
}

__global__ void __launch_bounds__(THREADS)
fused_adam_kernel(const __grid_constant__ Table t,
                  const float* __restrict__ norm_ptr, const Hyper h) {
  // this block's tensor: the last entry whose first block is <= it
  const int blk = blockIdx.x;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= blk)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Entry& e = t.e[lo];
  const int64_t start = static_cast<int64_t>(blk - t.first[lo]) * CHUNK;
  const int64_t end = min(start + CHUNK, e.n);
  // optax's clip_by_global_norm: g stays as it is while norm < max_norm
  const float norm = norm_ptr != nullptr ? *norm_ptr : 0.f;
  const bool clip = norm_ptr != nullptr && !(norm < h.max_norm);

  if (!e.vec) {
    for (int64_t i = start + threadIdx.x; i < end; i += THREADS)
      adam(e.p[i], e.g[i], e.m[i], e.v[i], e.wd, h, clip, norm);
    return;
  }
  // one pass: written as a loop, nvcc keeps the loaded vectors in
  // registers; written without one, it stored them on the local stack
  // around the division's slow-path calls and the kernel ran 1.8x slower
  for (int64_t base = start; base < end; base += CHUNK) {
    float4 p[PER_THREAD], g[PER_THREAD], m[PER_THREAD], v[PER_THREAD];
#pragma unroll
    for (int u = 0; u < PER_THREAD; ++u) {
      const int64_t i = base + (u * THREADS + threadIdx.x) * VEC;
      if (i + VEC <= end) {
        p[u] = *reinterpret_cast<const float4*>(e.p + i);
        g[u] = *reinterpret_cast<const float4*>(e.g + i);
        m[u] = *reinterpret_cast<const float4*>(e.m + i);
        v[u] = *reinterpret_cast<const float4*>(e.v + i);
      }
    }
#pragma unroll
    for (int u = 0; u < PER_THREAD; ++u) {
      const int64_t i = base + (u * THREADS + threadIdx.x) * VEC;
      if (i + VEC <= end) {
        adam4(p[u], g[u], m[u], v[u], e.wd, h, clip, norm);
        *reinterpret_cast<float4*>(e.p + i) = p[u];
        *reinterpret_cast<float4*>(e.m + i) = m[u];
        *reinterpret_cast<float4*>(e.v + i) = v[u];
      } else {  // the tensor's last partial vector, if any
        for (int64_t j = i; j < end; ++j)
          adam(e.p[j], e.g[j], e.m[j], e.v[j], e.wd, h, clip, norm);
      }
    }
  }
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

}  // namespace

// One Adam step over `count` f32 tensors, updated in place (p, m, v):
// `ptrs` holds 4 * count addresses (p, g, m, v of each tensor, contiguous
// f32), `ns` their lengths and `wds` their weight decays. `norm`, when
// not null, is a device pointer to the pre-clip global norm, and the
// gradients are clipped to `max_norm` first. Launches once per CAPACITY
// tensors (tensors of length 0 are skipped) on `stream` and writes the
// number of launches to `launched`. Returns the first failing launch's
// cudaError_t; the caller checks it.
extern "C" int kftpu_fused_adam(const int64_t* ptrs, const int64_t* ns,
                                const float* wds, int count,
                                const float* norm, float max_norm, float lr,
                                float bc1, float bc2, float b1,
                                float one_minus_b1, float b2,
                                float one_minus_b2, float eps, void* stream,
                                int* launched) {
  const Hyper h{lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps,
                max_norm};
  Table t;
  *launched = 0;
  int i = 0;
  while (i < count) {
    t.count = 0;
    int64_t blocks = 0;
    for (; i < count && t.count < CAPACITY; ++i) {
      const int64_t n = ns[i], chunks = (n + CHUNK - 1) / CHUNK;
      if (n <= 0) continue;
      if (blocks + chunks > INT_MAX) break;  // the next launch takes it
      Entry& e = t.e[t.count];
      e.p = reinterpret_cast<float*>(ptrs[4 * i]);
      e.g = reinterpret_cast<const float*>(ptrs[4 * i + 1]);
      e.m = reinterpret_cast<float*>(ptrs[4 * i + 2]);
      e.v = reinterpret_cast<float*>(ptrs[4 * i + 3]);
      e.n = n;
      e.wd = wds[i];
      e.vec = aligned16(e.p) && aligned16(e.g) && aligned16(e.m) &&
              aligned16(e.v);
      t.first[t.count++] = static_cast<int>(blocks);
      blocks += chunks;
    }
    if (t.count == 0) {
      if (i < count && ns[i] > 0) return cudaErrorInvalidValue;  // too long
      continue;
    }
    fused_adam_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(t, norm, h);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  return cudaSuccess;
}

extern "C" const char* kftpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
