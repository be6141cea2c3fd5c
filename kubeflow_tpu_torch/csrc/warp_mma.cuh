// Warp-level building blocks for the bf16 tensor-core kernels on Hopper
// (sm_90a): the `mma.sync.m16n8k16` product, `ldmatrix` fragment loads,
// 16- and 4-byte `cp.async` copies into shared memory with zero-fill, a
// row-tile stager built on them, packing two f32 into a bf16 pair, and
// the 16-byte epilogue store of a warp's accumulator rows. tc_gemm.cuh
// (the K4/K5 backward) and the bf16 flash-attention kernels (K1, K2a, K2b)
// share them, wgmma_gemm.cuh (K6, the K4/K5 forward) its `cp.async` and
// packing, and the FMA flash kernels its to_f32 / from_f32.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
// - A (16 x 16, row major), 4 registers of 2 bf16: a0 (g, 2t..2t+1),
//   a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..).
// - B (16 x 8, k by n), 2 registers: b0 (k 2t..2t+1, n g), b1 (k 2t + 8..,
//   n g).
// - C (16 x 8, f32), 4 values: c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..).
// So the C fragments of two neighbouring n8 tiles, packed to bf16 pairs,
// are the A fragment of a product that contracts over those 16 columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// the FMA flash kernels' loads and stores in their input type
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 o;
  o.x = pack2(v[0], v[1]);
  o.y = pack2(v[2], v[3]);
  o.z = pack2(v[4], v[5]);
  o.w = pack2(v[6], v[7]);
  return o;
}

// c += a.b, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i (16 bytes each), and r[i] receives its fragment: lane l holds
// row l / 4, columns 2 (l % 4)..+1 (with .trans: column l / 4, rows
// 2 (l % 4)..+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes from global to shared memory, asynchronously; `valid` false
// reads nothing and writes zeros (src-size 0), for the ragged edge.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile(
      "cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + ROWS) of a [.., S, .., D] bf16 input whose rows are
// `stride` elements apart into dst[ROWS][DMAX + 8], asynchronously; rows
// >= S and 8-column chunks >= D are zero-filled
template <int ROWS, int DMAX>
__device__ __forceinline__ void stage_rows(bf16 (*dst)[DMAX + 8],
                                           const bf16* src, int64_t stride,
                                           int row0, int S, int D) {
  constexpr int CH = DMAX / 8;
  for (int u = threadIdx.x; u < ROWS * CH; u += blockDim.x) {
    const int r = u / CH, c = (u % CH) * 8;
    const int row = row0 + r;
    const bool ok = row < S && c < D;
    cp_async16(&dst[r][c], ok ? src + row * stride + c : src, ok);
  }
}

// The blocks of the bf16 flash kernels: 8 warps of 16 rows each
constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr float LOG2E = 1.4426950408889634f;

// A warp's 16 x DMAX f32 accumulator tile `acc` (DMAX / 8 C fragments),
// rows g times `lo` and rows g + 8 times `hi`, rounded to bf16 into `buf`,
// 16 rows of shared memory that only this warp uses, then written with
// 16-byte stores to rows [row0, row0 + 16) of a bf16 output whose rows
// are `stride` elements apart; rows >= S and 8-column chunks >= D are
// not written
template <int DMAX>
__device__ __forceinline__ void store_rows_16B(bf16* dst, int64_t stride,
                                               int row0, int S, int D,
                                               bf16 (*buf)[DMAX + 8],
                                               const float (*acc)[4],
                                               float lo, float hi) {
  constexpr int CH = DMAX / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < CH; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(&buf[g][c]) =
        pack2(acc[n][0] * lo, acc[n][1] * lo);
    *reinterpret_cast<uint32_t*>(&buf[g + 8][c]) =
        pack2(acc[n][2] * hi, acc[n][3] * hi);
  }
  __syncwarp();
  for (int u = lane; u < 16 * CH; u += 32) {
    const int r = u / CH, c = (u % CH) * 8;
    const int row = row0 + r;
    if (row < S && c < D)
      *reinterpret_cast<uint4*>(dst + row * stride + c) =
          *reinterpret_cast<const uint4*>(&buf[r][c]);
  }
}

// The head dims the bf16 tensor-core flash kernels take (16-byte copies,
// DMAX <= 128); the FMA kernels take the others on bf16 inputs
inline bool tensor_core_dim(int D) { return D % 8 == 0 && D <= 128; }

// What the 16-byte copies of a [B, S, H, D] input need: a 16-byte aligned
// pointer and (batch, seq, head) strides `s` (in elements) that are
// multiples of 8 wherever their dim has more than one index.
inline bool async_ready(const void* p, const int64_t* s, int B, int S,
                        int H) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && !(B > 1 && s[0] % 8) &&
         !(S > 1 && s[1] % 8) && !(H > 1 && s[2] % 8);
}

}  // namespace
