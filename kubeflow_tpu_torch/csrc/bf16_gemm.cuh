// The bf16 tensor-core product that the ResNet bottleneck kernels share
// (fused_block_train.cu: K4/K5; fused_block.cu: K6): C[M, N] = sum_k
// A(m, k) B(k, n), bf16 operands, f32 accumulators, on Hopper's
// `mma.sync.m16n8k16` (the wrapper and `pack2` are in warp_mma.cuh).
//
// Operands reach the product through loaders: `load8(row, col, o)` gives
// 8 bf16 of a logical matrix whose `col` index is contiguous (col % 8 ==
// 0), so a loader can apply an affine, a relu, a rounding or an image-edge
// mask on its way into shared memory. Results leave through epilogues:
// `ep(split, row, col, v[col], v[col + 1])`. A block of 256 threads owns a
// 128 x 64 output tile and walks k in steps of 32, staging A and B through
// shared memory with plain loads (no asynchronous copies yet).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

struct LdBf16 {  // plain row-major bf16 [rows, ld]
  const bf16* p;
  int ld;
  __device__ __forceinline__ void load8(int64_t row, int col, uint4& o) const {
    o = *reinterpret_cast<const uint4*>(p + row * ld + col);
  }
};

constexpr int BM = 128, BN = 64, BK = 32, LDS = BK + 8;
constexpr int GEMM_THREADS = 256;

typedef float Acc[2][4][4];  // a warp's 32 x 32 share of the block tile

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc += the block tile (m0, n0) of A.B over k in [kbeg, kend). A_K: A's
// loader walks k contiguously (load8(m, k)); otherwise it walks m (load8(k,
// m), the wgrad form). B_K: B's loader walks k (load8(n, k)); otherwise n
// (load8(k, n)). Needs M % 8 == 0 when A walks m, N % 8 == 0, K % 8 == 0
// when a loader walks k. Every thread of the block must call it.
template <bool A_K, bool B_K, class LA, class LB>
__device__ __forceinline__ void gemm_mainloop(const LA& la, const LB& lb,
                                              int64_t m0, int n0, int64_t M,
                                              int N, int64_t kbeg,
                                              int64_t kend, bf16 (*As)[LDS],
                                              bf16 (*Bs)[LDS], Acc& acc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  for (int64_t k0 = kbeg; k0 < kend; k0 += BK) {
#pragma unroll
    for (int u = tid; u < BM * BK / 8; u += GEMM_THREADS) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (A_K) {
        const int mm = u >> 2, kg = (u & 3) * 8;
        const int64_t m = m0 + mm, k = k0 + kg;
        if (m < M && k < kend) la.load8(m, static_cast<int>(k), v);
        *reinterpret_cast<uint4*>(&As[mm][kg]) = v;
      } else {
        const int kk = u >> 4, mg = (u & 15) * 8;
        const int64_t k = k0 + kk, m = m0 + mg;
        if (k < kend && m < M) la.load8(k, static_cast<int>(m), v);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) As[mg + i][kk] = e[i];
      }
    }
    {
      const int u = tid;  // BN * BK / 8 == GEMM_THREADS
      uint4 v = make_uint4(0, 0, 0, 0);
      if (B_K) {
        const int nn = u >> 2, kg = (u & 3) * 8;
        const int n = n0 + nn;
        const int64_t k = k0 + kg;
        if (n < N && k < kend) lb.load8(n, static_cast<int>(k), v);
        *reinterpret_cast<uint4*>(&Bs[nn][kg]) = v;
      } else {
        const int kk = u >> 3, ng = (u & 7) * 8;
        const int n = n0 + ng;
        const int64_t k = k0 + kk;
        if (k < kend && n < N) lb.load8(k, n, v);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) Bs[ng + i][kk] = e[i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bfr[4][2];
      const int col = kk + (lane & 3) * 2;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row = wm * 32 + mi * 16 + (lane >> 2);
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[row][col]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[row + 8][col]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[row][col + 8]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[row + 8][col + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + (lane >> 2);
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][col]);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][col + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }
}

// Calls f(row, col, i, j, e) for each pair (acc[i][j][e], acc[i][j][e + 1]),
// e in {0, 2}, of this thread's share of the block tile that lies inside
// [M, N): the pair's values belong to (row, col) and (row, col + 1).
template <class F>
__device__ __forceinline__ void for_each_pair(int64_t m0, int n0, int64_t M,
                                              int N, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int64_t row = m0 + wm * 32 + mi * 16 + (lane >> 2);
      const int col = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
      if (col >= N) continue;
      if (row < M) f(row, col, mi, ni, 0);
      if (row + 8 < M) f(row + 8, col, mi, ni, 2);
    }
  }
}

// Blocks: (N tiles, M tiles, K splits); split z covers k in [z * kchunk,
// (z + 1) * kchunk), kchunk % BK == 0.
template <bool A_K, bool B_K, class LA, class LB, class EP>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(LA la, LB lb, EP ep, int64_t M, int N, int64_t K,
            int64_t kchunk) {
  __shared__ __align__(16) bf16 As[BM][LDS];
  __shared__ __align__(16) bf16 Bs[BN][LDS];
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int z = blockIdx.z;
  const int64_t kbeg = z * kchunk;
  const int64_t kend = kbeg + kchunk < K ? kbeg + kchunk : K;
  Acc acc;
  zero_acc(acc);
  gemm_mainloop<A_K, B_K>(la, lb, m0, n0, M, N, kbeg, kend, As, Bs, acc);
  for_each_pair(m0, n0, M, N,
                [&](int64_t row, int col, int mi, int ni, int e) {
                  ep(z, row, col, acc[mi][ni][e], acc[mi][ni][e + 1]);
                });
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int blocks_for(int64_t n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

dim3 gemm_grid(int64_t M, int N, int splits) {
  return dim3((N + BN - 1) / BN, static_cast<unsigned>((M + BM - 1) / BM),
              splits);
}

template <bool A_K, bool B_K, class LA, class LB, class EP>
cudaError_t gemm(LA la, LB lb, EP ep, int64_t M, int N, int64_t K,
                 int splits, int64_t kchunk, cudaStream_t st) {
  gemm_kernel<A_K, B_K><<<gemm_grid(M, N, splits), GEMM_THREADS, 0, st>>>(
      la, lb, ep, M, N, K, kchunk);
  return cudaGetLastError();
}

template <bool A_K, bool B_K, class LA, class LB, class EP>
cudaError_t gemm_full(LA la, LB lb, EP ep, int64_t M, int N, int64_t K,
                      cudaStream_t st) {
  const int64_t chunk = (K + BK - 1) / BK * BK;
  return gemm<A_K, B_K>(la, lb, ep, M, N, K, 1, chunk, st);
}

}  // namespace
