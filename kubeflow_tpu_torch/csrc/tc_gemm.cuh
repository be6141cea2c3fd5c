// The pipelined bf16 tensor-core product of the fused ResNet bottleneck's
// backward (fused_block_train.cu: K4/K5; the forward and K6 run on
// wgmma_gemm.cuh, which shares this file's loaders, FastDiv and SegSums):
// C[M, N] = sum_k A(m, k) B(k, n), bf16 operands, f32 accumulators, on
// Hopper's `mma.sync.m16n8k16` (the wrapper, `ldmatrix` and `cp.async` are
// in warp_mma.cuh).
//
// - A block of 256 threads (8 warps, 4 along m x 2 along n, a 32 x 32
//   share each) owns a 128 x 64 output tile and walks k in steps of 64.
// - Operand tiles are staged with 16-byte `cp.async` copies into a ring of
//   3 stages in shared memory: the copies of step k + 2 are in flight
//   while step k is in the tensor cores, and one barrier per step orders
//   the ring. Rows are padded by 16 bytes so that `ldmatrix` reads hit
//   distinct banks.
// - Fragments are read with `ldmatrix`: plain for an operand stored with k
//   contiguous, `.trans` for one stored with m (or n) contiguous, the
//   weight-gradient form where the samples are the contraction.
// - Operands reach the copies through loaders: `row(r)` decodes a row (the
//   operand's non-contiguous index) once, and `src(row, c, ok)` gives the
//   address of the 8 bf16 at contiguous index c, or ok = false for a chunk
//   that reads as zeros (an image edge, a tap outside the strip). The rows
//   of an operand walked along k (A's m, B's n) stay with a thread for the
//   whole loop, so they are decoded once per tile; the 32-bit divisions
//   that decode them are multiplications by a magic number (FastDiv), and
//   the inner loop does no 64-bit division.
// - Results leave through an epilogue, 8 columns of a row at a time: the
//   tile goes through shared memory so that a thread takes 8 contiguous
//   columns of 4 rows, `ep.row(m)` decodes each row once, `ep.load(row,
//   col, in)` issues the 16-byte loads of the 8 columns (the four rows'
//   at once, so their latencies overlap), and `ep(split, row, col, v, in,
//   s)` stores. An epilogue with NV > 0 also returns NV values a column in
//   s, summed per (tile, ghost segment): the tile's rows split at
//   multiples of the segment length L (a 128-row tile can straddle
//   segments), the values are summed in row order per segment and column,
//   and the partial of slot j of tile t goes to part[((t * R + j) * NV +
//   v) * N + col]. `ghost_reduce_kernel` (fused_block_train.cu) sums them
//   per ghost in a fixed order, so no float atomics are used and the
//   results do not change from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "warp_mma.cuh"

namespace {

constexpr int TBM = 128, TBN = 64, TBK = 64, TSTAGES = 3;
constexpr int TC_GEMM_THREADS = 256;
constexpr int A_LDK = TBK + 8;  // A stored [m][k]
constexpr int A_LDM = TBM + 8;  // A stored [k][m]
constexpr int B_LDK = TBK + 8;  // B stored [n][k]
constexpr int B_LDN = TBN + 8;  // B stored [k][n]
constexpr int A_STAGE = TBM * A_LDK;  // >= TBK * A_LDM
constexpr int B_STAGE = TBN * B_LDK;  // == TBK * B_LDN
constexpr int CS_LD = TBN + 4;        // a row of the staged result tile
constexpr int RED_LD = TBN + 1;       // a row of the epilogue's sums

// the operand ring, the staged result tile [TBM][CS_LD] f32 and the
// epilogue's sums [NV][TBM][RED_LD] f32 share the block's shared memory
template <int NV>
constexpr size_t tc_smem_bytes() {
  constexpr size_t ring = sizeof(bf16) * TSTAGES * (A_STAGE + B_STAGE);
  constexpr size_t tile = sizeof(float) * TBM * CS_LD;
  constexpr size_t sums = sizeof(float) * NV * TBM * RED_LD;
  return ring > tile ? (ring > sums ? ring : sums)
                     : (tile > sums ? tile : sums);
}

// n / d for 0 <= n < 2^31 by a multiplication (Granlund and Montgomery):
// l = ceil(log2 d), mul = floor(2^32 (2^l - d) / d) + 1
struct FastDiv {
  uint32_t d, mul, shr;
  __device__ __forceinline__ int div(int n) const {
    const uint32_t u = static_cast<uint32_t>(n);
    return static_cast<int>((__umulhi(u, mul) + u) >> shr);
  }
};

inline FastDiv fast_div(int d) {
  uint32_t shr = 0;
  while ((1ull << shr) < static_cast<uint64_t>(d)) ++shr;
  const uint64_t mul =
      ((1ull << 32) * ((1ull << shr) - static_cast<uint64_t>(d))) /
          static_cast<uint64_t>(d) + 1;
  return FastDiv{static_cast<uint32_t>(d), static_cast<uint32_t>(mul), shr};
}

// a warp's 32 x 32 share of the block tile: [m16 tile][n8 tile][C frag]
typedef float TAcc[2][4][4];

__device__ __forceinline__ void tc_zero(TAcc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// plain row-major bf16 [rows, ld] as an operand
struct LdRows {
  const bf16* p;
  int ld;
  typedef const bf16* Row;
  __device__ __forceinline__ const bf16* base() const { return p; }
  __device__ __forceinline__ Row row(int r) const {
    return p + static_cast<int64_t>(r) * ld;
  }
  __device__ __forceinline__ const bf16* src(Row r, int c, bool&) const {
    return r + c;
  }
};

struct NoIn {};  // an epilogue that loads nothing

// Where an epilogue with NV > 0 puts its per-(tile, segment) partials
struct SegSums {
  float* part;
  int L;  // segment length in rows of M
  int R;  // segment slots a tile can touch: 1 + ceil((TBM - 1) / L)
};

inline SegSums seg_sums(float* part, int L) {
  return SegSums{part, L, 1 + (TBM - 1 + L - 1) / L};
}

// the 16-byte copies of k step [k0, k0 + TBK) into one stage
template <bool A_K, bool B_K, class LA, class LB>
__device__ __forceinline__ void tc_issue(const LA& la, const LB& lb,
                                         const typename LA::Row* arow,
                                         const typename LB::Row* brow,
                                         int m0, int n0, int M, int N,
                                         int k0, int kend, bf16* As,
                                         bf16* Bs) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // A: 128 x 64 = 1024 chunks of 8
    bool ok;
    const bf16* p = la.base();
    bf16* dst;
    if (A_K) {
      const int r = tid / 8 + 32 * i, c = k0 + (tid % 8) * 8;
      ok = m0 + r < M && c < kend;
      if (ok) p = la.src(arow[i], c, ok);
      dst = As + r * A_LDK + (tid % 8) * 8;
    } else {
      const int kk = tid / 16 + 16 * i, c = m0 + (tid % 16) * 8;
      ok = k0 + kk < kend && c < M;
      if (ok) p = la.src(la.row(k0 + kk), c, ok);
      dst = As + kk * A_LDM + (tid % 16) * 8;
    }
    cp_async16(dst, ok ? p : la.base(), ok);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // B: 64 x 64 = 512 chunks of 8
    bool ok;
    const bf16* p = lb.base();
    bf16* dst;
    if (B_K) {
      const int r = tid / 8 + 32 * i, c = k0 + (tid % 8) * 8;
      ok = n0 + r < N && c < kend;
      if (ok) p = lb.src(brow[i], c, ok);
      dst = Bs + r * B_LDK + (tid % 8) * 8;
    } else {
      const int kk = tid / 8 + 32 * i, c = n0 + (tid % 8) * 8;
      ok = k0 + kk < kend && c < N;
      if (ok) p = lb.src(lb.row(k0 + kk), c, ok);
      dst = Bs + kk * B_LDN + (tid % 8) * 8;
    }
    cp_async16(dst, ok ? p : lb.base(), ok);
  }
}

// acc += one staged k step
template <bool A_K, bool B_K>
__device__ __forceinline__ void tc_compute(const bf16* As, const bf16* Bs,
                                           TAcc& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int kk = 0; kk < TBK; kk += 16) {
    uint32_t af[2][4], bfr[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m = wm * 32 + mi * 16;
      if (A_K)
        ldmatrix_x4(af[mi], As + (m + (lane & 15)) * A_LDK + kk +
                                (lane >> 4) * 8);
      else
        ldmatrix_x4_trans(af[mi], As + (kk + (lane & 7) + (lane >> 4) * 8) *
                                           A_LDM +
                                      m + ((lane >> 3) & 1) * 8);
    }
#pragma unroll
    for (int nj = 0; nj < 4; nj += 2) {
      const int n = wn * 32 + nj * 8;
      uint32_t t[4];
      if (B_K)
        ldmatrix_x4(t, Bs + (n + (lane & 7) + (lane >> 4) * 8) * B_LDK + kk +
                           ((lane >> 3) & 1) * 8);
      else
        ldmatrix_x4_trans(t, Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      B_LDN +
                                 n + (lane >> 4) * 8);
      bfr[nj][0] = t[0];
      bfr[nj][1] = t[1];
      bfr[nj + 1][0] = t[2];
      bfr[nj + 1][1] = t[3];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
  }
}

// acc += the block tile (m0, n0) of A.B over k in [kbeg, kend). A_K: A's
// loader walks k (src(row(m), k)); otherwise it walks m (src(row(k), m),
// the weight-gradient form). B_K likewise: src(row(n), k) or src(row(k),
// n). Needs M % 8 == 0 when A walks m, N % 8 == 0, K % 8 == 0. Every
// thread of the block must call it; it ends with a barrier, so the caller
// may reuse the shared memory.
template <bool A_K, bool B_K, class LA, class LB>
__device__ __forceinline__ void tc_mainloop(const LA& la, const LB& lb,
                                            int m0, int n0, int M, int N,
                                            int kbeg, int kend, bf16* smem,
                                            TAcc& acc) {
  const int tid = threadIdx.x;
  typename LA::Row arow[A_K ? 4 : 1];
  typename LB::Row brow[B_K ? 2 : 1];
  if (A_K)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + tid / 8 + 32 * i;
      if (m < M) arow[i] = la.row(m);
    }
  if (B_K)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = n0 + tid / 8 + 32 * i;
      if (n < N) brow[i] = lb.row(n);
    }
  const int nk = (kend - kbeg + TBK - 1) / TBK;
#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < nk)
      tc_issue<A_K, B_K>(la, lb, arow, brow, m0, n0, M, N, kbeg + s * TBK,
                         kend, smem + s * (A_STAGE + B_STAGE),
                         smem + s * (A_STAGE + B_STAGE) + A_STAGE);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TSTAGES - 2>();
    __syncthreads();  // step kt has landed; step kt - 1 is computed
    const int nxt = kt + TSTAGES - 1;
    if (nxt < nk) {
      bf16* st = smem + (nxt % TSTAGES) * (A_STAGE + B_STAGE);
      tc_issue<A_K, B_K>(la, lb, arow, brow, m0, n0, M, N,
                         kbeg + nxt * TBK, kend, st, st + A_STAGE);
    }
    cp_async_commit();
    const bf16* st = smem + (kt % TSTAGES) * (A_STAGE + B_STAGE);
    tc_compute<A_K, B_K>(st, st + A_STAGE, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Blocks: (N tiles, M tiles, K splits); split z covers k in [z * kchunk,
// (z + 1) * kchunk), kchunk % TBK == 0.
template <bool A_K, bool B_K, class LA, class LB, class EP>
__global__ void __launch_bounds__(TC_GEMM_THREADS, 2)
tc_gemm_kernel(LA la, LB lb, EP ep, SegSums seg, int M, int N, int K,
               int kchunk) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN, z = blockIdx.z;
  const int kbeg = z * kchunk;
  const int kend = K - kbeg < kchunk ? K : kbeg + kchunk;
  TAcc acc;
  tc_zero(acc);
  tc_mainloop<A_K, B_K>(la, lb, m0, n0, M, N, kbeg, kend,
                        reinterpret_cast<bf16*>(tc_smem), acc);

  // the tile through shared memory: a thread takes 8 columns of 4 rows
  // (rows t / 8 + 32 i, columns (t % 8) * 8), so every load and store of
  // the epilogue is 16 bytes wide and 8 threads cover a row's 64 columns
  constexpr int NV = EP::NV;
  float* cs = reinterpret_cast<float*>(tc_smem);   // [TBM][CS_LD]
  float* red = reinterpret_cast<float*>(tc_smem);  // [NV][TBM][RED_LD]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mi * 16 + h * 8 + (lane >> 2);
        const int c = wn * 32 + ni * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(cs + r * CS_LD + c) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
  __syncthreads();
  const int cg = (threadIdx.x % 8) * 8, col = n0 + cg;
  float v[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* src = cs + (threadIdx.x / 8 + 32 * i) * CS_LD + cg;
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    v[i][0] = a.x; v[i][1] = a.y; v[i][2] = a.z; v[i][3] = a.w;
    v[i][4] = b.x; v[i][5] = b.y; v[i][6] = b.z; v[i][7] = b.w;
  }
  if (NV > 0) __syncthreads();  // red reuses cs
  // the rows decoded and their loads issued together, then the values
  typename EP::Row rows[4];
  typename EP::In in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + threadIdx.x / 8 + 32 * i;
    if (m < M && col < N) {
      rows[i] = ep.row(m);
      ep.load(rows[i], col, in[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = threadIdx.x / 8 + 32 * i;
    if (m0 + r >= M || col >= N) continue;
    float s[NV > 0 ? 8 * NV : 1];
    ep(z, rows[i], col, v[i], in[i], s);
#pragma unroll
    for (int u = 0; u < NV; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        red[(u * TBM + r) * RED_LD + cg + e] = s[8 * u + e];
  }
  if (NV == 0) return;
  __syncthreads();
  // per (value, column): the tile's rows cut at segment ends, each piece
  // summed in a fixed order (four interleaved partial sums, then their
  // pairwise sum)
  const int nrows = M - m0 < TBM ? M - m0 : TBM;
  const int mt = blockIdx.y;
  for (int u = threadIdx.x; u < NV * TBN; u += TC_GEMM_THREADS) {
    const int vi = u / TBN, c = u % TBN;
    if (n0 + c >= N) continue;
    const float* colv = red + vi * TBM * RED_LD + c;
    int slot = 0, next = (m0 / seg.L + 1) * seg.L - m0;
    for (int lo = 0; lo < nrows; lo = next, next += seg.L, ++slot) {
      const int hi = next < nrows ? next : nrows;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int r = lo;
      for (; r + 4 <= hi; r += 4) {
        a0 += colv[r * RED_LD];
        a1 += colv[(r + 1) * RED_LD];
        a2 += colv[(r + 2) * RED_LD];
        a3 += colv[(r + 3) * RED_LD];
      }
      for (; r < hi; ++r) a0 += colv[r * RED_LD];
      seg.part[((mt * seg.R + slot) * NV + vi) * N + n0 + c] =
          (a0 + a1) + (a2 + a3);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device, once per kernel and device: `done` is the caller's
// function-local static, one bit a device, so a launch does not pay a
// driver call.
template <class K>
cudaError_t allow_smem(std::atomic<uint64_t>& done, K kernel, size_t bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

// the product over k in `splits` chunks of `kchunk` (a multiple of TBK)
template <bool A_K, bool B_K, class LA, class LB, class EP>
cudaError_t tc_gemm(LA la, LB lb, EP ep, SegSums seg, int M, int N, int K,
                    int splits, int kchunk, cudaStream_t st) {
  constexpr size_t smem = tc_smem_bytes<EP::NV>();
  static std::atomic<uint64_t> done{0};
  const cudaError_t e =
      allow_smem(done, tc_gemm_kernel<A_K, B_K, LA, LB, EP>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM, splits);
  tc_gemm_kernel<A_K, B_K><<<grid, TC_GEMM_THREADS, smem, st>>>(
      la, lb, ep, seg, M, N, K, kchunk);
  return cudaGetLastError();
}

template <bool A_K, bool B_K, class LA, class LB, class EP>
cudaError_t tc_gemm_full(LA la, LB lb, EP ep, int M, int N, int K,
                         cudaStream_t st, SegSums seg = SegSums{nullptr, 1, 1}) {
  const int chunk = (K + TBK - 1) / TBK * TBK;
  return tc_gemm<A_K, B_K>(la, lb, ep, seg, M, N, K, 1, chunk, st);
}

}  // namespace
