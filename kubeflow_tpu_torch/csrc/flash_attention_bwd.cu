// Flash-attention backward for Hopper (sm_90a), behind a plain C interface
// that kubeflow_tpu_torch/ops/flash_attention.py binds with ctypes.
//
// Replaces: kubeflow_tpu/ops/flash_attention.py `_bwd_dq_kernel` (K2a) and
// `_bwd_dkv_kernel` (K2b), launched by `_flash_bwd` through two
// `pl.pallas_call`s. Same function: the scores are recomputed from the
// saved log-sum-exp, s = (q.k^T) * scale in f32, p = exp(s - lse), the
// causal mask top-left aligned (cols <= rows kept, masked p = 0),
// ds = p * (dp - delta) with dp = do.v^T and delta = rowsum(do * o)
// (computed outside the kernels, as the TPU code does),
// dq = scale * sum_k ds.k, dk = scale * sum_q ds^T.q, dv = sum_q p^T.do,
// accumulated in f32 and written in the input dtype.
//
// What bounds it on the H100: at the LM's training shape (S 2048, D 64,
// causal) the backward needs five S x S x D products over the unmasked
// (row, col) pairs against a few bytes per (row, head-dim) element, so
// the card's arithmetic rate bounds it, not its memory. The TPU code's
// split into two kernels stays (they recompute s and dp in both):
//
// K2b in bf16: `flash_bwd_dkv_bf16_kernel`, its four products on the
// tensor cores (`mma.sync.m16n8k16`, bf16 operands, f32 accumulators):
// - One block of 8 warps owns one 128-row k tile of one (b, h); each warp
//   owns 16 key rows, and dK and dV accumulate in its registers over the
//   q tiles (64 rows; 32 at D 128, for registers), from the diagonal
//   down. Each output element has one owner: no atomics, and the backward
//   stays deterministic. The flat grid starts the k tiles with the most q
//   tiles first and takes any B*H.
// - The scores come out transposed: S^T = K.Q^T and dP^T = V.dO^T, with
//   key rows as M. P^T and dS^T then sit in the C-fragment layout that,
//   packed to bf16, is the A operand of dV += P^T.dO and dK += dS^T.Q
//   (dO and Q read with `ldmatrix.trans`), straight from registers: no
//   shared-memory transpose. lse and delta belong to q rows, the columns
//   of S^T, so they are staged per q tile in shared memory and read per
//   column.
// - K and V are copied in once; Q, dO, lse and delta of q tile i + 1 are
//   in flight (a 2-stage ring of `cp.async` copies, zero-filled past Sq
//   and D) while tile i is computed.
// - Causal: the loop starts at the diagonal tile; a warp whose keys all
//   lie past a tile's rows skips it; only tiles on the diagonal or the
//   ragged edge apply the mask.
// - P and dS are rounded to bf16 before their products, a rounding point
//   the JAX kernel does not have (it keeps them in f32); over S 2048 the
//   gradients stay within 0.6 of the bar that holds them.
//
// K2a (both dtypes) and K2b in f32: the first port's FMA kernels on the
// CUDA cores (peak 67 TFLOP/s; tensor cores would mean TF32 for f32,
// which breaks the f32 bars):
// - The TPU kernels carry their accumulators in VMEM across a sequential
//   grid axis. Here one block owns one 64-row q tile (K2a) or one 64-row
//   k tile (K2b) of one (batch, head) and loops over the other axis
//   itself, so the dq (K2a) or dk/dv (K2b) accumulators stay in registers
//   for the whole loop.
// - Causal: K2a visits k tiles up to the diagonal; K2b visits q tiles
//   from the diagonal down. Tiles wholly above the diagonal are never
//   loaded (the TPU's `_when_relevant`).
// - 256 threads: thread (ty, tx) owns tile rows 4*ty..4*ty+3 and score
//   columns tx + 16*j, as in the forward kernel. Scores and dp are
//   computed in registers; p and ds go through shared memory to the
//   products that contract over the score columns.
//
// All of them take every sequence length: the ragged edge is masked (rows
// >= Sq and columns >= Sk give p = 0 and are not written). q, k, v and do
// are read through (batch, seq, head) strides with a unit stride on the
// head dim, so the model's fused-qkv slices need no copy (the bf16 K2b
// needs 16-byte aligned pointers and strides that are multiples of 8
// elements). lse and delta are contiguous [B, H, Sq] f32; dq, dk and dv
// are written contiguous [B, S, H, D].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int BLOCK_M = 64;  // q rows per tile
constexpr int BLOCK_N = 64;  // k rows per tile
constexpr int THREADS = 256;
constexpr int P_LD = BLOCK_N + 1;  // padded row of a 64-wide score tile

struct Strides {  // in elements; the head dim is unit stride
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [row0, row0 + 64) of a [.., S, .., D] input into a padded f32 tile
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int rows, int D) {
  for (int idx = threadIdx.x; idx < 64 * DMAX; idx += THREADS) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    const int row = row0 + r;
    float x = 0.f;
    if (row < rows && c < D) x = to_f32(src[row * row_stride + c]);
    dst[r * (DMAX + 1) + c] = x;
  }
}

template <int DMAX>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * 64 * (DMAX + 1) + BLOCK_M * P_LD);
}

template <int DMAX>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (4 * 64 * (DMAX + 1) + 2 * BLOCK_N * P_LD + 2 * BLOCK_M);
}

// K2a: one block per (b*h, 64-row q tile); loops over k tiles.
template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Sq, int Sk, int D, Strides st, float scale,
                    int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int COLS = DMAX / 16;  // head-dim columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                 // [BLOCK_M][LD]
  float* do_s = q_s + BLOCK_M * LD;  // [BLOCK_M][LD]
  float* k_s = do_s + BLOCK_M * LD;  // [BLOCK_N][LD]
  float* v_s = k_s + BLOCK_N * LD;   // [BLOCK_N][LD]
  float* ds_s = v_s + BLOCK_N * LD;  // [BLOCK_M][P_LD]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = blockIdx.x * BLOCK_M;

  load_tile<T, DMAX>(q_s, q + b * st.qb + h * st.qh, st.qs, row0, Sq, D);
  load_tile<T, DMAX>(do_s, dout + b * st.ob + h * st.oh, st.os, row0, Sq,
                     D);
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;

  float lse_r[4], delta_r[4], acc[4][COLS];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    const int64_t at = static_cast<int64_t>(bh) * Sq + row;
    lse_r[i] = row < Sq ? lse[at] : 0.f;
    delta_r[i] = row < Sq ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Sk + BLOCK_N - 1) / BLOCK_N;
  if (causal) {
    const int last_row = min(row0 + BLOCK_M, Sq) - 1;
    n_tiles = min(n_tiles, last_row / BLOCK_N + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int col0 = j * BLOCK_N;
    __syncthreads();  // the previous tile's ds.k is done with k_s/ds_s
    load_tile<T, DMAX>(k_s, kb, st.ks, col0, Sk, D);
    load_tile<T, DMAX>(v_s, vb, st.vs, col0, Sk, D);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DMAX; ++c) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(ty * 4 + i) * LD + c];
        dov[i] = do_s[(ty * 4 + i) * LD + c];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        kv[jj] = k_s[(tx + 16 * jj) * LD + c];
        vv[jj] = v_s[(tx + 16 * jj) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
          dp[i][jj] = fmaf(dov[i], vv[jj], dp[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = col0 + tx + 16 * jj;
        float p = 0.f;
        if (row < Sq && col < Sk && !(causal && col > row))
          p = expf(s[i][jj] * scale - lse_r[i]);
        ds_s[(ty * 4 + i) * P_LD + tx + 16 * jj] = p * (dp[i][jj] - delta_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BLOCK_N; ++kk) {
      float dsv[4], kv[COLS];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(ty * 4 + i) * P_LD + kk];
#pragma unroll
      for (int c = 0; c < COLS; ++c) kv[c] = k_s[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= Sq) continue;
    T* out = dq + ((static_cast<int64_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = tx + 16 * c;
      if (col < D) out[col] = from_f32<T>(acc[i][c] * scale);
    }
  }
}

// K2b: one block per (b*h, 64-row k tile); loops over q tiles.
template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, int D,
                     Strides st, float scale, int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int COLS = DMAX / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                    // [BLOCK_N][LD]
  float* v_s = k_s + BLOCK_N * LD;      // [BLOCK_N][LD]
  float* q_s = v_s + BLOCK_N * LD;      // [BLOCK_M][LD]
  float* do_s = q_s + BLOCK_M * LD;     // [BLOCK_M][LD]
  float* p_s = do_s + BLOCK_M * LD;     // [BLOCK_N][P_LD], p transposed
  float* ds_s = p_s + BLOCK_N * P_LD;   // [BLOCK_N][P_LD], ds transposed
  float* lse_s = ds_s + BLOCK_N * P_LD; // [BLOCK_M]
  float* delta_s = lse_s + BLOCK_M;     // [BLOCK_M]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int col0 = blockIdx.x * BLOCK_N;  // this block's k rows

  load_tile<T, DMAX>(k_s, k + b * st.kb + h * st.kh, st.ks, col0, Sk, D);
  load_tile<T, DMAX>(v_s, v + b * st.vb + h * st.vh, st.vs, col0, Sk, D);
  const T* qb = q + b * st.qb + h * st.qh;
  const T* ob = dout + b * st.ob + h * st.oh;

  float dk_acc[4][COLS], dv_acc[4][COLS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_q = (Sq + BLOCK_M - 1) / BLOCK_M;
  const int first = causal ? col0 / BLOCK_M : 0;  // the diagonal tile
  for (int it = first; it < n_q; ++it) {
    const int row0 = it * BLOCK_M;
    __syncthreads();  // the previous tile's products are done with smem
    load_tile<T, DMAX>(q_s, qb, st.qs, row0, Sq, D);
    load_tile<T, DMAX>(do_s, ob, st.os, row0, Sq, D);
    if (threadIdx.x < BLOCK_M) {
      const int row = row0 + threadIdx.x;
      const int64_t at = static_cast<int64_t>(bh) * Sq + row;
      lse_s[threadIdx.x] = row < Sq ? lse[at] : 0.f;
      delta_s[threadIdx.x] = row < Sq ? delta[at] : 0.f;
    }
    __syncthreads();

    // transposed tiles: sT[kr][qc] = k[kr].q[qc], dpT[kr][qc] = v[kr].do[qc]
    float sT[4][4], dpT[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sT[i][jj] = dpT[i][jj] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DMAX; ++c) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = k_s[(ty * 4 + i) * LD + c];
        vv[i] = v_s[(ty * 4 + i) * LD + c];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        qv[jj] = q_s[(tx + 16 * jj) * LD + c];
        dov[jj] = do_s[(tx + 16 * jj) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          sT[i][jj] = fmaf(kv[i], qv[jj], sT[i][jj]);
          dpT[i][jj] = fmaf(vv[i], dov[jj], dpT[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int krow = col0 + ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qc = tx + 16 * jj;
        const int qrow = row0 + qc;
        float p = 0.f;
        if (qrow < Sq && krow < Sk && !(causal && krow > qrow))
          p = expf(sT[i][jj] * scale - lse_s[qc]);
        p_s[(ty * 4 + i) * P_LD + qc] = p;
        ds_s[(ty * 4 + i) * P_LD + qc] = p * (dpT[i][jj] - delta_s[qc]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BLOCK_M; ++qq) {
      float pv[4], dsv[4], qv[COLS], dov[COLS];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = p_s[(ty * 4 + i) * P_LD + qq];
        dsv[i] = ds_s[(ty * 4 + i) * P_LD + qq];
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        qv[c] = q_s[qq * LD + tx + 16 * c];
        dov[c] = do_s[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          dv_acc[i][c] = fmaf(pv[i], dov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qv[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int krow = col0 + ty * 4 + i;
    if (krow >= Sk) continue;
    const int64_t at = ((static_cast<int64_t>(b) * Sk + krow) * H + h) * D;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        dk[at + col] = from_f32<T>(dk_acc[i][c] * scale);
        dv[at + col] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int H, int Sq, int Sk, int D,
                      const Strides& st, float scale, int causal,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_bwd_dq_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, Sq, Sk, D, st, scale, causal);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int H,
                       int Sq, int Sk, int D, const Strides& st, float scale,
                       int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + BLOCK_N - 1) / BLOCK_N, B * H);
  flash_bwd_dkv_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, D, st, scale,
      causal);
  return cudaGetLastError();
}

// -- K2b, bf16: the tensor-core kernel ----------------------------------------

constexpr int TC_KB = 16 * TC_WARPS;  // key rows per block, 16 per warp

template <int DMAX>
__host__ __device__ constexpr int tc_qb() {  // q rows per tile: fewer at D 128
  return DMAX <= 64 ? 64 : 32;
}

template <int DMAX>
constexpr size_t dkv_bf16_smem_bytes() {
  // K and V; 2 stages of Q, dO (bf16) and lse, delta (f32)
  return sizeof(bf16) * (2 * TC_KB + 4 * tc_qb<DMAX>()) * (DMAX + 8) +
         sizeof(float) * 4 * tc_qb<DMAX>();
}

template <int DMAX>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int BH, int H, int Sq, int Sk, int D, Strides st,
                          float scale, int causal) {
  constexpr int LD = DMAX + 8;  // padded row: ldmatrix rows hit 8 banks
  constexpr int QB = tc_qb<DMAX>();
  constexpr int KD = DMAX / 16;  // k16 steps over the head dim
  constexpr int NQ = QB / 8;     // n8 tiles of a warp's S^T rows
  constexpr int NO = DMAX / 8;   // n8 tiles of a warp's dK, dV rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16(*k_s)[LD] = reinterpret_cast<bf16(*)[LD]>(smem_raw);
  bf16(*v_s)[LD] = k_s + TC_KB;
  bf16(*q_s)[QB][LD] = reinterpret_cast<bf16(*)[QB][LD]>(v_s + TC_KB);
  bf16(*do_s)[QB][LD] = q_s + 2;
  float(*lse_s)[QB] = reinterpret_cast<float(*)[QB]>(do_s + 2);
  float(*delta_s)[QB] = lse_s + 2;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix row addresses
  const int bh = blockIdx.x % BH;
  // the k tiles with the most q tiles (the first ones) start first
  const int col0 = static_cast<int>(blockIdx.x / BH) * TC_KB;
  const int b = bh / H, h = bh % H;
  const int wk = col0 + warp * 16;  // this warp's first key row
  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* ob = dout + b * st.ob + h * st.oh;
  const int64_t row_at = static_cast<int64_t>(bh) * Sq;

  auto stage_q = [&](int it, int sx) {  // q tile it into stage sx
    const int r0 = it * QB;
    stage_rows<QB, DMAX>(q_s[sx], qb, st.qs, r0, Sq, D);
    stage_rows<QB, DMAX>(do_s[sx], ob, st.os, r0, Sq, D);
    for (int u = threadIdx.x; u < 2 * QB; u += TC_THREADS) {
      const int r = u % QB, row = r0 + r;
      const bool ok = row < Sq;
      const float* src = (u < QB ? lse : delta) + (ok ? row_at + row : 0);
      cp_async4(u < QB ? &lse_s[sx][r] : &delta_s[sx][r], src, ok);
    }
  };

  const int n_q = (Sq + QB - 1) / QB;
  const int first = causal ? col0 / QB : 0;  // the diagonal tile
  stage_rows<TC_KB, DMAX>(k_s, k + b * st.kb + h * st.kh, st.ks, col0, Sk,
                          D);
  stage_rows<TC_KB, DMAX>(v_s, v + b * st.vb + h * st.vh, st.vs, col0, Sk,
                          D);
  if (first < n_q) stage_q(first, 0);
  cp_async_commit();

  const float sl2 = scale * LOG2E;
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = first; it < n_q; ++it) {
    const int sx = (it - first) & 1;
    if (it + 1 < n_q) {  // q tile it + 1 flies while tile it is computed
      stage_q(it + 1, sx ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = it * QB;
    if (!causal || r0 + QB - 1 >= wk) {  // else every p of the warp is 0
      // S^T = K.Q^T and dP^T = V.dO^T: 16 key rows by QB q columns
      float sT[NQ][4], dpT[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, &k_s[warp * 16 + lr + (lm & 1) * 8]
                            [kd * 16 + (lm >> 1) * 8]);
        ldmatrix_x4(vf, &v_s[warp * 16 + lr + (lm & 1) * 8]
                            [kd * 16 + (lm >> 1) * 8]);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t qf[4], of[4];  // B fragments of q tiles 2np, 2np + 1
          ldmatrix_x4(qf, &q_s[sx][np * 16 + lr + (lm >> 1) * 8]
                              [kd * 16 + (lm & 1) * 8]);
          ldmatrix_x4(of, &do_s[sx][np * 16 + lr + (lm >> 1) * 8]
                               [kd * 16 + (lm & 1) * 8]);
          mma_bf16(sT[2 * np], kf, qf);
          mma_bf16(sT[2 * np + 1], kf, qf + 2);
          mma_bf16(dpT[2 * np], vf, of);
          mma_bf16(dpT[2 * np + 1], vf, of + 2);
        }
      }
      // P^T and dS^T, packed to bf16 as the A fragments of the products
      // over q; lse and delta belong to q rows, the columns of S^T
      const bool edge = r0 + QB > Sq || wk + 16 > Sk ||
                        (causal && wk + 15 > r0);
      uint32_t pf[NQ / 2][4], dsf[NQ / 2][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t + (e & 1);
          p[e] = exp2f(sT[n][e] * sl2 - lse_s[sx][qc] * LOG2E);
          if (edge) {
            const int qrow = r0 + qc, krow = wk + g + (e >> 1) * 8;
            if (qrow >= Sq || krow >= Sk || (causal && krow > qrow))
              p[e] = 0.f;
          }
          ds[e] = p[e] * (dpT[n][e] - delta_s[sx][qc]);
        }
        pf[n / 2][(n & 1) * 2] = pack2(p[0], p[1]);
        pf[n / 2][(n & 1) * 2 + 1] = pack2(p[2], p[3]);
        dsf[n / 2][(n & 1) * 2] = pack2(ds[0], ds[1]);
        dsf[n / 2][(n & 1) * 2 + 1] = pack2(ds[2], ds[3]);
      }
      // dV += P^T.dO and dK += dS^T.Q, contracting over the tile's q rows
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t of[4], qf[4];  // B fragments of head-dim tiles 2np..
          ldmatrix_x4_trans(of, &do_s[sx][kk * 16 + lr + (lm & 1) * 8]
                                     [np * 16 + (lm >> 1) * 8]);
          ldmatrix_x4_trans(qf, &q_s[sx][kk * 16 + lr + (lm & 1) * 8]
                                    [np * 16 + (lm >> 1) * 8]);
          mma_bf16(dv_acc[2 * np], pf[kk], of);
          mma_bf16(dv_acc[2 * np + 1], pf[kk], of + 2);
          mma_bf16(dk_acc[2 * np], dsf[kk], qf);
          mma_bf16(dk_acc[2 * np + 1], dsf[kk], qf + 2);
        }
      }
    }
    __syncthreads();  // every warp is done with stage sx
  }
  cp_async_wait<0>();  // no q tile at all: K and V may still be landing
  __syncthreads();

  // dK (scaled) and dV through this warp's own rows of k_s and v_s
  const int64_t at = (static_cast<int64_t>(b) * Sk * H + h) * D;
  const int64_t row_stride = static_cast<int64_t>(H) * D;
  store_rows_16B<DMAX>(dk + at, row_stride, wk, Sk, D, k_s + warp * 16,
                       dk_acc, scale, scale);
  store_rows_16B<DMAX>(dv + at, row_stride, wk, Sk, D, v_s + warp * 16,
                       dv_acc, 1.f, 1.f);
}

template <int DMAX>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv, int B,
                            int H, int Sq, int Sk, int D, const Strides& st,
                            float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_bf16_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16_kernel<DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks =
      static_cast<int64_t>((Sk + TC_KB - 1) / TC_KB) * B * H;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_bwd_dkv_bf16_kernel<DMAX>
      <<<static_cast<unsigned>(blocks), TC_THREADS, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
          delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), B * H, H,
          Sq, Sk, D, st, scale, causal);
  return cudaGetLastError();
}

Strides strides_from(const int64_t* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4],  s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11]};
}

bool bad_args(int D, int dtype) {
  return D <= 0 || D > 128 || D % 8 != 0 || dtype < 0 || dtype > 1;
}

bool past_grid_y(int B, int H) {  // the FMA kernels put b*h on gridDim.y
  return static_cast<int64_t>(B) * H > 65535;
}

}  // namespace

// q, k, v, dout: [B, S, H, D] read through strides (in elements)
// `strides` = {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s,
// do_h}; the head dim is unit stride. lse, delta: contiguous [B, H, Sq]
// f32. dq: contiguous [B, Sq, H, D] in the input dtype. dtype: 0 =
// float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int kftpu_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int B, int H, int Sq,
    int Sk, int D, const int64_t* strides, float scale, int causal,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return cudaSuccess;
  if (bad_args(D, dtype) || past_grid_y(B, H)) return cudaErrorInvalidValue;
  const Strides st = strides_from(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D <= 32)
      return launch_dq<float, 32>(q, k, v, dout, lse, delta, dq, B, H, Sq,
                                  Sk, D, st, scale, causal, s);
    if (D <= 64)
      return launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, B, H, Sq,
                                  Sk, D, st, scale, causal, s);
    return launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, B, H, Sq,
                                 Sk, D, st, scale, causal, s);
  }
  if (D <= 32)
    return launch_dq<__nv_bfloat16, 32>(q, k, v, dout, lse, delta, dq, B, H,
                                        Sq, Sk, D, st, scale, causal, s);
  if (D <= 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, B, H,
                                        Sq, Sk, D, st, scale, causal, s);
  return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, B, H,
                                       Sq, Sk, D, st, scale, causal, s);
}

// Same inputs; dk, dv: contiguous [B, Sk, H, D] in the input dtype.
// float32 runs the FMA kernel (B*H <= 65535); bfloat16 the tensor-core
// kernel, which needs 16-byte aligned pointers and strides that are
// multiples of 8 elements.
extern "C" int kftpu_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int D, const int64_t* strides, float scale, int causal,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return cudaSuccess;
  if (bad_args(D, dtype)) return cudaErrorInvalidValue;
  const Strides st = strides_from(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (past_grid_y(B, H)) return cudaErrorInvalidValue;
    if (D <= 32)
      return launch_dkv<float, 32>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                   Sq, Sk, D, st, scale, causal, s);
    if (D <= 64)
      return launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                   Sq, Sk, D, st, scale, causal, s);
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                  Sq, Sk, D, st, scale, causal, s);
  }
  if (!async_ready(q, strides, B, Sq, H) ||
      !async_ready(k, strides + 3, B, Sk, H) ||
      !async_ready(v, strides + 6, B, Sk, H) ||
      !async_ready(dout, strides + 9, B, Sq, H) ||
      reinterpret_cast<uintptr_t>(dk) % 16 ||
      reinterpret_cast<uintptr_t>(dv) % 16)
    return cudaErrorMisalignedAddress;
  if (D <= 32)
    return launch_dkv_bf16<32>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                               Sk, D, st, scale, causal, s);
  if (D <= 64)
    return launch_dkv_bf16<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                               Sk, D, st, scale, causal, s);
  return launch_dkv_bf16<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                              Sk, D, st, scale, causal, s);
}

extern "C" const char* kftpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
