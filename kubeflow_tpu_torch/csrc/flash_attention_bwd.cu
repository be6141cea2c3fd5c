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
// the card's arithmetic rate bounds it, not its memory. This version does
// the arithmetic with f32 FMAs on the CUDA cores (peak 67 TFLOP/s), not
// on the tensor cores (989 TFLOP/s bf16), and keeps the TPU code's split
// into two kernels, which recompute s and dp in both (seven products):
// it is the simple, correct first version; `mma.sync`/`wgmma` with
// TMA-staged tiles are the later step.
//
// Design for the card, not a block-by-block copy of the TPU grid:
// - The TPU kernels carry their accumulators in VMEM across a sequential
//   grid axis. Here one block owns one 64-row q tile (K2a) or one 64-row
//   k tile (K2b) of one (batch, head) and loops over the other axis
//   itself, so the dq (K2a) or dk/dv (K2b) accumulators stay in registers
//   for the whole loop. Each output element has one owner: no atomics,
//   and the backward is deterministic.
// - Causal: K2a visits k tiles up to the diagonal; K2b visits q tiles
//   from the diagonal down. Tiles wholly above the diagonal are never
//   loaded (the TPU's `_when_relevant`).
// - 256 threads: thread (ty, tx) owns tile rows 4*ty..4*ty+3 and score
//   columns tx + 16*j, as in the forward kernel. Scores and dp are
//   computed in registers; p and ds go through shared memory to the
//   products that contract over the score columns.
// - The ragged edge is masked (rows >= Sq and columns >= Sk give p = 0
//   and are not written), so every sequence length runs the kernel.
// - q, k, v and do are read through (batch, seq, head) strides with a
//   unit stride on the head dim, so the model's fused-qkv slices need no
//   copy. lse and delta are contiguous [B, H, Sq] f32; dq, dk and dv are
//   written contiguous [B, S, H, D].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

Strides strides_from(const int64_t* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4],  s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11]};
}

bool bad_args(int B, int H, int D, int dtype) {
  return D <= 0 || D > 128 || D % 8 != 0 || B * H > 65535 || dtype < 0 ||
         dtype > 1;
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
  if (bad_args(B, H, D, dtype)) return cudaErrorInvalidValue;
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
extern "C" int kftpu_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int D, const int64_t* strides, float scale, int causal,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return cudaSuccess;
  if (bad_args(B, H, D, dtype)) return cudaErrorInvalidValue;
  const Strides st = strides_from(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D <= 32)
      return launch_dkv<float, 32>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                   Sq, Sk, D, st, scale, causal, s);
    if (D <= 64)
      return launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                   Sq, Sk, D, st, scale, causal, s);
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                  Sq, Sk, D, st, scale, causal, s);
  }
  if (D <= 32)
    return launch_dkv<__nv_bfloat16, 32>(q, k, v, dout, lse, delta, dk, dv,
                                         B, H, Sq, Sk, D, st, scale, causal,
                                         s);
  if (D <= 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv,
                                         B, H, Sq, Sk, D, st, scale, causal,
                                         s);
  return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, B,
                                        H, Sq, Sk, D, st, scale, causal, s);
}

extern "C" const char* kftpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
