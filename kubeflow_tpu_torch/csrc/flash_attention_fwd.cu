// Flash-attention forward for Hopper (sm_90a), behind a plain C interface
// that kubeflow_tpu_torch/ops/flash_attention.py binds with ctypes.
//
// Replaces: kubeflow_tpu/ops/flash_attention.py `_fwd_kernel`, launched by
// `_flash_fwd` through `pl.pallas_call`. Same function: online-softmax
// attention over a q tile with f32 running max, sum and accumulator, q
// scaled in f32 inside the kernel, causal mask top-left aligned
// (cols <= rows, masked scores = -1e30), l clamped at 1e-30,
// lse = m + log l, o written in the input dtype and lse in f32.
//
// What bounds it on the H100: at the LM's serving shape (S 2048, D 64,
// causal) the work is 4*S*S*D/2 FLOPs per (batch, head) against
// 4*S*D*2 bytes, about 500 FLOPs per byte, so the card's arithmetic
// rate bounds it, not its memory (3.35 TB/s). This kernel does that
// arithmetic with f32 FMAs on the CUDA cores (peak 67 TFLOP/s), not on
// the tensor cores (989 TFLOP/s bf16): it is the simple, correct first
// version, and `wgmma` + TMA are the later step.
//
// Design for the card, not a block-by-block copy of the TPU grid:
// - One thread block per (b*h, 64-row q tile). The TPU's sequential third
//   grid axis over k blocks becomes a loop inside the block, so the
//   running (m, l, acc) state lives in registers for the whole row tile.
// - Each 64-row K/V tile is staged once in shared memory (f32, rows
//   padded by one word so the 16 threads of a row group hit 16 banks)
//   and reused by all 64 q rows of the block.
// - 256 threads: thread (ty, tx) owns q rows 4*ty..4*ty+3 and score
//   columns tx + 16*j. The row max and row sum are reduced across the 16
//   lanes of a half warp with shuffles; the probabilities go through
//   shared memory to the P·V product, where the same thread owns the same
//   rows, so m and l never leave registers.
// - Causal k tiles above the diagonal are never loaded.
// - The ragged edge is masked (rows >= Sq are not written, columns >= Sk
//   score -inf), so every sequence length is taken; the TPU's 8-aligned
//   block rule and its fallback have no counterpart here.
// - Inputs are read through (batch, seq, head) strides with a unit stride
//   on the head dim, so the model's fused-qkv slices need no copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;
constexpr int BLOCK_N = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;  // big-but-finite, as the TPU kernel

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

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((BLOCK_M + BLOCK_N) * (DMAX + 1) +
                          BLOCK_N * DMAX + BLOCK_M * (BLOCK_N + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk, int D,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                 int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                 int64_t v_sh, float scale, int causal) {
  constexpr int QK_STRIDE = DMAX + 1;
  constexpr int P_STRIDE = BLOCK_N + 1;
  constexpr int COLS = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                       // [BLOCK_M][QK_STRIDE], scaled
  float* k_s = q_s + BLOCK_M * QK_STRIDE;  // [BLOCK_N][QK_STRIDE]
  float* v_s = k_s + BLOCK_N * QK_STRIDE;  // [BLOCK_N][DMAX]
  float* p_s = v_s + BLOCK_N * DMAX;       // [BLOCK_M][P_STRIDE]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = blockIdx.x * BLOCK_M;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int idx = tid; idx < BLOCK_M * DMAX; idx += THREADS) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    const int row = row0 + r;
    float x = 0.f;
    if (row < Sq && c < D) x = to_f32(qb[row * q_ss + c]) * scale;
    q_s[r * QK_STRIDE + c] = x;
  }

  float m[4], l[4], acc[4][COLS];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
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
    __syncthreads();  // the previous tile's P·V is done with k_s/v_s/p_s
    for (int idx = tid; idx < BLOCK_N * DMAX; idx += THREADS) {
      const int r = idx / DMAX;
      const int c = idx % DMAX;
      const int col = col0 + r;
      float kx = 0.f, vx = 0.f;
      if (col < Sk && c < D) {
        kx = to_f32(kb[col * k_ss + c]);
        vx = to_f32(vb[col * v_ss + c]);
      }
      k_s[r * QK_STRIDE + c] = kx;
      v_s[r * DMAX + c] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DMAX; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * QK_STRIDE + c];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        kv[jj] = k_s[(tx + 16 * jj) * QK_STRIDE + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = col0 + tx + 16 * jj;
        if (col >= Sk) {
          s[i][jj] = -INFINITY;
        } else if (causal && col > row) {
          s[i][jj] = NEG_INF;
        }
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        rs += p;
        p_s[(ty * 4 + i) * P_STRIDE + tx + 16 * jj] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BLOCK_N; ++kk) {
      float pv[4], vv[COLS];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * P_STRIDE + kk];
#pragma unroll
      for (int c = 0; c < COLS; ++c) vv[c] = v_s[kk * DMAX + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);  // fully-masked rows
    T* orow = o + ((static_cast<int64_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = tx + 16 * c;
      if (col < D) orow[col] = from_f32<T>(acc[i][c] / li);
    }
    if (tx == 0) lse[static_cast<int64_t>(bh) * Sq + row] = m[i] + logf(li);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Sq, int Sk, int D,
                   const int64_t* st, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Sq, Sk, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int H, int Sq, int Sk,
                         int D, const int64_t* st, float scale, int causal,
                         cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, lse, B, H, Sq, Sk, D, st, scale, causal,
                         stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Sk, D, st, scale, causal,
                         stream);
  return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Sk, D, st, scale, causal,
                        stream);
}

}  // namespace

// q, k, v: [B, S, H, D] read through strides (in elements) `strides` =
// {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h}; the head dim is unit
// stride. o: contiguous [B, Sq, H, D] in the input dtype. lse: contiguous
// [B, H, Sq] f32. dtype: 0 = float32, 1 = bfloat16. Returns the launch's
// cudaError_t; the caller checks it.
extern "C" int kftpu_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int H, int Sq, int Sk, int D, const int64_t* strides, float scale,
    int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return cudaSuccess;
  if (D <= 0 || D > 128 || D % 8 != 0 || B * H > 65535 || dtype < 0 ||
      dtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(q, k, v, o, lse, B, H, Sq, Sk, D, strides,
                               scale, causal, s);
  return dispatch_dim<__nv_bfloat16>(q, k, v, o, lse, B, H, Sq, Sk, D,
                                     strides, scale, causal, s);
}

extern "C" const char* kftpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
