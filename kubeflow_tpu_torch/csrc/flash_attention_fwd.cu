// Flash-attention forward for Hopper (sm_90a), behind a plain C interface
// that kubeflow_tpu_torch/ops/flash_attention.py binds with ctypes.
//
// Replaces: kubeflow_tpu/ops/flash_attention.py `_fwd_kernel`, launched by
// `_flash_fwd` through `pl.pallas_call`. Same function: online-softmax
// attention over a q tile with f32 running max, sum and accumulator, the
// scale applied in f32, causal mask top-left aligned (cols <= rows,
// masked scores = -1e30), columns past Sk at -inf, l clamped at 1e-30,
// lse = m + log l, o written in the input dtype and lse in f32.
//
// What bounds it on the H100: at the LM's serving shape (S 2048, D 64,
// causal) the work is 4*S*S*D/2 FLOPs per (batch, head) against
// 4*S*D*2 bytes, about 500 FLOPs per byte, so the card's arithmetic
// rate bounds it, not its memory (3.35 TB/s). The input dtype and the
// head dim pick one of two kernels (a failed launch raises and is never
// retried on the other):
//
// bf16 with D a multiple of 8 up to 128: `flash_fwd_bf16_kernel`, both products on the tensor cores
// (`mma.sync.m16n8k16`, bf16 operands, f32 accumulators; 989 TFLOP/s
// peak against the CUDA cores' 67):
// - One block of 8 warps per (b*h, 128-row q tile); each warp owns 16 q
//   rows. The flat grid puts the q tiles with the most key tiles first
//   and takes any B*H.
// - Q is copied to shared memory once and held in registers as A
//   fragments (`ldmatrix`). S = Q.K^T lives in accumulator registers; the
//   row max and sum reduce across the 4 lanes (quad) that share a row, in
//   base 2 (exp2 of log2(e)-scaled scores; lse comes back in natural log).
//   P is packed to bf16 in registers: the C fragments of S are the A
//   fragments of P.V, whose B operand is V read with `ldmatrix.trans`.
//   Q, S and P never go through shared memory after the first load.
// - K and V come in as bf16, 128 keys a tile, through a 2-stage ring of
//   16-byte `cp.async` copies (zero-filled past Sk and past D): tile j + 1
//   is in flight while tile j is computed. Rows are padded by 16 bytes so
//   `ldmatrix` reads hit distinct banks.
// - A tile is consumed in softmax steps of 32 keys: 16 score registers a
//   thread, so at D 64 the kernel fits 128 registers and two blocks an SM
//   without spills (one 64-key step spilled; one block an SM ran 27%
//   slower).
// - Causal: key tiles above the block's last row are never loaded; a warp
//   skips a step whose keys all lie above its 16 rows (or past Sk); only
//   steps on the diagonal or the ragged edge apply the mask.
// - D is padded with zeros to DMAX in {32, 64, 128}. The epilogue divides
//   by l, rounds o to bf16 once, and writes it with 16-byte stores through
//   the warp's own rows of the Q buffer.
// The P rounding to bf16 is a rounding point the JAX kernel does not have
// (it keeps P in f32); over S 2048 it stays within 0.4 of the output bar.
//
// f32, bf16 at any other D, and bf16 views that the 16-byte copies cannot
// read (a misaligned pointer or stride): `flash_fwd_kernel`, the first
// port's FMA
// kernel on the CUDA cores (for f32, tensor cores would mean TF32, which
// breaks the f32 bars):
// - One thread block per (b*h, 64-row q tile), on a flat grid that starts
//   the q tiles with the most key tiles first and takes any B*H. The
//   TPU's sequential third grid axis over k blocks becomes a loop inside
//   the block, so the running (m, l, acc) state lives in registers for
//   the whole row tile.
// - Each 64-row K/V tile is staged once in shared memory (f32, rows
//   padded by one word so the 16 threads of a row group hit 16 banks)
//   and reused by all 64 q rows of the block.
// - 256 threads: thread (ty, tx) owns q rows 4*ty..4*ty+3 and score
//   columns tx + 16*j. The row max and row sum are reduced across the 16
//   lanes of a half warp with shuffles; the probabilities go through
//   shared memory to the P·V product, where the same thread owns the same
//   rows, so m and l never leave registers.
// - Causal k tiles above the diagonal are never loaded.
// - The head dim is padded with zeros to 32, 64, 128 or 256 (at 256 the
//   tiles take 209 KB of shared memory). A larger head dim runs the 256
//   instance in chunks of 256 columns: S = Q.K^T is summed over the
//   chunks (Q and K staged one chunk at a time), and the output's columns
//   are split over the grid's second dimension, one chunk a block, each
//   block recomputing S for its own chunk of P.V. So any head dim fits.
// - The same kernel on bf16 inputs (each element loaded as bf16 and
//   computed in f32, o rounded to bf16 once) takes the bf16 head dims the
//   tensor-core kernel does not: above 128, or not a multiple of 8. It
//   reads scalars, so it needs no alignment.
//
// Both take every sequence length: the ragged edge is masked (rows >= Sq
// are not written, columns >= Sk score -inf), so the TPU's 8-aligned block
// rule and its fallback have no counterpart here. Inputs are read through
// (batch, seq, head) strides with a unit stride on the head dim, so the
// model's fused-qkv slices need no copy; the tensor-core kernel needs
// 16-byte aligned pointers and strides that are multiples of 8 elements,
// and a bf16 view without them runs the FMA kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int BLOCK_M = 64;
constexpr int BLOCK_N = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;  // big-but-finite, as the TPU kernel


template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((BLOCK_M + BLOCK_N) * (DMAX + 1) +
                          BLOCK_N * DMAX + BLOCK_M * (BLOCK_N + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int BH, int H, int Sq, int Sk,
                 int D,
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
  const int tile = blockIdx.x / BH;  // the q tiles with most keys first
  const int bh = blockIdx.x - tile * BH;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = ((Sq + BLOCK_M - 1) / BLOCK_M - 1 - tile) * BLOCK_M;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  // the output columns of this block: [oc, oc + DMAX); D > DMAX runs
  // chunked (q re-staged per key tile and chunk)
  const int oc = blockIdx.y * DMAX;
  const bool chunked = D > DMAX;

  // q columns [d0, d0 + DMAX), scaled
  auto stage_q = [&](int d0) {
    for (int idx = tid; idx < BLOCK_M * DMAX; idx += THREADS) {
      const int r = idx / DMAX;
      const int c = idx % DMAX;
      const int row = row0 + r;
      float x = 0.f;
      if (row < Sq && c < D - d0) x = to_f32(qb[row * q_ss + d0 + c]) * scale;
      q_s[r * QK_STRIDE + c] = x;
    }
  };
  if (!chunked) stage_q(0);

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
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    // S over the head dim, one chunk of DMAX columns at a time (one chunk
    // unless chunked); v's chunk for this block's output columns comes in
    // with the first
    for (int d0 = 0; d0 < D; d0 += DMAX) {
      __syncthreads();  // the previous chunk (or tile's P·V) is done with smem
      if (chunked) stage_q(d0);
      for (int idx = tid; idx < BLOCK_N * DMAX; idx += THREADS) {
        const int r = idx / DMAX;
        const int c = idx % DMAX;
        const int col = col0 + r;
        float kx = 0.f;
        if (col < Sk && c < D - d0) kx = to_f32(kb[col * k_ss + d0 + c]);
        k_s[r * QK_STRIDE + c] = kx;
        if (d0 == 0) {
          float vx = 0.f;
          if (col < Sk && c < D - oc) vx = to_f32(vb[col * v_ss + oc + c]);
          v_s[r * DMAX + c] = vx;
        }
      }
      __syncthreads();
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
          for (int jj = 0; jj < 4; ++jj)
            s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
      }
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
      const int col = oc + tx + 16 * c;
      if (col < D) orow[col] = from_f32<T>(acc[i][c] / li);
    }
    if (tx == 0 && blockIdx.y == 0)
      lse[static_cast<int64_t>(bh) * Sq + row] = m[i] + logf(li);
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
  const int64_t blocks =
      static_cast<int64_t>((Sq + BLOCK_M - 1) / BLOCK_M) * B * H;
  const int chunks = (D + DMAX - 1) / DMAX;  // output column chunks
  if (blocks > INT_MAX || chunks > 65535) return cudaErrorInvalidValue;
  flash_fwd_kernel<T, DMAX>
      <<<dim3(static_cast<unsigned>(blocks), chunks), THREADS, smem,
         stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), lse, B * H, H, Sq,
          Sk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
          st[8], scale, causal);
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
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Sk, D, st, scale,
                          causal, stream);
  return launch<T, 256>(q, k, v, o, lse, B, H, Sq, Sk, D, st, scale, causal,
                        stream);
}

// -- bf16: the tensor-core kernel ---------------------------------------------

constexpr int TC_BM = 16 * TC_WARPS;  // q rows per block, 16 per warp
constexpr int TC_BN = 128;            // key rows per staged tile
constexpr int TC_SUB = 32;            // key rows per softmax step
constexpr float LN2 = 0.6931471805599453f;

template <int DMAX>
constexpr size_t bf16_smem_bytes() {  // Q, then 2 stages of K and of V
  return sizeof(bf16) * (TC_BM + 4 * TC_BN) * (DMAX + 8);
}

template <int DMAX>
__global__ void __launch_bounds__(TC_THREADS, DMAX <= 64 ? 2 : 1)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int BH, int H, int Sq, int Sk,
                      int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                      int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                      int64_t v_ss, int64_t v_sh, float scale, int causal) {
  constexpr int LD = DMAX + 8;  // padded row: ldmatrix rows hit 8 banks
  constexpr int KD = DMAX / 16;  // k16 steps over the head dim
  constexpr int NS = TC_SUB / 8;  // n8 tiles of a warp's score rows
  constexpr int NO = DMAX / 8;   // n8 tiles of a warp's output rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16(*q_s)[LD] = reinterpret_cast<bf16(*)[LD]>(smem_raw);
  bf16(*k_s)[TC_BN][LD] = reinterpret_cast<bf16(*)[TC_BN][LD]>(
      smem_raw + sizeof(bf16) * TC_BM * LD);
  bf16(*v_s)[TC_BN][LD] = reinterpret_cast<bf16(*)[TC_BN][LD]>(
      smem_raw + sizeof(bf16) * (TC_BM + 2 * TC_BN) * LD);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix: lane gives a row address of matrix lane / 8
  const int lm = lane >> 3, lr = lane & 7;
  const int n_qt = (Sq + TC_BM - 1) / TC_BM;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int b = bh / H, h = bh % H;
  const int row0 = qt * TC_BM;
  const int wrow = row0 + warp * 16;  // this warp's first q row
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;

  int n_tiles = (Sk + TC_BN - 1) / TC_BN;
  if (causal) n_tiles = min(n_tiles, (min(row0 + TC_BM, Sq) - 1) / TC_BN + 1);

  stage_rows<TC_BM, DMAX>(q_s, qb, q_ss, row0, Sq, D);
  stage_rows<TC_BN, DMAX>(k_s[0], kb, k_ss, 0, Sk, D);
  stage_rows<TC_BN, DMAX>(v_s[0], vb, v_ss, 0, Sk, D);
  cp_async_commit();

  const float sl2 = scale * LOG2E;
  uint32_t qf[KD][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows wrow + g (lo) and wrow + g + 8 (hi): running max (base 2) and
  // this thread's share of the running sum
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {  // tile j + 1 flies while tile j is computed
      stage_rows<TC_BN, DMAX>(k_s[st ^ 1], kb, k_ss, (j + 1) * TC_BN, Sk, D);
      stage_rows<TC_BN, DMAX>(v_s[st ^ 1], vb, v_ss, (j + 1) * TC_BN, Sk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qf[kd], &q_s[warp * 16 + lr + (lm & 1) * 8]
                                [kd * 16 + (lm >> 1) * 8]);
    }
#pragma unroll
    for (int c0 = 0; c0 < TC_BN; c0 += TC_SUB) {  // a softmax step
      const int col0 = j * TC_BN + c0;
      // a step past Sk, or wholly above this warp's rows, has p = 0
      if (col0 < Sk && (!causal || col0 <= wrow + 15)) {
        float s[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
          for (int np = 0; np < NS / 2; ++np) {
            uint32_t kf[4];  // B fragments of key tiles 2np and 2np + 1
            ldmatrix_x4(kf, &k_s[st][c0 + np * 16 + lr + (lm >> 1) * 8]
                                [kd * 16 + (lm & 1) * 8]);
            mma_bf16(s[2 * np], qf[kd], kf);
            mma_bf16(s[2 * np + 1], qf[kd], kf + 2);
          }
        }
        const bool edge =
            col0 + TC_SUB > Sk || (causal && col0 + TC_SUB - 1 > wrow);
        float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[n][e] * sl2;
            if (edge) {
              const int col = col0 + n * 8 + 2 * t + (e & 1);
              const int row = wrow + g + (e >> 1) * 8;
              if (col >= Sk)
                x = -INFINITY;
              else if (causal && col > row)
                x = NEG_INF;
            }
            s[n][e] = x;
          }
          mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
          mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
          mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
        }
        const float a_lo = exp2f(m_lo - mx_lo), a_hi = exp2f(m_hi - mx_hi);
        m_lo = mx_lo;
        m_hi = mx_hi;
        l_lo *= a_lo;
        l_hi *= a_hi;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[n][0] *= a_lo;
          acc[n][1] *= a_lo;
          acc[n][2] *= a_hi;
          acc[n][3] *= a_hi;
        }
        uint32_t pf[NS / 2][4];  // P as the A fragments of P.V, in bf16
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float p0 = exp2f(s[n][0] - m_lo), p1 = exp2f(s[n][1] - m_lo);
          const float p2 = exp2f(s[n][2] - m_hi), p3 = exp2f(s[n][3] - m_hi);
          l_lo += p0 + p1;
          l_hi += p2 + p3;
          pf[n / 2][(n & 1) * 2] = pack2(p0, p1);
          pf[n / 2][(n & 1) * 2 + 1] = pack2(p2, p3);
        }
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {
#pragma unroll
          for (int np = 0; np < NO / 2; ++np) {
            uint32_t vf[4];  // B fragments of output tiles 2np and 2np + 1
            ldmatrix_x4_trans(vf, &v_s[st][c0 + kk * 16 + lr + (lm & 1) * 8]
                                      [np * 16 + (lm >> 1) * 8]);
            mma_bf16(acc[2 * np], pf[kk], vf);
            mma_bf16(acc[2 * np + 1], pf[kk], vf + 2);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage st
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  l_lo = fmaxf(l_lo, 1e-30f);  // fully-masked rows
  l_hi = fmaxf(l_hi, 1e-30f);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  // o through this warp's own 16 rows of q_s, which only this warp read
  store_rows_16B<DMAX>(o + (static_cast<int64_t>(b) * Sq * H + h) * D,
                       static_cast<int64_t>(H) * D, wrow, Sq, D,
                       q_s + warp * 16, acc, inv_lo, inv_hi);
  if (t == 0) {
    const int64_t at = static_cast<int64_t>(bh) * Sq + wrow + g;
    if (wrow + g < Sq) lse[at] = m_lo * LN2 + logf(l_lo);
    if (wrow + g + 8 < Sq) lse[at + 8] = m_hi * LN2 + logf(l_hi);
  }
}

template <int DMAX>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int H, int Sq, int Sk, int D,
                        const int64_t* st, float scale, int causal,
                        cudaStream_t stream) {
  constexpr size_t smem = bf16_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks =
      static_cast<int64_t>((Sq + TC_BM - 1) / TC_BM) * B * H;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_fwd_bf16_kernel<DMAX>
      <<<static_cast<unsigned>(blocks), TC_THREADS, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, B * H, H,
          Sq, Sk, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
          st[8], scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [B, S, H, D] read through strides (in elements) `strides` =
// {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h}; the head dim is unit
// stride. o: contiguous [B, Sq, H, D] in the input dtype. lse: contiguous
// [B, H, Sq] f32. dtype: 0 = float32 (the FMA kernel), 1 = bfloat16: the
// tensor-core kernel for D a multiple of 8 up to 128 with 16-byte aligned
// pointers and strides multiples of 8, the FMA kernel on bf16 inputs for
// any other D or layout (the caller counts that route). Any D (above 256
// in chunks of 256), any B*H. Returns the launch's cudaError_t; the caller
// checks it.
extern "C" int kftpu_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int H, int Sq, int Sk, int D, const int64_t* strides, float scale,
    int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return cudaSuccess;
  if (D <= 0 || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(q, k, v, o, lse, B, H, Sq, Sk, D, strides,
                               scale, causal, s);
  if (!tensor_core_dim(D) || !async_ready(q, strides, B, Sq, H) ||
      !async_ready(k, strides + 3, B, Sk, H) ||
      !async_ready(v, strides + 6, B, Sk, H) ||
      reinterpret_cast<uintptr_t>(o) % 16)
    return dispatch_dim<bf16>(q, k, v, o, lse, B, H, Sq, Sk, D, strides,
                              scale, causal, s);
  if (D <= 32)
    return launch_bf16<32>(q, k, v, o, lse, B, H, Sq, Sk, D, strides, scale,
                           causal, s);
  if (D <= 64)
    return launch_bf16<64>(q, k, v, o, lse, B, H, Sq, Sk, D, strides, scale,
                           causal, s);
  return launch_bf16<128>(q, k, v, o, lse, B, H, Sq, Sk, D, strides, scale,
                          causal, s);
}

extern "C" const char* kftpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
