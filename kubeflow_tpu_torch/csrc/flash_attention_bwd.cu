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
// split into two kernels stays (they recompute s and dp in both). In bf16
// both run on the tensor cores (`mma.sync.m16n8k16`, bf16 operands, f32
// accumulators; 989 TFLOP/s peak against the CUDA cores' 67); each output
// element has one owner, so there are no atomics and the backward is
// deterministic:
//
// K2a in bf16: `flash_bwd_dq_bf16_kernel`, its three products on the
// tensor cores:
// - One block of 8 warps owns one 128-row q tile of one (b, h); each warp
//   owns 16 q rows, and dQ accumulates in its registers over the key
//   tiles, up to the diagonal. The flat grid starts the q tiles with the
//   most key tiles first and takes any B*H.
// - Q and dO are copied in once and held as A fragments (`ldmatrix`);
//   lse and delta belong to the warp's own rows, so they sit in registers.
// - K and V come in 128 keys a tile through a 2-stage ring of 16-byte
//   `cp.async` copies (zero-filled past Sk and D): tile j + 1 is in
//   flight while tile j is computed. A tile is consumed in steps of 32
//   keys: S = Q.K^T and dP = dO.V^T (K and V as B operands, plain
//   `ldmatrix`), P = exp(S scale - lse), dS = P (dP - delta), and dS,
//   packed to bf16 straight from the C fragments, is the A operand of
//   dQ += dS.K, with K read again from the same staged tile through
//   `ldmatrix.trans`: dS never goes through shared memory.
// - Causal: key tiles above the block's last row are never loaded; a warp
//   skips a step whose keys all lie above its 16 rows (or past Sk); only
//   steps on the diagonal or the ragged edge apply the mask.
// - dQ is scaled once in f32 and written with 16-byte stores through the
//   warp's own rows of the Q buffer.
//
// K2b in bf16: `flash_bwd_dkv_bf16_kernel`, its four products on the
// tensor cores:
// - One block of 8 warps owns one 128-row k tile of one (b, h); each warp
//   owns 16 key rows, and dK and dV accumulate in its registers over the
//   q tiles (64 rows; 32 at D 128, for registers), from the diagonal
//   down. The flat grid starts the k tiles with the most q tiles first
//   and takes any B*H.
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
//
// dS (both) and P (K2b) are rounded to bf16 before their products, a
// rounding point the JAX kernels do not have (they keep them in f32);
// over S 2048 the gradients stay within 0.6 of the bar that holds them.
//
// In f32, and in bf16 at any other head dim (above 128, or not a multiple
// of 8) or layout (each element loaded as bf16 and computed in f32, the
// gradients rounded to bf16 once): the first port's FMA kernels on the CUDA
// cores (for f32, tensor cores would mean TF32, which breaks the f32 bars):
// - The TPU kernels carry their accumulators in VMEM across a sequential
//   grid axis. Here one block owns one 64-row q tile (K2a) or one 64-row
//   k tile (K2b) of one (batch, head) and loops over the other axis
//   itself, in tiles of 64 rows (32 at head dim 256, so that the f32
//   tiles fit 227 KB of shared memory), so the dq (K2a) or dk/dv (K2b)
//   accumulators stay in registers for the whole loop. The grid is flat,
//   as in bf16, and takes any B*H.
// - Causal: K2a visits k tiles up to the diagonal; K2b visits q tiles
//   from the diagonal down. Tiles wholly above the diagonal are never
//   loaded (the TPU's `_when_relevant`).
// - 256 threads: thread (ty, tx) owns tile rows 4*ty..4*ty+3 and score
//   columns tx + 16*j, as in the forward kernel. Scores and dp are
//   computed in registers; p and ds go through shared memory to the
//   products that contract over the score columns.
//
// All of them take every sequence length: the ragged edge is masked (rows
// >= Sq and columns >= Sk give p = 0 and are not written). The head dim
// is padded with zeros to 32, 64, 128 or 256: the tensor-core kernels take
// a multiple of 8 up to 128 (their 16-byte copies), the FMA kernels any
// head dim: above 256 the 256 instance loops over the head dim in chunks
// of 256 (S and dP summed over the chunks, each chunk's q, do, k and v
// staged in turn) and splits the dq (or dk, dv) columns over the grid's
// second dimension, one chunk a block, each block recomputing S and dP,
// so no tile exceeds the shared memory. q, k, v and do are read
// through (batch, seq, head) strides with a unit stride on the head dim,
// so the model's fused-qkv slices need no copy; the tensor-core kernels
// need 16-byte aligned pointers and strides that are multiples of 8
// elements, and a bf16 view without them runs the FMA kernels. lse and
// delta are contiguous [B, H, Sq] f32; dq, dk and dv are written
// contiguous [B, S, H, D].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "warp_mma.cuh"

namespace {

constexpr int BLOCK_M = 64;  // q rows per K2a tile
constexpr int BLOCK_N = 64;  // k rows per K2b tile
constexpr int THREADS = 256;

struct Strides {  // in elements; the head dim is unit stride
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// rows [row0, row0 + ROWS) of a [.., S, .., D] input into a padded f32
// tile; columns >= D are zero-filled
template <int ROWS, int DMAX, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int rows, int D) {
  for (int idx = threadIdx.x; idx < ROWS * DMAX; idx += THREADS) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    const int row = row0 + r;
    float x = 0.f;
    if (row < rows && c < D) x = to_f32(src[row * row_stride + c]);
    dst[r * (DMAX + 1) + c] = x;
  }
}

// the FMA kernels' other tile side (K2a's k rows, K2b's q rows): 64, or 32
// at DMAX 256 so that the tiles fit 227 KB of shared memory
template <int DMAX>
__host__ __device__ constexpr int fma_tile() {
  return DMAX > 128 ? 32 : 64;
}

template <int DMAX>
constexpr size_t dq_smem_bytes() {
  constexpr int BN = fma_tile<DMAX>();
  return sizeof(float) *
         ((2 * BLOCK_M + 2 * BN) * (DMAX + 1) + BLOCK_M * (BN + 1));
}

template <int DMAX>
constexpr size_t dkv_smem_bytes() {
  constexpr int BM = fma_tile<DMAX>();
  return sizeof(float) * ((2 * BLOCK_N + 2 * BM) * (DMAX + 1) +
                          2 * BLOCK_N * (BM + 1) + 2 * BM);
}

// K2a on the CUDA cores: one block per (b*h, 64-row q tile), the q tiles
// with the most k tiles first; loops over k tiles of BN rows.
template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int BH, int H, int Sq, int Sk, int D, Strides st,
                    float scale, int causal) {
  constexpr int BN = fma_tile<DMAX>();
  constexpr int JN = BN / 16;      // score columns per thread
  constexpr int P_LD = BN + 1;     // padded row of a score tile
  constexpr int LD = DMAX + 1;
  constexpr int COLS = DMAX / 16;  // head-dim columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                 // [BLOCK_M][LD]
  float* do_s = q_s + BLOCK_M * LD;  // [BLOCK_M][LD]
  float* k_s = do_s + BLOCK_M * LD;  // [BN][LD]
  float* v_s = k_s + BN * LD;        // [BN][LD]
  float* ds_s = v_s + BN * LD;       // [BLOCK_M][P_LD]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int tile = blockIdx.x / BH;
  const int bh = blockIdx.x - tile * BH;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = ((Sq + BLOCK_M - 1) / BLOCK_M - 1 - tile) * BLOCK_M;

  // this block's dq columns [oc, oc + DMAX); D > DMAX runs chunked: S and
  // dP summed over chunks of the head dim, q and do re-staged per tile
  const int oc = blockIdx.y * DMAX;
  const bool chunked = D > DMAX;
  const T* qb = q + b * st.qb + h * st.qh;
  const T* ob = dout + b * st.ob + h * st.oh;
  if (!chunked) {
    load_tile<BLOCK_M, DMAX>(q_s, qb, st.qs, row0, Sq, D);
    load_tile<BLOCK_M, DMAX>(do_s, ob, st.os, row0, Sq, D);
  }
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

  int n_tiles = (Sk + BN - 1) / BN;
  if (causal) {
    const int last_row = min(row0 + BLOCK_M, Sq) - 1;
    n_tiles = min(n_tiles, last_row / BN + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int col0 = j * BN;
    float s[4][JN], dp[4][JN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < JN; ++jj) s[i][jj] = dp[i][jj] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DMAX) {
      __syncthreads();  // the previous chunk's (tile's ds.k) reads are done
      if (chunked) {
        load_tile<BLOCK_M, DMAX>(q_s, qb + d0, st.qs, row0, Sq, D - d0);
        load_tile<BLOCK_M, DMAX>(do_s, ob + d0, st.os, row0, Sq, D - d0);
      }
      load_tile<BN, DMAX>(k_s, kb + d0, st.ks, col0, Sk, D - d0);
      load_tile<BN, DMAX>(v_s, vb + d0, st.vs, col0, Sk, D - d0);
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DMAX; ++c) {
        float qv[4], dov[4], kv[JN], vv[JN];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = q_s[(ty * 4 + i) * LD + c];
          dov[i] = do_s[(ty * 4 + i) * LD + c];
        }
#pragma unroll
        for (int jj = 0; jj < JN; ++jj) {
          kv[jj] = k_s[(tx + 16 * jj) * LD + c];
          vv[jj] = v_s[(tx + 16 * jj) * LD + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < JN; ++jj) {
            s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
            dp[i][jj] = fmaf(dov[i], vv[jj], dp[i][jj]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < JN; ++jj) {
        const int col = col0 + tx + 16 * jj;
        float p = 0.f;
        if (row < Sq && col < Sk && !(causal && col > row))
          p = expf(s[i][jj] * scale - lse_r[i]);
        ds_s[(ty * 4 + i) * P_LD + tx + 16 * jj] = p * (dp[i][jj] - delta_r[i]);
      }
    }
    if (chunked) {  // k's columns of this block's dq chunk
      __syncthreads();
      load_tile<BN, DMAX>(k_s, kb + oc, st.ks, col0, Sk, D - oc);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
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
      const int col = oc + tx + 16 * c;
      if (col < D) out[col] = from_f32<T>(acc[i][c] * scale);
    }
  }
}

// K2b on the CUDA cores: one block per (b*h, 64-row k tile), the k tiles
// with the most q tiles (the first ones) first; loops over q tiles of BM
// rows.
template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int BH, int H, int Sq, int Sk,
                     int D, Strides st, float scale, int causal) {
  constexpr int BM = fma_tile<DMAX>();
  constexpr int JQ = BM / 16;   // q columns of S^T per thread
  constexpr int P_LD = BM + 1;  // padded row of a transposed score tile
  constexpr int LD = DMAX + 1;
  constexpr int COLS = DMAX / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                    // [BLOCK_N][LD]
  float* v_s = k_s + BLOCK_N * LD;      // [BLOCK_N][LD]
  float* q_s = v_s + BLOCK_N * LD;      // [BM][LD]
  float* do_s = q_s + BM * LD;          // [BM][LD]
  float* p_s = do_s + BM * LD;          // [BLOCK_N][P_LD], p transposed
  float* ds_s = p_s + BLOCK_N * P_LD;   // [BLOCK_N][P_LD], ds transposed
  float* lse_s = ds_s + BLOCK_N * P_LD; // [BM]
  float* delta_s = lse_s + BM;          // [BM]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int tile = blockIdx.x / BH;
  const int bh = blockIdx.x - tile * BH;
  const int b = bh / H;
  const int h = bh % H;
  const int col0 = tile * BLOCK_N;  // this block's k rows

  // this block's dk and dv columns [oc, oc + DMAX); D > DMAX runs chunked:
  // S^T and dP^T summed over chunks of the head dim, k and v re-staged per
  // q tile
  const int oc = blockIdx.y * DMAX;
  const bool chunked = D > DMAX;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  if (!chunked) {
    load_tile<BLOCK_N, DMAX>(k_s, kb, st.ks, col0, Sk, D);
    load_tile<BLOCK_N, DMAX>(v_s, vb, st.vs, col0, Sk, D);
  }
  const T* qb = q + b * st.qb + h * st.qh;
  const T* ob = dout + b * st.ob + h * st.oh;

  float dk_acc[4][COLS], dv_acc[4][COLS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_q = (Sq + BM - 1) / BM;
  const int first = causal ? col0 / BM : 0;  // the diagonal tile
  for (int it = first; it < n_q; ++it) {
    const int row0 = it * BM;
    // transposed tiles: sT[kr][qc] = k[kr].q[qc], dpT[kr][qc] = v[kr].do[qc]
    float sT[4][JQ], dpT[4][JQ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < JQ; ++jj) sT[i][jj] = dpT[i][jj] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DMAX) {
      __syncthreads();  // the previous chunk's (tile's products') reads are done
      if (chunked) {
        load_tile<BLOCK_N, DMAX>(k_s, kb + d0, st.ks, col0, Sk, D - d0);
        load_tile<BLOCK_N, DMAX>(v_s, vb + d0, st.vs, col0, Sk, D - d0);
      }
      load_tile<BM, DMAX>(q_s, qb + d0, st.qs, row0, Sq, D - d0);
      load_tile<BM, DMAX>(do_s, ob + d0, st.os, row0, Sq, D - d0);
      if (d0 == 0 && threadIdx.x < BM) {
        const int row = row0 + threadIdx.x;
        const int64_t at = static_cast<int64_t>(bh) * Sq + row;
        lse_s[threadIdx.x] = row < Sq ? lse[at] : 0.f;
        delta_s[threadIdx.x] = row < Sq ? delta[at] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DMAX; ++c) {
        float kv[4], vv[4], qv[JQ], dov[JQ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = k_s[(ty * 4 + i) * LD + c];
          vv[i] = v_s[(ty * 4 + i) * LD + c];
        }
#pragma unroll
        for (int jj = 0; jj < JQ; ++jj) {
          qv[jj] = q_s[(tx + 16 * jj) * LD + c];
          dov[jj] = do_s[(tx + 16 * jj) * LD + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < JQ; ++jj) {
            sT[i][jj] = fmaf(kv[i], qv[jj], sT[i][jj]);
            dpT[i][jj] = fmaf(vv[i], dov[jj], dpT[i][jj]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int krow = col0 + ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < JQ; ++jj) {
        const int qc = tx + 16 * jj;
        const int qrow = row0 + qc;
        float p = 0.f;
        if (qrow < Sq && krow < Sk && !(causal && krow > qrow))
          p = expf(sT[i][jj] * scale - lse_s[qc]);
        p_s[(ty * 4 + i) * P_LD + qc] = p;
        ds_s[(ty * 4 + i) * P_LD + qc] = p * (dpT[i][jj] - delta_s[qc]);
      }
    }
    if (chunked) {  // q's and do's columns of this block's dk, dv chunk
      __syncthreads();
      load_tile<BM, DMAX>(q_s, qb + oc, st.qs, row0, Sq, D - oc);
      load_tile<BM, DMAX>(do_s, ob + oc, st.os, row0, Sq, D - oc);
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BM; ++qq) {
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
      const int col = oc + tx + 16 * c;
      if (col < D) {
        dk[at + col] = from_f32<T>(dk_acc[i][c] * scale);
        dv[at + col] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

// a flat grid of `tiles` x B*H blocks, within gridDim.x's limit
bool flat_grid(int tiles, int B, int H, unsigned* blocks) {
  const int64_t n = static_cast<int64_t>(tiles) * B * H;
  *blocks = static_cast<unsigned>(n);
  return n <= INT_MAX;
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
  unsigned blocks;
  const int chunks = (D + DMAX - 1) / DMAX;  // dq column chunks
  if (!flat_grid((Sq + BLOCK_M - 1) / BLOCK_M, B, H, &blocks) ||
      chunks > 65535)
    return cudaErrorInvalidValue;
  flash_bwd_dq_kernel<T, DMAX><<<dim3(blocks, chunks), THREADS, smem,
                                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), B * H, H, Sq, Sk, D, st, scale, causal);
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
  unsigned blocks;
  const int chunks = (D + DMAX - 1) / DMAX;  // dk, dv column chunks
  if (!flat_grid((Sk + BLOCK_N - 1) / BLOCK_N, B, H, &blocks) ||
      chunks > 65535)
    return cudaErrorInvalidValue;
  flash_bwd_dkv_kernel<T, DMAX><<<dim3(blocks, chunks), THREADS, smem,
                                  stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), B * H, H, Sq, Sk, D, st,
      scale, causal);
  return cudaGetLastError();
}

// -- K2a, bf16: the tensor-core kernel ----------------------------------------

constexpr int TC_QB = 16 * TC_WARPS;  // q rows per block, 16 per warp
constexpr int TC_KT = 128;            // key rows per staged tile
constexpr int TC_SUB = 32;            // key rows per step

template <int DMAX>
constexpr size_t dq_bf16_smem_bytes() {  // Q, dO, then 2 stages of K and V
  return sizeof(bf16) * (2 * TC_QB + 4 * TC_KT) * (DMAX + 8);
}

template <int DMAX>
__global__ void __launch_bounds__(TC_THREADS, DMAX <= 64 ? 2 : 1)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int BH, int H, int Sq, int Sk,
                         int D, Strides st, float scale, int causal) {
  constexpr int LD = DMAX + 8;   // padded row: ldmatrix rows hit 8 banks
  constexpr int KD = DMAX / 16;  // k16 steps over the head dim
  constexpr int NS = TC_SUB / 8;  // n8 tiles of a warp's score rows
  constexpr int NO = DMAX / 8;   // n8 tiles of a warp's dQ rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16(*q_s)[LD] = reinterpret_cast<bf16(*)[LD]>(smem_raw);
  bf16(*do_s)[LD] = q_s + TC_QB;
  bf16(*k_s)[TC_KT][LD] = reinterpret_cast<bf16(*)[TC_KT][LD]>(do_s + TC_QB);
  bf16(*v_s)[TC_KT][LD] = k_s + 2;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix row addresses
  const int n_qt = (Sq + TC_QB - 1) / TC_QB;
  const int bh = blockIdx.x % BH;
  // the q tiles with the most key tiles (the last ones) start first
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int b = bh / H, h = bh % H;
  const int row0 = qt * TC_QB;
  const int wrow = row0 + warp * 16;  // this warp's first q row
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;

  int n_tiles = (Sk + TC_KT - 1) / TC_KT;
  if (causal) n_tiles = min(n_tiles, (min(row0 + TC_QB, Sq) - 1) / TC_KT + 1);

  stage_rows<TC_QB, DMAX>(q_s, q + b * st.qb + h * st.qh, st.qs, row0, Sq,
                          D);
  stage_rows<TC_QB, DMAX>(do_s, dout + b * st.ob + h * st.oh, st.os, row0,
                          Sq, D);
  stage_rows<TC_KT, DMAX>(k_s[0], kb, st.ks, 0, Sk, D);
  stage_rows<TC_KT, DMAX>(v_s[0], vb, st.vs, 0, Sk, D);
  cp_async_commit();

  // lse (base 2) and delta of this thread's rows wrow + g (lo) and
  // wrow + g + 8 (hi); rows past Sq have p = 1 and dS = 0 and are not
  // written
  const int64_t row_at = static_cast<int64_t>(bh) * Sq;
  const int r_lo = wrow + g, r_hi = wrow + g + 8;
  const float lse_lo = r_lo < Sq ? lse[row_at + r_lo] * LOG2E : 0.f;
  const float lse_hi = r_hi < Sq ? lse[row_at + r_hi] * LOG2E : 0.f;
  const float dl_lo = r_lo < Sq ? delta[row_at + r_lo] : 0.f;
  const float dl_hi = r_hi < Sq ? delta[row_at + r_hi] : 0.f;

  const float sl2 = scale * LOG2E;
  uint32_t qf[KD][4], of[KD][4];  // Q and dO as A fragments
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int sx = j & 1;
    if (j + 1 < n_tiles) {  // tile j + 1 flies while tile j is computed
      stage_rows<TC_KT, DMAX>(k_s[sx ^ 1], kb, st.ks, (j + 1) * TC_KT, Sk, D);
      stage_rows<TC_KT, DMAX>(v_s[sx ^ 1], vb, st.vs, (j + 1) * TC_KT, Sk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        ldmatrix_x4(qf[kd], &q_s[warp * 16 + lr + (lm & 1) * 8]
                                [kd * 16 + (lm >> 1) * 8]);
        ldmatrix_x4(of[kd], &do_s[warp * 16 + lr + (lm & 1) * 8]
                                 [kd * 16 + (lm >> 1) * 8]);
      }
    }
#pragma unroll
    for (int c0 = 0; c0 < TC_KT; c0 += TC_SUB) {  // a step of 32 keys
      const int col0 = j * TC_KT + c0;
      // a step past Sk, or wholly above this warp's rows, has p = 0
      if (col0 < Sk && (!causal || col0 <= wrow + 15)) {
        // S = Q.K^T and dP = dO.V^T: 16 q rows by 32 keys
        float s[NS][4], dp[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
          for (int np = 0; np < NS / 2; ++np) {
            uint32_t kf[4], vf[4];  // B fragments of key tiles 2np, 2np + 1
            ldmatrix_x4(kf, &k_s[sx][c0 + np * 16 + lr + (lm >> 1) * 8]
                                [kd * 16 + (lm & 1) * 8]);
            ldmatrix_x4(vf, &v_s[sx][c0 + np * 16 + lr + (lm >> 1) * 8]
                                [kd * 16 + (lm & 1) * 8]);
            mma_bf16(s[2 * np], qf[kd], kf);
            mma_bf16(s[2 * np + 1], qf[kd], kf + 2);
            mma_bf16(dp[2 * np], of[kd], vf);
            mma_bf16(dp[2 * np + 1], of[kd], vf + 2);
          }
        }
        // dS = P (dP - delta), packed to bf16 as the A fragments of dS.K
        const bool edge =
            col0 + TC_SUB > Sk || (causal && col0 + TC_SUB - 1 > wrow);
        uint32_t dsf[NS / 2][4];
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(s[n][e] * sl2 - (e < 2 ? lse_lo : lse_hi));
            if (edge) {
              const int col = col0 + n * 8 + 2 * t + (e & 1);
              const int row = wrow + g + (e >> 1) * 8;
              if (col >= Sk || (causal && col > row)) p = 0.f;
            }
            d[e] = p * (dp[n][e] - (e < 2 ? dl_lo : dl_hi));
          }
          dsf[n / 2][(n & 1) * 2] = pack2(d[0], d[1]);
          dsf[n / 2][(n & 1) * 2 + 1] = pack2(d[2], d[3]);
        }
        // dQ += dS.K, contracting over the step's 32 keys
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {
#pragma unroll
          for (int np = 0; np < NO / 2; ++np) {
            uint32_t kf[4];  // B fragments of head-dim tiles 2np, 2np + 1
            ldmatrix_x4_trans(kf, &k_s[sx][c0 + kk * 16 + lr + (lm & 1) * 8]
                                      [np * 16 + (lm >> 1) * 8]);
            mma_bf16(acc[2 * np], dsf[kk], kf);
            mma_bf16(acc[2 * np + 1], dsf[kk], kf + 2);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage sx
  }

  // dQ, scaled once in f32, through this warp's own 16 rows of q_s
  store_rows_16B<DMAX>(dq + (static_cast<int64_t>(b) * Sq * H + h) * D,
                       static_cast<int64_t>(H) * D, wrow, Sq, D,
                       q_s + warp * 16, acc, scale, scale);
}

template <int DMAX>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, int B, int H, int Sq,
                           int Sk, int D, const Strides& st, float scale,
                           int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_bf16_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel<DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  unsigned blocks;
  if (!flat_grid((Sq + TC_QB - 1) / TC_QB, B, H, &blocks))
    return cudaErrorInvalidValue;
  flash_bwd_dq_bf16_kernel<DMAX><<<blocks, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dq), B * H, H, Sq, Sk, D, st, scale, causal);
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
  unsigned blocks;
  if (!flat_grid((Sk + TC_KB - 1) / TC_KB, B, H, &blocks))
    return cudaErrorInvalidValue;
  flash_bwd_dkv_bf16_kernel<DMAX><<<blocks, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), B * H, H, Sq,
      Sk, D, st, scale, causal);
  return cudaGetLastError();
}

Strides strides_from(const int64_t* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4],  s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11]};
}

// the FMA kernels take any head dim (above 256 in chunks), the
// tensor-core ones multiples of 8 up to 128 (tensor_core_dim)
bool bad_args(int D, int dtype) { return D <= 0 || dtype < 0 || dtype > 1; }

// whether the tensor-core kernels' 16-byte copies can read q, k, v and do
bool tc_ready(const void* q, const void* k, const void* v, const void* dout,
              const int64_t* strides, int B, int Sq, int Sk, int H) {
  return async_ready(q, strides, B, Sq, H) &&
         async_ready(k, strides + 3, B, Sk, H) &&
         async_ready(v, strides + 6, B, Sk, H) &&
         async_ready(dout, strides + 9, B, Sq, H);
}

// calls f with the head-dim template (32, 64, 128 or 256) that D is padded
// to (above 256: the 256 instance, in chunks)
template <typename F>
cudaError_t by_dim(int D, F f) {
  if (D <= 32) return f(std::integral_constant<int, 32>());
  if (D <= 64) return f(std::integral_constant<int, 64>());
  if (D <= 128) return f(std::integral_constant<int, 128>());
  return f(std::integral_constant<int, 256>());
}

// the same for the tensor-core kernels (tensor_core_dim(D))
template <typename F>
cudaError_t by_tc_dim(int D, F f) {
  if (D <= 32) return f(std::integral_constant<int, 32>());
  if (D <= 64) return f(std::integral_constant<int, 64>());
  return f(std::integral_constant<int, 128>());
}

}  // namespace

// q, k, v, dout: [B, S, H, D] read through strides (in elements)
// `strides` = {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s,
// do_h}; the head dim is unit stride. lse, delta: contiguous [B, H, Sq]
// f32. dq: contiguous [B, Sq, H, D] in the input dtype. dtype: 0 =
// float32 (the FMA kernel, D <= 256), 1 = bfloat16 (the tensor-core
// kernel for D a multiple of 8 up to 128, with 16-byte aligned pointers
// and strides multiples of 8; the FMA kernel on bf16 inputs for any other
// D <= 256). Any B*H. Returns the launch's cudaError_t.
extern "C" int kftpu_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int B, int H, int Sq,
    int Sk, int D, const int64_t* strides, float scale, int causal,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return cudaSuccess;
  if (bad_args(D, dtype)) return cudaErrorInvalidValue;
  const Strides st = strides_from(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 || !tensor_core_dim(D) ||
      !tc_ready(q, k, v, dout, strides, B, Sq, Sk, H) ||
      reinterpret_cast<uintptr_t>(dq) % 16)
    return by_dim(D, [&](auto dm) {
      constexpr int DM = decltype(dm)::value;
      return dtype == 0
          ? launch_dq<float, DM>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk,
                                 D, st, scale, causal, s)
          : launch_dq<bf16, DM>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk,
                                D, st, scale, causal, s);
    });
  return by_tc_dim(D, [&](auto dm) {
    return launch_dq_bf16<decltype(dm)::value>(q, k, v, dout, lse, delta, dq,
                                               B, H, Sq, Sk, D, st, scale,
                                               causal, s);
  });
}

// Same inputs and dtypes; dk, dv: contiguous [B, Sk, H, D] in the input
// dtype.
extern "C" int kftpu_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int D, const int64_t* strides, float scale, int causal,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return cudaSuccess;
  if (bad_args(D, dtype)) return cudaErrorInvalidValue;
  const Strides st = strides_from(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 || !tensor_core_dim(D) ||
      !tc_ready(q, k, v, dout, strides, B, Sq, Sk, H) ||
      reinterpret_cast<uintptr_t>(dk) % 16 ||
      reinterpret_cast<uintptr_t>(dv) % 16)
    return by_dim(D, [&](auto dm) {
      constexpr int DM = decltype(dm)::value;
      return dtype == 0
          ? launch_dkv<float, DM>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                                  Sk, D, st, scale, causal, s)
          : launch_dkv<bf16, DM>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                                 Sk, D, st, scale, causal, s);
    });
  return by_tc_dim(D, [&](auto dm) {
    return launch_dkv_bf16<decltype(dm)::value>(q, k, v, dout, lse, delta,
                                                dk, dv, B, H, Sq, Sk, D, st,
                                                scale, causal, s);
  });
}

extern "C" const char* kftpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
