// Fused ResNet bottleneck, inference (BN folded to an affine), for Hopper
// (sm_90a), behind a plain C interface that
// kubeflow_tpu_torch/ops/fused_block.py binds with ctypes.
//
// Replaces K6: kubeflow_tpu/ops/fused_block.py `_kernel`, launched by
// `fused_bottleneck_eval`, one call per stride-1 bottleneck of
// `fused_eval_apply`'s forward (13 in ResNet-50).
//
// The function, per block (x [N, H, W, Cin] bf16 NHWC; conv weights bf16;
// folded scales s and shifts b f32; every product of bf16 operands summed
// in f32):
//   h1  = bf16(relu(x.w1 * s1 + b1))
//   h2  = bf16(relu(sum over the 9 taps of shift(h1).w2[dy, dx] * s2 + b2)),
//         the 3x3 conv zero-padded by 1 at every image's border
//   h3  = bf16(h2.w3 * s3 + b3)
//   res = bf16(x.wp * sp + bp), or x itself without a projection
//   out = relu(bf16(h3 + res)), the two bf16 values added in f32
// Each affine is a product then a sum, each rounded on its own (no FMA), as
// the TPU kernel computes them.
//
// What bounds it on the H100: at ResNet-50's stride-1 geometries (224 px,
// batch 64) a block is 28-30 GFLOP of bf16 products against 26-206 MB of x
// and out, so the memory rate bounds the 56x56 blocks and the tensor cores
// the 28x28, 14x14 and 7x7 ones (chip_smoke.py prints each bound). The TPU
// kernel keeps a batch tile's whole interior in VMEM; a 56x56x64 bf16 h1 is
// 392 KiB an image, more than an SM's 227 KB of shared memory, so here the
// block is three launches of the warpgroup product (wgmma_gemm.cuh: TMA
// and `cp.async` into a 4-stage swizzled ring, `wgmma` from two consumer
// warpgroups) over device memory:
//   1. x.w1 (x by TMA), whose epilogue applies s1, b1, relu and the
//      rounding -> h1;
//   2. the 3x3 conv as one implicit product over k = tap * Cmid + c, whose
//      producer gathers h1 at the tap's source pixel by `cp.async`, or
//      zeros outside the image (per image, so the seam between two images
//      is an edge too), and whose epilogue applies s2, b2, relu and the
//      rounding -> h2;
//   3. h2.w3 and, with a projection, x.wp into a second accumulator of the
//      same tile (both by TMA), then the residual add and the final relu.
// h1 and h2 make a round trip through device memory in bf16: bytes the TPU
// kernel kept on chip (0.015-0.12 ms a block at 3.35 TB/s).
#include <limits.h>

#include "wgmma_gemm.cuh"

namespace {

__device__ __forceinline__ float affine(float v, float s, float b) {
  return __fadd_rn(__fmul_rn(v, s), b);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// h[m, n] = bf16(relu(acc * s[n] + b[n])), row-major [M, ld]
struct EpAffineRelu {
  static constexpr int NV = 0;
  const float* s;
  const float* b;
  bf16* h;
  int ld;
  typedef int64_t Row;  // the row's offset
  typedef NoIn In;
  __device__ __forceinline__ Row row(int m) const {
    return static_cast<int64_t>(m) * ld;
  }
  __device__ __forceinline__ void load(Row, int, In&) const {}
  __device__ __forceinline__ void operator()(int, Row off, int n,
                                             const float* v, const In&,
                                             float*) const {
    float y[8], sv[8], bv[8];
    ldg8(s + n, sv);
    ldg8(b + n, bv);
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = fmaxf(affine(v[e], sv[e], bv[e]), 0.f);
    *reinterpret_cast<uint4*>(h + off + n) = pack8(y);
  }
};

// the 3x3 conv's implicit operand: row m = (n * H + y) * W + x, col = tap *
// C + c; h1 at (y + dy - 1, x + dx - 1) of the same image, zero outside it
struct LdConv3x3 {
  const bf16* h;
  int C, H, W;
  FastDiv dC, dH, dW;
  struct Row {
    const bf16* p;  // h at the row's own pixel
    int y, x;
  };
  __device__ __forceinline__ const bf16* base() const { return h; }
  __device__ __forceinline__ Row row(int m) const {
    const int r = dW.div(m);
    return Row{h + static_cast<int64_t>(m) * C, r - dH.div(r) * H,
               m - r * W};
  }
  __device__ __forceinline__ const bf16* src(const Row& r, int col,
                                             bool& ok) const {
    const int tap = dC.div(col), c = col - tap * C;
    const int dy = tap / 3, dx = tap - 3 * dy;
    const int ys = r.y + dy - 1, xs = r.x + dx - 1;
    ok = ys >= 0 && ys < H && xs >= 0 && xs < W;
    return r.p + static_cast<int64_t>((dy - 1) * W + dx - 1) * C + c;
  }
};

// out = relu(bf16(bf16(a3 * s3 + b3) + res)) from the tile's accumulators:
// res = bf16(ap * sp + bp) from the second accumulator with PROJ, else x
template <bool PROJ>
struct EpBlockOut {
  static constexpr int NV = 0;
  const bf16* x;
  const float *s3, *b3, *sp, *bp;
  bf16* out;
  int Cin, Cout;
  typedef int64_t Row;  // the row
  struct In {
    uint4 x;  // 8 bf16 of x without a projection
  };
  __device__ __forceinline__ Row row(int m) const { return m; }
  __device__ __forceinline__ void load(Row m, int n, In& in) const {
    if (!PROJ) in.x = __ldg(reinterpret_cast<const uint4*>(x + m * Cin + n));
  }
  __device__ __forceinline__ void write(Row m, int n, const float* v3,
                                        const float* r) const {
    float o[8], sv[8], bv[8];
    ldg8(s3 + n, sv);
    ldg8(b3 + n, bv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float h3 = round_bf16(affine(v3[e], sv[e], bv[e]));
      o[e] = fmaxf(round_bf16(__fadd_rn(h3, r[e])), 0.f);
    }
    *reinterpret_cast<uint4*>(out + m * Cout + n) = pack8(o);
  }
  // with a projection: two accumulators
  __device__ __forceinline__ void operator()(Row m, int n, const float* v3,
                                             const float* vp, const In&,
                                             float*) const {
    float r[8], sv[8], bv[8];
    ldg8(sp + n, sv);
    ldg8(bp + n, bv);
#pragma unroll
    for (int e = 0; e < 8; ++e) r[e] = round_bf16(affine(vp[e], sv[e], bv[e]));
    write(m, n, v3, r);
  }
  // the identity residual: one accumulator
  __device__ __forceinline__ void operator()(int, Row m, int n,
                                             const float* v3, const In& in,
                                             float*) const {
    float r[8];
    const bf16* e8 = reinterpret_cast<const bf16*>(&in.x);
#pragma unroll
    for (int e = 0; e < 8; ++e) r[e] = __bfloat162float(e8[e]);
    write(m, n, v3, r);
  }
};

}  // namespace

// Every field is 8 bytes, in this order, as ops/fused_block.py's ctypes
// Structure declares them. wp, sp and bp may be 0 without a projection.
struct KftpuBlockEvalArgs {
  int64_t N, H, W, Cin, Cmid, Cout, proj;
  const void *x, *w1, *w2, *w3, *wp;  // bf16 [Cin,Cmid] [9Cmid,Cmid] ...
  const float *s1, *b1, *s2, *b2, *s3, *b3, *sp, *bp;
  void *h1, *h2;                      // bf16 [N*H*W, Cmid] scratch each
  void* out;                          // bf16 [N, H, W, Cout]
};

#define KFTPU_TRY(expr)                    \
  do {                                     \
    const cudaError_t err_ = (expr);       \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

// The block's three launches on `stream`. Returns a cudaError_t.
extern "C" int kftpu_block_eval(const KftpuBlockEvalArgs* a, void* stream) {
  if (a->N <= 0 || a->H <= 0 || a->W <= 0 || a->Cin % 8 || a->Cmid % 8 ||
      a->Cout % 8 || a->Cin <= 0 || a->Cmid <= 0 || a->Cout <= 0 ||
      (!a->proj && a->Cin != a->Cout) || a->N * a->H * a->W > INT_MAX ||
      9 * a->Cmid > INT_MAX)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = static_cast<int>(a->N * a->H * a->W);
  const int H = static_cast<int>(a->H), W = static_cast<int>(a->W);
  const int Cin = static_cast<int>(a->Cin), Cmid = static_cast<int>(a->Cmid),
            Cout = static_cast<int>(a->Cout);
  const bf16* x = static_cast<const bf16*>(a->x);
  bf16* h1 = static_cast<bf16*>(a->h1);
  bf16* h2 = static_cast<bf16*>(a->h2);

  const bf16* w1 = static_cast<const bf16*>(a->w1);
  const bf16* w2 = static_cast<const bf16*>(a->w2);
  const bf16* w3 = static_cast<const bf16*>(a->w3);
  const bf16* wp = static_cast<const bf16*>(a->wp);
  KFTPU_TRY(wg_gemm(Plain{x, M, Cin, Cin}, Plain{w1, Cin, Cmid, Cmid},
                    EpAffineRelu{a->s1, a->b1, h1, Cmid}, M, Cmid, Cin, st));
  KFTPU_TRY(wg_gemm_gather(
      LdConv3x3{h1, Cmid, H, W, fast_div(Cmid), fast_div(H), fast_div(W)},
      Plain{w2, 9 * Cmid, Cmid, Cmid}, EpAffineRelu{a->s2, a->b2, h2, Cmid},
      M, Cmid, 9 * Cmid, st));
  bf16* out = static_cast<bf16*>(a->out);
  const Plain h2m{h2, M, Cmid, Cmid}, w3m{w3, Cmid, Cout, Cout};
  if (a->proj)
    return wg_gemm2(h2m, w3m, Plain{x, M, Cin, Cin},
                    Plain{wp, Cin, Cout, Cout},
                    EpBlockOut<true>{x, a->s3, a->b3, a->sp, a->bp, out, Cin,
                                     Cout},
                    M, Cout, Cmid, Cin, st);
  return wg_gemm(h2m, w3m,
                 EpBlockOut<false>{x, a->s3, a->b3, nullptr, nullptr, out,
                                   Cin, Cout},
                 M, Cout, Cmid, st);
}

extern "C" const char* kftpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
