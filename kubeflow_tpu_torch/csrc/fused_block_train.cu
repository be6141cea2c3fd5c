// Fused ghost-BN ResNet bottleneck, training forward and backward, for
// Hopper (sm_90a), behind a plain C interface that
// kubeflow_tpu_torch/ops/fused_block_train.py binds with ctypes.
//
// Replaces two TPU kernel pairs with one implementation:
// - K4: kubeflow_tpu/ops/fused_block_train.py `_fwd_kernel` / `_bwd_kernel`
//   (launched by `_pallas_fwd` / `_pallas_bwd`), the batch-tiled block;
// - K5: kubeflow_tpu/ops/fused_block_train_spatial.py `_fwd_kernel` /
//   `_bwd_kernel`, the same block ghost-tiled as (batch tile x row strip)
//   with a 1-row halo.
// K4 is the single-strip case of K5 (tile_h = H, no halo rows), so one
// set of launches serves both; each Python wrapper keeps its own count.
//
// The function, per stride-1 bottleneck (x [N, H, W, Cin] bf16 NHWC; conv
// weights bf16, BN scale and bias f32):
//   a1 = x.w1 (f32) -> ghost-BN -> relu -> h1 (bf16)
//   acc2 = sum of 9 shifted h1.w2[dy, dx] (f32) -> ghost-BN -> relu -> h2
//   a3 = h2.w3 (f32) -> ghost-BN -> y3;  r = ghost-BN(x.wp) or x
//   out = bf16(relu(y3 + r))
// Ghost statistics: per (batch tile of `bt` images) x (strip of `th` rows),
// over the strip's interior samples, m = E[a], v = E[a^2] - m^2 in f32 (no
// clamp), normalised as g * ((a - m) * rsqrt(v + eps)) + b. A strip's 3x3
// conv reads one halo row above and below from the neighbouring strips,
// normalised with the strip's own statistics; rows outside the image are
// zero (SAME padding). The running-stat outputs are the ghost-averaged m
// and v. The backward recomputes the interior from x and returns dx, every
// weight, scale and bias gradient; `da1`, `da2`, `da3` and `dap` are
// rounded to bf16 before their products; halo rows add to BN1's dgamma,
// dbeta and correction sums, whose divisor is the interior count and whose
// correction applies to interior rows only; dx of halo rows comes back as
// thin seam-row arrays that are added into the bf16 dx in bf16, top seams
// first, as the TPU wrapper's `.at[].add` does.
//
// What bounds it on the H100: at ResNet-50's stride-1 geometries (224 px,
// batch 64) one block's forward is 28-30 GFLOP against 26-206 MB of x and
// out, so the memory rate bounds the 56x56 and 28x28 blocks and the
// tensor cores the 14x14 and 7x7 ones; the backward (three times the
// products) is bound by the tensor cores but for one geometry
// (chip_smoke.py prints each bound). A ghost tile of 196-896 rows x
// 256-2048 channels does not fit the 227 KB of shared memory of one SM, and
// BN needs a tile's statistics before anything downstream can run, so the
// TPU kernel's single VMEM-resident pass becomes a short sequence of
// launches over device memory:
//   forward: 1x1 product (x.w1, and x.wp) -> per-ghost partial sums ->
//   fixed-order reduce to m, rsqrt -> 3x3 implicit product whose operand
//   loader applies BN1, relu, the bf16 rounding and the edge mask -> sums ->
//   1x1 product whose loader applies BN2 -> sums -> output epilogue;
//   backward: the same recompute, then per-ghost sums of dy and dy*xhat,
//   da, dgrad products and wgrad products reduced over samples.
// Every product is hand-written: bf16 `mma.sync.m16n8k16` with f32
// accumulators (bf16_gemm.cuh, shared with fused_block.cu), operands staged
// through shared memory by loaders that fuse the BN / relu / mask / halo
// logic. Every reduction is fixed-order
// (per-block partials, then one ordered reduce): no float atomics, so the
// results do not change from run to run. Interiors (a1, acc2, a3 in f32)
// live in device memory, bytes the TPU kernel kept in VMEM: speed is later
// work, this version is the simple correct one.
#include <math.h>

#include "bf16_gemm.cuh"

namespace {

// ---------------------------------------------------------------------------
// geometry of the ghost tiling
// ---------------------------------------------------------------------------

struct Geo {
  int N, H, W, bt, th, hal, S, th2;  // th2 = th + 2 * hal haloed rows

  // ghost of the global sample row m = (n * H + y) * W + x
  __device__ __forceinline__ int ghost_of(int64_t m) const {
    int64_t r = m / W;
    const int y = static_cast<int>(r % H);
    const int n = static_cast<int>(r / H);
    return (n / bt) * S + y / th;
  }
  // i-th interior sample of ghost gh, as a global row
  __device__ __forceinline__ int64_t interior_row(int gh, int i) const {
    const int t = gh / S, s = gh % S, per = th * W;
    const int n = t * bt + i / per, rem = i % per;
    return (static_cast<int64_t>(n) * H + s * th) * W + rem;
  }
  // haloed row q = ((n * S + s) * th2 + j) * W + x -> n, s, j, x
  __device__ __forceinline__ void split_haloed(int64_t q, int& n, int& s,
                                               int& j, int& x) const {
    x = static_cast<int>(q % W);
    int64_t r = q / W;
    j = static_cast<int>(r % th2);
    r /= th2;
    s = static_cast<int>(r % S);
    n = static_cast<int>(r / S);
  }
  // i-th haloed sample of ghost gh, as a haloed row
  __device__ __forceinline__ int64_t haloed_row(int gh, int i) const {
    const int t = gh / S, s = gh % S, per = th2 * W;
    const int n = t * bt + i / per, rem = i % per;
    return (static_cast<int64_t>(n) * S + s) * th2 * W + rem;
  }
};

__device__ __forceinline__ float bn(float a, float m, float rs, float g,
                                    float b) {
  // g * ((a - m) * rs) + b, each operation rounded on its own
  return __fadd_rn(__fmul_rn(g, __fmul_rn(__fsub_rn(a, m), rs)), b);
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 o;
  o.x = pack2(v[0], v[1]);
  o.y = pack2(v[2], v[3]);
  o.z = pack2(v[4], v[5]);
  o.w = pack2(v[6], v[7]);
  return o;
}

__device__ __forceinline__ void load8f(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// ---------------------------------------------------------------------------
// operand loaders: load8(row, col) gives 8 bf16 of a logical matrix whose
// `col` index is contiguous in memory (col % 8 == 0)
// ---------------------------------------------------------------------------

// bf16(relu(BN(a))) of an f32 [M, C] interior with per-ghost statistics
struct LdBnRelu {
  const float* a;
  const float* mean;
  const float* rs;
  const float* g;
  const float* b;
  int C;
  Geo geo;
  __device__ __forceinline__ void load8(int64_t row, int col, uint4& o) const {
    const int gh = geo.ghost_of(row);
    float v[8];
    load8f(a + row * C + col, v);
    const float* mm = mean + static_cast<int64_t>(gh) * C + col;
    const float* ss = rs + static_cast<int64_t>(gh) * C + col;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = fmaxf(bn(v[i], mm[i], ss[i], g[col + i], b[col + i]), 0.f);
    o = pack8(v);
  }
};

// the 3x3 conv's implicit operand: row m (output sample), col = tap * C + c;
// h1 at the tap's source pixel, normalised with the OUTPUT row's ghost
// statistics, zero outside the image
struct LdConvFwd {
  const float* a1;
  const float* mean;
  const float* rs;
  const float* g;
  const float* b;
  int C;
  Geo geo;
  __device__ __forceinline__ void load8(int64_t m, int col, uint4& o) const {
    const int tap = col / C, c = col - tap * C;
    const int dy = tap / 3, dx = tap - 3 * dy;
    const int x = static_cast<int>(m % geo.W);
    const int64_t r = m / geo.W;
    const int y = static_cast<int>(r % geo.H);
    const int n = static_cast<int>(r / geo.H);
    const int ys = y + dy - 1, xs = x + dx - 1;
    if (ys < 0 || ys >= geo.H || xs < 0 || xs >= geo.W) {
      o = make_uint4(0, 0, 0, 0);
      return;
    }
    const int gh = (n / geo.bt) * geo.S + y / geo.th;
    float v[8];
    load8f(a1 + ((static_cast<int64_t>(n) * geo.H + ys) * geo.W + xs) * C + c,
           v);
    const float* mm = mean + static_cast<int64_t>(gh) * C + c;
    const float* ss = rs + static_cast<int64_t>(gh) * C + c;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = fmaxf(bn(v[i], mm[i], ss[i], g[c + i], b[c + i]), 0.f);
    o = pack8(v);
  }
};

// the 3x3 conv's transpose: row q (haloed sample of strip s), col = tap * C
// + j; da2 at the output sample that read q through this tap, if that
// sample lies in strip s and inside the image columns, else zero
struct LdConvBwd {
  const bf16* da2;
  int C;
  Geo geo;
  __device__ __forceinline__ void load8(int64_t q, int col, uint4& o) const {
    const int tap = col / C, j = col - tap * C;
    const int dy = tap / 3, dx = tap - 3 * dy;
    int n, s, jr, x;
    geo.split_haloed(q, n, s, jr, x);
    const int yo = s * geo.th - geo.hal + jr - dy + 1;
    const int xo = x - dx + 1;
    if (yo < s * geo.th || yo >= (s + 1) * geo.th || xo < 0 || xo >= geo.W) {
      o = make_uint4(0, 0, 0, 0);
      return;
    }
    o = *reinterpret_cast<const uint4*>(
        da2 + ((static_cast<int64_t>(n) * geo.H + yo) * geo.W + xo) * C + j);
  }
};

// x at a haloed row (rows outside the image clamp to the edge: their da1
// is zero, so the value does not matter)
struct LdXHaloed {
  const bf16* x;
  int C;
  Geo geo;
  __device__ __forceinline__ void load8(int64_t q, int col, uint4& o) const {
    int n, s, jr, xw;
    geo.split_haloed(q, n, s, jr, xw);
    int y = s * geo.th - geo.hal + jr;
    y = y < 0 ? 0 : (y >= geo.H ? geo.H - 1 : y);
    o = *reinterpret_cast<const uint4*>(
        x + ((static_cast<int64_t>(n) * geo.H + y) * geo.W + xw) * C + col);
  }
};

// w2 [9, Ci, Co] read as B(k = tap * Co + j, n = i) = w2[tap][i][j]
struct LdW2T {
  const bf16* w;
  int C;
  __device__ __forceinline__ void load8(int64_t i, int col, uint4& o) const {
    const int tap = col / C, j = col - tap * C;
    o = *reinterpret_cast<const uint4*>(
        w + (static_cast<int64_t>(tap) * C + i) * C + j);
  }
};

// ---------------------------------------------------------------------------
// epilogues: (split, row, col, v[col], v[col + 1])
// ---------------------------------------------------------------------------

struct EpF32 {
  float* p;
  int ld;
  __device__ __forceinline__ void operator()(int, int64_t m, int n, float v0,
                                             float v1) const {
    *reinterpret_cast<float2*>(p + m * ld + n) = make_float2(v0, v1);
  }
};

struct EpPartial {  // split-K partials [splits, M, N]
  float* p;
  int64_t M;
  int N;
  __device__ __forceinline__ void operator()(int z, int64_t m, int n,
                                             float v0, float v1) const {
    *reinterpret_cast<float2*>(p + (z * M + m) * N + n) = make_float2(v0, v1);
  }
};

// dx of a haloed row: interior rows add the residual gradient (f32) and go
// to dx; halo rows go to the seam arrays [N, S, W, C]; all rounded to bf16
struct EpDx {
  const float* dres;
  bf16* dx;
  bf16* dxt;
  bf16* dxb;
  int C;
  Geo geo;
  __device__ __forceinline__ void operator()(int, int64_t q, int c, float v0,
                                             float v1) const {
    int n, s, jr, x;
    geo.split_haloed(q, n, s, jr, x);
    if (jr >= geo.hal && jr < geo.th + geo.hal) {
      const int y = s * geo.th - geo.hal + jr;
      const int64_t off =
          ((static_cast<int64_t>(n) * geo.H + y) * geo.W + x) * C + c;
      const float2 r = *reinterpret_cast<const float2*>(dres + off);
      *reinterpret_cast<uint32_t*>(dx + off) =
          pack2(__fadd_rn(v0, r.x), __fadd_rn(v1, r.y));
      return;
    }
    bf16* seam = jr == 0 ? dxt : dxb;
    const int64_t off =
        ((static_cast<int64_t>(n) * geo.S + s) * geo.W + x) * C + c;
    *reinterpret_cast<uint32_t*>(seam + off) = pack2(v0, v1);
  }
};

// out[i] = sum over z of part[z][i], in z order
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     int splits, int64_t n,
                                     float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * n + i];
  out[i] = s;
}

// ---------------------------------------------------------------------------
// per-ghost reductions: out[v][gh][c] = sum over the ghost's rows of the
// functor's NV values; 8 row groups x 32 channels a block, then an ordered
// sum of the 8 partials
// ---------------------------------------------------------------------------

constexpr int RED_ROWS = 8;

template <int NV, class F>
__global__ void __launch_bounds__(RED_ROWS * 32)
ghost_sums_kernel(F f, int C, int rows_per_ghost, int G,
                  float* __restrict__ out) {
  __shared__ float red[NV][RED_ROWS][32];
  const int gh = blockIdx.x;
  const int lane = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + lane;
  float acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.f;
  if (c < C)
    for (int i = rg; i < rows_per_ghost; i += RED_ROWS) f(gh, i, c, acc);
#pragma unroll
  for (int v = 0; v < NV; ++v) red[v][rg][lane] = acc[v];
  __syncthreads();
  if (rg == 0 && c < C) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float s = 0.f;
      for (int r = 0; r < RED_ROWS; ++r) s += red[v][r][lane];
      out[(static_cast<int64_t>(v) * G + gh) * C + c] = s;
    }
  }
}

struct SumsFwd {  // sum a, sum a^2 over the ghost's interior
  const float* a;
  int C;
  Geo geo;
  __device__ __forceinline__ void operator()(int gh, int i, int c,
                                             float* acc) const {
    const float v = a[geo.interior_row(gh, i) * C + c];
    acc[0] += v;
    acc[1] += v * v;
  }
};

// the block output's gradient through the final relu, gz, and the BN3
// (and proj-BN) sums: sum gz, sum gz * xh3 [, sum gz * xhp]
struct OutGrad {
  const float* a3;
  const float* m3;
  const float* rs3;
  const float* g3;
  const float* b3;
  const float* ap;
  const float* mp;
  const float* rsp;
  const float* gp;
  const float* bp;
  const bf16* x;
  const bf16* g;
  int C;
  int proj;
  __device__ __forceinline__ void at(int64_t m, int gh, int c, float& gz,
                                     float& xh3, float& xhp) const {
    const int64_t off = m * C + c, so = static_cast<int64_t>(gh) * C + c;
    xh3 = __fmul_rn(__fsub_rn(a3[off], m3[so]), rs3[so]);
    const float y3 = __fadd_rn(__fmul_rn(g3[c], xh3), b3[c]);
    float r;
    if (proj) {
      xhp = __fmul_rn(__fsub_rn(ap[off], mp[so]), rsp[so]);
      r = __fadd_rn(__fmul_rn(gp[c], xhp), bp[c]);
    } else {
      xhp = 0.f;
      r = __bfloat162float(x[off]);
    }
    gz = __fadd_rn(y3, r) > 0.f ? __bfloat162float(g[off]) : 0.f;
  }
};

struct SumsOut {
  OutGrad o;
  Geo geo;
  __device__ __forceinline__ void operator()(int gh, int i, int c,
                                             float* acc) const {
    float gz, xh3, xhp;
    o.at(geo.interior_row(gh, i), gh, c, gz, xh3, xhp);
    acc[0] += gz;
    acc[1] += gz * xh3;
    acc[2] += gz * xhp;
  }
};

// BN2: dz2 = dh2 where y2 > 0; sums dz2, dz2 * xh2
struct SumsMid {
  const float* acc2;
  const float* dh2;
  const float* m2;
  const float* rs2;
  const float* g2;
  const float* b2;
  int C;
  Geo geo;
  __device__ __forceinline__ void operator()(int gh, int i, int c,
                                             float* acc) const {
    const int64_t off = geo.interior_row(gh, i) * C + c;
    const int64_t so = static_cast<int64_t>(gh) * C + c;
    const float xh = __fmul_rn(__fsub_rn(acc2[off], m2[so]), rs2[so]);
    const float y = __fadd_rn(__fmul_rn(g2[c], xh), b2[c]);
    const float dz = y > 0.f ? dh2[off] : 0.f;
    acc[0] += dz;
    acc[1] += dz * xh;
  }
};

// BN1 over the haloed rows: dz1 = dh1 where y1 > 0 and the row lies in
// the image; sums dz1, dz1 * xh1
struct SumsIn {
  const float* a1;
  const float* dh1;
  const float* m1;
  const float* rs1;
  const float* g1;
  const float* b1;
  int C;
  Geo geo;
  __device__ __forceinline__ void operator()(int gh, int i, int c,
                                             float* acc) const {
    const int64_t q = geo.haloed_row(gh, i);
    int n, s, jr, x;
    geo.split_haloed(q, n, s, jr, x);
    const int y = s * geo.th - geo.hal + jr;
    if (y < 0 || y >= geo.H) return;
    const int64_t m = (static_cast<int64_t>(n) * geo.H + y) * geo.W + x;
    const int64_t so = static_cast<int64_t>(gh) * C + c;
    const float xh = __fmul_rn(__fsub_rn(a1[m * C + c], m1[so]), rs1[so]);
    const float yv = __fadd_rn(__fmul_rn(g1[c], xh), b1[c]);
    const float dz = yv > 0.f ? dh1[q * C + c] : 0.f;
    acc[0] += dz;
    acc[1] += dz * xh;
  }
};

// forward: per-ghost m, rsqrt(v + eps) and the ghost-averaged m and v
__global__ void stats_finalize_kernel(const float* __restrict__ sums, int G,
                                      int C, float count, float eps,
                                      float* __restrict__ mean,
                                      float* __restrict__ rs,
                                      float* __restrict__ avg_m,
                                      float* __restrict__ avg_v) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float inv_g = 1.f / static_cast<float>(G);
  float am = 0.f, av = 0.f;
  for (int g = 0; g < G; ++g) {
    const int64_t o = static_cast<int64_t>(g) * C + c;
    const float m = __fdiv_rn(sums[o], count);
    const float v = __fsub_rn(__fdiv_rn(sums[static_cast<int64_t>(G) * C + o],
                                        count),
                              __fmul_rn(m, m));
    mean[o] = m;
    rs[o] = __frsqrt_rn(__fadd_rn(v, eps));
    am = __fadd_rn(am, __fmul_rn(m, inv_g));
    av = __fadd_rn(av, __fmul_rn(v, inv_g));
  }
  if (avg_m != nullptr) {
    avg_m[c] = am;
    avg_v[c] = av;
  }
}

// backward: per-ghost corrections c1 = g * sum(dy) / n, c2 = g * sum(dy *
// xh) / n; dgamma = sum over ghosts of sum(dy * xh), dbeta of sum(dy)
__global__ void grad_finalize_kernel(const float* __restrict__ s1,
                                     const float* __restrict__ s2, int G,
                                     int C, float count,
                                     const float* __restrict__ gamma,
                                     float* __restrict__ c1,
                                     float* __restrict__ c2,
                                     float* __restrict__ dgamma,
                                     float* __restrict__ dbeta) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float dg = 0.f, db = 0.f;
  for (int g = 0; g < G; ++g) {
    const int64_t o = static_cast<int64_t>(g) * C + c;
    c1[o] = __fdiv_rn(__fmul_rn(gamma[c], s1[o]), count);
    c2[o] = __fdiv_rn(__fmul_rn(gamma[c], s2[o]), count);
    dg = __fadd_rn(dg, s2[o]);
    db = __fadd_rn(db, s1[o]);
  }
  dgamma[c] = dg;
  dbeta[c] = db;
}

// ---------------------------------------------------------------------------
// elementwise passes
// ---------------------------------------------------------------------------

__global__ void out_kernel(OutGrad o, Geo geo, int64_t total,
                           bf16* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % o.C);
  const int64_t m = i / o.C;
  const int gh = geo.ghost_of(m);
  const int64_t so = static_cast<int64_t>(gh) * o.C + c;
  const float y3 = bn(o.a3[i], o.m3[so], o.rs3[so], o.g3[c], o.b3[c]);
  const float r = o.proj ? bn(o.ap[i], o.mp[so], o.rsp[so], o.gp[c], o.bp[c])
                         : __bfloat162float(o.x[i]);
  out[i] = __float2bfloat16_rn(fmaxf(__fadd_rn(y3, r), 0.f));
}

// da = rs * ((dy * g - c1) - xh * c2), the BN backward of the interior BNs
__device__ __forceinline__ float bn_da(float dy, float xh, float rs, float g,
                                       float c1, float c2) {
  return __fmul_rn(rs, __fsub_rn(__fsub_rn(__fmul_rn(dy, g), c1),
                                 __fmul_rn(xh, c2)));
}

// da3 (and dap) in bf16; without proj the residual's gradient gz goes to
// dres in f32
__global__ void out_da_kernel(OutGrad o, Geo geo, int64_t total,
                              const float* __restrict__ c13,
                              const float* __restrict__ c23,
                              const float* __restrict__ c1p,
                              const float* __restrict__ c2p,
                              bf16* __restrict__ da3, bf16* __restrict__ dap,
                              float* __restrict__ dres) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % o.C);
  const int64_t m = i / o.C;
  const int gh = geo.ghost_of(m);
  const int64_t so = static_cast<int64_t>(gh) * o.C + c;
  float gz, xh3, xhp;
  o.at(m, gh, c, gz, xh3, xhp);
  da3[i] = __float2bfloat16_rn(
      bn_da(gz, xh3, o.rs3[so], o.g3[c], c13[so], c23[so]));
  if (o.proj)
    dap[i] = __float2bfloat16_rn(
        bn_da(gz, xhp, o.rsp[so], o.gp[c], c1p[so], c2p[so]));
  else
    dres[i] = gz;
}

__global__ void mid_da_kernel(SumsMid f, int64_t total,
                              const float* __restrict__ c1,
                              const float* __restrict__ c2,
                              bf16* __restrict__ da2) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % f.C);
  const int64_t m = i / f.C;
  const int gh = f.geo.ghost_of(m);
  const int64_t so = static_cast<int64_t>(gh) * f.C + c;
  const float xh = __fmul_rn(__fsub_rn(f.acc2[i], f.m2[so]), f.rs2[so]);
  const float y = __fadd_rn(__fmul_rn(f.g2[c], xh), f.b2[c]);
  const float dz = y > 0.f ? f.dh2[i] : 0.f;
  da2[i] = __float2bfloat16_rn(bn_da(dz, xh, f.rs2[so], f.g2[c], c1[so],
                                     c2[so]));
}

// da1 over the haloed rows: rs * (dxh - (c1 + xh * c2)) on interior rows,
// rs * dxh on halo rows, zero outside the image
__global__ void in_da_kernel(SumsIn f, int64_t total,
                             const float* __restrict__ c1,
                             const float* __restrict__ c2,
                             bf16* __restrict__ da1) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= total) return;
  const Geo& geo = f.geo;
  const int c = static_cast<int>(i % f.C);
  const int64_t q = i / f.C;
  int n, s, jr, x;
  geo.split_haloed(q, n, s, jr, x);
  const int y = s * geo.th - geo.hal + jr;
  if (y < 0 || y >= geo.H) {
    da1[i] = __float2bfloat16_rn(0.f);
    return;
  }
  const int gh = (n / geo.bt) * geo.S + s;
  const int64_t m = (static_cast<int64_t>(n) * geo.H + y) * geo.W + x;
  const int64_t so = static_cast<int64_t>(gh) * f.C + c;
  const float xh = __fmul_rn(__fsub_rn(f.a1[m * f.C + c], f.m1[so]),
                             f.rs1[so]);
  const float yv = __fadd_rn(__fmul_rn(f.g1[c], xh), f.b1[c]);
  const float dxh = __fmul_rn(yv > 0.f ? f.dh1[i] : 0.f, f.g1[c]);
  const bool interior = jr >= geo.hal && jr < geo.th + geo.hal;
  const float d = interior
      ? __fsub_rn(dxh, __fadd_rn(c1[so], __fmul_rn(xh, c2[so])))
      : dxh;
  da1[i] = __float2bfloat16_rn(__fmul_rn(f.rs1[so], d));
}

// dx[n, row, x, c] += seam[n, s, x, c] in bf16 for s in [s_lo, s_hi), row =
// s * th + row_off
__global__ void seam_add_kernel(bf16* __restrict__ dx,
                                const bf16* __restrict__ seam, Geo geo, int C,
                                int s_lo, int s_hi, int row_off) {
  const int64_t per = static_cast<int64_t>(s_hi - s_lo) * geo.W * C;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= per * geo.N) return;
  const int n = static_cast<int>(i / per);
  int64_t r = i % per;
  const int c = static_cast<int>(r % C);
  r /= C;
  const int x = static_cast<int>(r % geo.W);
  const int s = s_lo + static_cast<int>(r / geo.W);
  const int y = s * geo.th + row_off;
  const int64_t o = ((static_cast<int64_t>(n) * geo.H + y) * geo.W + x) * C + c;
  const float v = __bfloat162float(seam[((static_cast<int64_t>(n) * geo.S + s)
                                         * geo.W + x) * C + c]);
  dx[o] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(dx[o]), v));
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// split-K for the wgrad products (K = samples): about 4 blocks an SM
void wgrad_split(int64_t M, int N, int64_t K, int* splits, int64_t* kchunk) {
  const int64_t tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  int64_t want = (528 + tiles - 1) / tiles;
  const int64_t most = (K + 255) / 256;
  if (want > most) want = most;
  if (want < 1) want = 1;
  int64_t chunk = (K + want - 1) / want;
  chunk = (chunk + BK - 1) / BK * BK;
  *kchunk = chunk;
  *splits = static_cast<int>((K + chunk - 1) / chunk);
}

// out [M, N] f32 = sum over samples of A(m, i) B(m, n), through partials
template <class LA, class LB>
cudaError_t wgrad(LA la, LB lb, int64_t M, int N, int64_t K, float* part,
                  float* out, cudaStream_t st) {
  int splits;
  int64_t chunk;
  wgrad_split(M, N, K, &splits, &chunk);
  cudaError_t e = gemm<false, false>(la, lb, EpPartial{part, M, N}, M, N, K,
                                     splits, chunk, st);
  if (e != cudaSuccess) return e;
  const int64_t n = M * N;
  reduce_splits_kernel<<<blocks_for(n, 256), 256, 0, st>>>(part, splits, n,
                                                            out);
  return cudaGetLastError();
}

template <int NV, class F>
cudaError_t ghost_sums(F f, int C, int rows, int G, float* out,
                       cudaStream_t st) {
  const dim3 grid(G, (C + 31) / 32);
  ghost_sums_kernel<NV><<<grid, RED_ROWS * 32, 0, st>>>(f, C, rows, G, out);
  return cudaGetLastError();
}

}  // namespace

// Every field is 8 bytes, in this order, as ops/fused_block_train.py's
// ctypes Structure declares them. Pointers a call does not use may be 0.
struct KftpuBlockArgs {
  int64_t N, H, W, Cin, Cmid, Cout, bt, th, hal, proj;
  double eps;
  const void *x, *g;                       // x; the output's gradient (bwd)
  const void *w1, *w2, *w3, *wp;           // bf16 [Cin,Cmid] [9Cmid,Cmid] ...
  const float *g1, *b1, *g2, *b2, *g3, *b3, *gp, *bp;
  void* out;                               // bf16 [N, H, W, Cout] (fwd)
  float *m1, *v1, *m2, *v2, *m3, *v3, *mp, *vp;  // ghost-averaged (fwd)
  void *dx, *dxt, *dxb;                    // bf16 dx and seam rows (bwd)
  float *dw1, *dg1, *db1, *dw2, *dg2, *db2, *dw3, *dg3, *db3, *dwp, *dgp,
      *dbp;
  void* workspace;
};

namespace {

struct Carve {
  char* base;
  size_t off;
  template <class T>
  T* take(int64_t n) {
    off = (off + 255) / 256 * 256;
    T* p = base != nullptr ? reinterpret_cast<T*>(base + off) : nullptr;
    off += static_cast<size_t>(n) * sizeof(T);
    return p;
  }
};

struct Bufs {  // the forward's interiors and statistics
  float *a1, *ap, *acc2, *a3;
  float *sum1, *mean1, *rs1, *sum2, *mean2, *rs2, *sum3, *mean3, *rs3, *sump,
      *meanp, *rsp;
};

struct BwdBufs {
  float *bsum3, *c13, *c23, *c1p, *c2p, *dres, *dh2, *bsum2, *c12, *c22;
  float *dh1, *bsum1, *c11, *c21, *part;
  bf16 *da3, *dap, *da2, *da1;
};

Geo geo_of(const KftpuBlockArgs& a) {
  Geo g;
  g.N = static_cast<int>(a.N);
  g.H = static_cast<int>(a.H);
  g.W = static_cast<int>(a.W);
  g.bt = static_cast<int>(a.bt);
  g.th = static_cast<int>(a.th);
  g.hal = static_cast<int>(a.hal);
  g.S = static_cast<int>(a.H / a.th);
  g.th2 = g.th + 2 * g.hal;
  return g;
}

Bufs carve_fwd(const KftpuBlockArgs& a, Carve& cv) {
  const Geo geo = geo_of(a);
  const int64_t M = a.N * a.H * a.W, G = (a.N / a.bt) * geo.S;
  Bufs b;
  b.a1 = cv.take<float>(M * a.Cmid);
  b.ap = a.proj ? cv.take<float>(M * a.Cout) : nullptr;
  b.acc2 = cv.take<float>(M * a.Cmid);
  b.a3 = cv.take<float>(M * a.Cout);
  b.sum1 = cv.take<float>(2 * G * a.Cmid);
  b.mean1 = cv.take<float>(G * a.Cmid);
  b.rs1 = cv.take<float>(G * a.Cmid);
  b.sum2 = cv.take<float>(2 * G * a.Cmid);
  b.mean2 = cv.take<float>(G * a.Cmid);
  b.rs2 = cv.take<float>(G * a.Cmid);
  b.sum3 = cv.take<float>(2 * G * a.Cout);
  b.mean3 = cv.take<float>(G * a.Cout);
  b.rs3 = cv.take<float>(G * a.Cout);
  b.sump = cv.take<float>(2 * G * a.Cout);
  b.meanp = cv.take<float>(G * a.Cout);
  b.rsp = cv.take<float>(G * a.Cout);
  return b;
}

int64_t wgrad_floats(int64_t M, int N, int64_t K) {
  int splits;
  int64_t chunk;
  wgrad_split(M, N, K, &splits, &chunk);
  return splits * M * N;
}

BwdBufs carve_bwd(const KftpuBlockArgs& a, Carve& cv) {
  const Geo geo = geo_of(a);
  const int64_t M = a.N * a.H * a.W, G = (a.N / a.bt) * geo.S;
  const int64_t Mh = a.N * geo.S * geo.th2 * a.W;
  BwdBufs b;
  b.bsum3 = cv.take<float>(3 * G * a.Cout);
  b.c13 = cv.take<float>(G * a.Cout);
  b.c23 = cv.take<float>(G * a.Cout);
  b.c1p = cv.take<float>(G * a.Cout);
  b.c2p = cv.take<float>(G * a.Cout);
  b.da3 = cv.take<bf16>(M * a.Cout);
  b.dap = a.proj ? cv.take<bf16>(M * a.Cout) : nullptr;
  b.dres = cv.take<float>(M * a.Cin);
  b.dh2 = cv.take<float>(M * a.Cmid);
  b.bsum2 = cv.take<float>(2 * G * a.Cmid);
  b.c12 = cv.take<float>(G * a.Cmid);
  b.c22 = cv.take<float>(G * a.Cmid);
  b.da2 = cv.take<bf16>(M * a.Cmid);
  b.dh1 = cv.take<float>(Mh * a.Cmid);
  b.bsum1 = cv.take<float>(2 * G * a.Cmid);
  b.c11 = cv.take<float>(G * a.Cmid);
  b.c21 = cv.take<float>(G * a.Cmid);
  b.da1 = cv.take<bf16>(Mh * a.Cmid);
  int64_t part = wgrad_floats(a.Cmid, static_cast<int>(a.Cout), M);  // dw3
  int64_t p2 = wgrad_floats(9 * a.Cmid, static_cast<int>(a.Cmid), M);  // dw2
  int64_t p1 = wgrad_floats(a.Cin, static_cast<int>(a.Cmid), Mh);  // dw1
  int64_t pp = a.proj ? wgrad_floats(a.Cin, static_cast<int>(a.Cout), M) : 0;
  if (p2 > part) part = p2;
  if (p1 > part) part = p1;
  if (pp > part) part = pp;
  b.part = cv.take<float>(part);
  return b;
}

#define KFTPU_TRY(expr)                    \
  do {                                     \
    const cudaError_t err_ = (expr);       \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

// the forward: interiors and per-ghost statistics into `b`; the output and
// the averaged statistics when `final_out`
cudaError_t run_forward(const KftpuBlockArgs& a, const Bufs& b,
                        bool final_out, cudaStream_t st) {
  const Geo geo = geo_of(a);
  const int64_t M = a.N * a.H * a.W;
  const int G = static_cast<int>((a.N / a.bt) * geo.S);
  const int Cin = static_cast<int>(a.Cin), Cmid = static_cast<int>(a.Cmid),
            Cout = static_cast<int>(a.Cout);
  const int rows = static_cast<int>(a.bt * a.th * a.W);
  const float count = static_cast<float>(rows), eps = static_cast<float>(a.eps);
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w1 = static_cast<const bf16*>(a.w1);
  const bf16* w2 = static_cast<const bf16*>(a.w2);
  const bf16* w3 = static_cast<const bf16*>(a.w3);
  const bf16* wp = static_cast<const bf16*>(a.wp);
  auto fin = [&](const float* sums, int C, float* mean, float* rs,
                 float* am, float* av) {
    stats_finalize_kernel<<<blocks_for(C, 128), 128, 0, st>>>(
        sums, G, C, count, eps, mean, rs, final_out ? am : nullptr,
        final_out ? av : nullptr);
    return cudaGetLastError();
  };

  // conv1 (and proj) 1x1, BN1 statistics
  KFTPU_TRY((gemm_full<true, false>(LdBf16{x, Cin}, LdBf16{w1, Cmid},
                                    EpF32{b.a1, Cmid}, M, Cmid, Cin, st)));
  KFTPU_TRY((ghost_sums<2>(SumsFwd{b.a1, Cmid, geo}, Cmid, rows, G, b.sum1,
                           st)));
  KFTPU_TRY(fin(b.sum1, Cmid, b.mean1, b.rs1, a.m1, a.v1));
  if (a.proj) {
    KFTPU_TRY((gemm_full<true, false>(LdBf16{x, Cin}, LdBf16{wp, Cout},
                                      EpF32{b.ap, Cout}, M, Cout, Cin, st)));
    KFTPU_TRY((ghost_sums<2>(SumsFwd{b.ap, Cout, geo}, Cout, rows, G, b.sump,
                             st)));
    KFTPU_TRY(fin(b.sump, Cout, b.meanp, b.rsp, a.mp, a.vp));
  }
  // conv2 3x3 over BN1(a1), BN2 statistics
  KFTPU_TRY((gemm_full<true, false>(
      LdConvFwd{b.a1, b.mean1, b.rs1, a.g1, a.b1, Cmid, geo},
      LdBf16{w2, Cmid}, EpF32{b.acc2, Cmid}, M, Cmid, 9 * Cmid, st)));
  KFTPU_TRY((ghost_sums<2>(SumsFwd{b.acc2, Cmid, geo}, Cmid, rows, G, b.sum2,
                           st)));
  KFTPU_TRY(fin(b.sum2, Cmid, b.mean2, b.rs2, a.m2, a.v2));
  // conv3 1x1 over BN2(acc2), BN3 statistics
  KFTPU_TRY((gemm_full<true, false>(
      LdBnRelu{b.acc2, b.mean2, b.rs2, a.g2, a.b2, Cmid, geo},
      LdBf16{w3, Cout}, EpF32{b.a3, Cout}, M, Cout, Cmid, st)));
  KFTPU_TRY((ghost_sums<2>(SumsFwd{b.a3, Cout, geo}, Cout, rows, G, b.sum3,
                           st)));
  KFTPU_TRY(fin(b.sum3, Cout, b.mean3, b.rs3, a.m3, a.v3));
  if (final_out) {
    const OutGrad o{b.a3, b.mean3, b.rs3, a.g3, a.b3, b.ap, b.meanp, b.rsp,
                    a.gp, a.bp, x, nullptr, Cout, static_cast<int>(a.proj)};
    const int64_t total = M * Cout;
    out_kernel<<<blocks_for(total, 256), 256, 0, st>>>(
        o, geo, total, static_cast<bf16*>(a.out));
    KFTPU_TRY(cudaGetLastError());
  }
  return cudaSuccess;
}

bool args_ok(const KftpuBlockArgs& a) {
  if (a.N <= 0 || a.H <= 0 || a.W <= 0 || a.bt <= 0 || a.th <= 0) return false;
  if (a.N % a.bt || a.H % a.th) return false;
  if (a.Cin % 8 || a.Cmid % 8 || a.Cout % 8) return false;
  if (a.hal != 0 && a.hal != 1) return false;
  if (!a.proj && a.Cin != a.Cout) return false;
  return true;
}

}  // namespace

// Bytes of scratch the forward (backward = 0) or the backward (1) needs.
extern "C" int64_t kftpu_block_train_workspace(const KftpuBlockArgs* a,
                                               int backward) {
  Carve cv{nullptr, 0};
  carve_fwd(*a, cv);
  if (backward) carve_bwd(*a, cv);
  return static_cast<int64_t>(cv.off) + 256;
}

// out and the 8 ghost-averaged statistics. Returns a cudaError_t.
extern "C" int kftpu_block_train_fwd(const KftpuBlockArgs* a, void* stream) {
  if (!args_ok(*a)) return cudaErrorInvalidValue;
  Carve cv{static_cast<char*>(a->workspace), 0};
  const Bufs b = carve_fwd(*a, cv);
  return run_forward(*a, b, true, static_cast<cudaStream_t>(stream));
}

// dx (with the seam rows added) and the 9 or 12 weight gradients, from x,
// the output's gradient g and the weights (the interior is recomputed).
extern "C" int kftpu_block_train_bwd(const KftpuBlockArgs* a, void* stream) {
  if (!args_ok(*a)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Carve cv{static_cast<char*>(a->workspace), 0};
  const Bufs b = carve_fwd(*a, cv);
  const BwdBufs d = carve_bwd(*a, cv);
  KFTPU_TRY(run_forward(*a, b, false, st));

  const Geo geo = geo_of(*a);
  const int64_t M = a->N * a->H * a->W;
  const int64_t Mh = a->N * geo.S * geo.th2 * a->W;
  const int G = static_cast<int>((a->N / a->bt) * geo.S);
  const int Cin = static_cast<int>(a->Cin), Cmid = static_cast<int>(a->Cmid),
            Cout = static_cast<int>(a->Cout);
  const int rows = static_cast<int>(a->bt * a->th * a->W);
  const int hrows = static_cast<int>(a->bt * geo.th2 * a->W);
  const float count = static_cast<float>(rows);
  const bf16* x = static_cast<const bf16*>(a->x);
  const bf16* w1 = static_cast<const bf16*>(a->w1);
  const bf16* w2 = static_cast<const bf16*>(a->w2);
  const bf16* w3 = static_cast<const bf16*>(a->w3);
  const bf16* wp = static_cast<const bf16*>(a->wp);
  const int gfin = blocks_for(Cout, 128), mfin = blocks_for(Cmid, 128);

  // final relu, BN3 (and proj BN): sums, corrections, da3 / dap / dres
  const OutGrad o{b.a3, b.mean3, b.rs3, a->g3, a->b3, b.ap, b.meanp, b.rsp,
                  a->gp, a->bp, x, static_cast<const bf16*>(a->g), Cout,
                  static_cast<int>(a->proj)};
  KFTPU_TRY((ghost_sums<3>(SumsOut{o, geo}, Cout, rows, G, d.bsum3, st)));
  const int64_t gc = static_cast<int64_t>(G) * Cout;
  grad_finalize_kernel<<<gfin, 128, 0, st>>>(d.bsum3, d.bsum3 + gc, G, Cout,
                                              count, a->g3, d.c13, d.c23,
                                              a->dg3, a->db3);
  KFTPU_TRY(cudaGetLastError());
  if (a->proj) {
    grad_finalize_kernel<<<gfin, 128, 0, st>>>(d.bsum3, d.bsum3 + 2 * gc, G,
                                                Cout, count, a->gp, d.c1p,
                                                d.c2p, a->dgp, a->dbp);
    KFTPU_TRY(cudaGetLastError());
  }
  const int64_t tout = M * Cout;
  out_da_kernel<<<blocks_for(tout, 256), 256, 0, st>>>(
      o, geo, tout, d.c13, d.c23, d.c1p, d.c2p, d.da3, d.dap, d.dres);
  KFTPU_TRY(cudaGetLastError());

  // conv3: dw3 = h2^T da3, dh2 = da3 w3^T
  KFTPU_TRY(wgrad(LdBnRelu{b.acc2, b.mean2, b.rs2, a->g2, a->b2, Cmid, geo},
                  LdBf16{d.da3, Cout}, Cmid, Cout, M, d.part, a->dw3, st));
  KFTPU_TRY((gemm_full<true, true>(LdBf16{d.da3, Cout}, LdBf16{w3, Cout},
                                   EpF32{d.dh2, Cmid}, M, Cmid, Cout, st)));

  // relu2, BN2: sums, corrections, da2
  const SumsMid sm{b.acc2, d.dh2, b.mean2, b.rs2, a->g2, a->b2, Cmid, geo};
  KFTPU_TRY((ghost_sums<2>(sm, Cmid, rows, G, d.bsum2, st)));
  const int64_t gm = static_cast<int64_t>(G) * Cmid;
  grad_finalize_kernel<<<mfin, 128, 0, st>>>(d.bsum2, d.bsum2 + gm, G, Cmid,
                                              count, a->g2, d.c12, d.c22,
                                              a->dg2, a->db2);
  KFTPU_TRY(cudaGetLastError());
  const int64_t tmid = M * Cmid;
  mid_da_kernel<<<blocks_for(tmid, 256), 256, 0, st>>>(sm, tmid, d.c12, d.c22,
                                                        d.da2);
  KFTPU_TRY(cudaGetLastError());

  // conv2: dw2 = h1_tap^T da2 per tap, dh1 (haloed) = the transposed conv
  KFTPU_TRY(wgrad(LdConvFwd{b.a1, b.mean1, b.rs1, a->g1, a->b1, Cmid, geo},
                  LdBf16{d.da2, Cmid}, 9 * Cmid, Cmid, M, d.part, a->dw2,
                  st));
  KFTPU_TRY((gemm_full<true, true>(LdConvBwd{d.da2, Cmid, geo},
                                   LdW2T{w2, Cmid}, EpF32{d.dh1, Cmid}, Mh,
                                   Cmid, 9 * Cmid, st)));

  // relu1, BN1 over the haloed rows: sums, corrections, da1
  const SumsIn si{b.a1, d.dh1, b.mean1, b.rs1, a->g1, a->b1, Cmid, geo};
  KFTPU_TRY((ghost_sums<2>(si, Cmid, hrows, G, d.bsum1, st)));
  grad_finalize_kernel<<<mfin, 128, 0, st>>>(d.bsum1, d.bsum1 + gm, G, Cmid,
                                              count, a->g1, d.c11, d.c21,
                                              a->dg1, a->db1);
  KFTPU_TRY(cudaGetLastError());
  const int64_t tin = Mh * Cmid;
  in_da_kernel<<<blocks_for(tin, 256), 256, 0, st>>>(si, tin, d.c11, d.c21,
                                                      d.da1);
  KFTPU_TRY(cudaGetLastError());

  // conv1: dw1 = x_haloed^T da1; proj: dwp = x^T dap, dres = dap wp^T
  KFTPU_TRY(wgrad(LdXHaloed{x, Cin, geo}, LdBf16{d.da1, Cmid}, Cin, Cmid, Mh,
                  d.part, a->dw1, st));
  if (a->proj) {
    KFTPU_TRY(wgrad(LdBf16{x, Cin}, LdBf16{d.dap, Cout}, Cin, Cout, M,
                    d.part, a->dwp, st));
    KFTPU_TRY((gemm_full<true, true>(LdBf16{d.dap, Cout}, LdBf16{wp, Cout},
                                     EpF32{d.dres, Cin}, M, Cin, Cout, st)));
  }
  // dx = da1 w1^T (+ the residual's gradient on interior rows), seam rows
  // to the thin arrays, then added into dx: top halos, then bottom halos
  bf16* dx = static_cast<bf16*>(a->dx);
  bf16* dxt = static_cast<bf16*>(a->dxt);
  bf16* dxb = static_cast<bf16*>(a->dxb);
  KFTPU_TRY((gemm_full<true, true>(LdBf16{d.da1, Cmid}, LdBf16{w1, Cmid},
                                   EpDx{d.dres, dx, dxt, dxb, Cin, geo}, Mh,
                                   Cin, Cmid, st)));
  if (geo.S > 1) {
    const int64_t seam = a->N * (geo.S - 1) * a->W * Cin;
    // strip s's top halo is row s * th - 1 (s >= 1)
    seam_add_kernel<<<blocks_for(seam, 256), 256, 0, st>>>(dx, dxt, geo, Cin,
                                                           1, geo.S, -1);
    KFTPU_TRY(cudaGetLastError());
    // strip s's bottom halo is row (s + 1) * th (s <= S - 2)
    seam_add_kernel<<<blocks_for(seam, 256), 256, 0, st>>>(
        dx, dxb, geo, Cin, 0, geo.S - 1, geo.th);
    KFTPU_TRY(cudaGetLastError());
  }
  return cudaSuccess;
}

extern "C" const char* kftpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
