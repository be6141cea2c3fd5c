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
// and v. The backward takes the forward's per-ghost m and rsqrt(v + eps)
// (or recomputes them with the forward's own launches, bit for bit the
// same), recomputes the interiors from x and returns dx, every weight,
// scale and bias gradient; `da1`, `da2`, `da3` and `dap` are rounded to
// bf16 before their products; halo rows add to BN1's dgamma, dbeta and
// correction sums, whose divisor is the interior count and whose
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
// launches over device memory, whose operands are plain or gathered bf16
// rows:
//   forward, on the warpgroup product of wgmma_gemm.cuh (TMA for plain
//   rows and weights, `cp.async` for gathered rows, a 4-stage swizzled
//   ring, `wgmma`): x.w1 over the haloed rows, its epilogue writing a1 and
//   the per-(tile, ghost segment) sums of a and a^2 over interior rows ->
//   ordered reduce -> m, rsqrt -> one pass writes the haloed bf16 h1 (each
//   strip's rows normalised with its statistics, zero outside the image) ->
//   the 3x3 conv as one implicit product that gathers h1 per tap (zero past
//   the image columns) -> sums -> h2. conv3 and the projection have a short
//   contraction (Cmid, Cin), so they run twice rather than store their f32
//   interiors: first a pass whose epilogue only sums (BN3's and BNp's
//   statistics), then one output product that recomputes h2.w3 and x.wp
//   into two accumulators of each tile (the same tiles and k order, so the
//   same bits) and applies BN3, BNp or the identity, the add and the relu;
//   backward, on the pipelined `mma.sync` product of tc_gemm.cuh: the same
//   products with the saved statistics, whose epilogues write h1 and h2 at
//   once and, for conv3, the sums of gz, gz*xh3 and gz*xhp; the dh2 and
//   dh1 products' epilogues give BN2's and BN1's sums; then the da passes,
//   the dgrad products and the weight-gradient products (split over
//   samples, reduced in order).
// Every reduction is fixed-order (per-tile partials, then one ordered
// reduce): no float atomics, so the results do not change from run to run.
// a1 and acc2 (f32) live in device memory, bytes the TPU kernel kept in
// VMEM; a3 and ap are never stored by the forward.
#include <math.h>

#include "wgmma_gemm.cuh"

namespace {

// ---------------------------------------------------------------------------
// geometry of the ghost tiling
// ---------------------------------------------------------------------------

// Sample rows m = (n * H + y) * W + x; haloed rows q = ((n * S + s) * th2 +
// j) * W + x, j in [0, th2), image row y = s * th - hal + j. A segment is
// the th * W sample rows (th2 * W haloed rows) of one (image, strip); ghost
// (t, s) holds the segments of images t * bt .. t * bt + bt - 1 of strip s.
struct Geo {
  int N, H, W, bt, th, hal, S, th2;
  FastDiv dW, dH, dth, dth2, dS, dbt, dL, dLh;

  __device__ __forceinline__ void split_row(int m, int& n, int& y,
                                            int& x) const {
    const int r = dW.div(m);
    x = m - r * W;
    n = dH.div(r);
    y = r - n * H;
  }
  __device__ __forceinline__ void split_haloed(int q, int& n, int& s, int& j,
                                               int& x) const {
    const int r = dW.div(q);
    x = q - r * W;
    const int r2 = dth2.div(r);
    j = r - r2 * th2;
    n = dS.div(r2);
    s = r2 - n * S;
  }
  // ghost of segment seg = n * S + s
  __device__ __forceinline__ int ghost_of_seg(int seg) const {
    const int n = dS.div(seg);
    return dbt.div(n) * S + (seg - n * S);
  }
  __device__ __forceinline__ int ghost_of_row(int m) const {
    return ghost_of_seg(dL.div(m));
  }
  __device__ __forceinline__ int ghost_of_haloed(int q) const {
    return ghost_of_seg(dLh.div(q));
  }
};

__device__ __forceinline__ float bn(float a, float m, float rs, float g,
                                    float b) {
  // g * ((a - m) * rs) + b, each operation rounded on its own
  return __fadd_rn(__fmul_rn(g, __fmul_rn(__fsub_rn(a, m), rs)), b);
}

__device__ __forceinline__ void load8f(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8f(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

// Per-ghost statistics [G, C] of the four BatchNorms: the forward writes
// them, the backward reads them
struct GhostStats {
  float *m1, *rs1, *m2, *rs2, *m3, *rs3, *mp, *rsp;
};

// ---------------------------------------------------------------------------
// operand loaders (tc_gemm.cuh): row(r) once, src(row, c, ok) per chunk of
// 8 bf16 at contiguous index c (c % 8 == 0)
// ---------------------------------------------------------------------------

// x at a haloed row (rows outside the image clamp to the edge: their
// products are masked downstream, so the value does not matter)
struct LdXHaloed {
  const bf16* x;
  int C;
  Geo geo;
  typedef const bf16* Row;
  __device__ __forceinline__ const bf16* base() const { return x; }
  __device__ __forceinline__ Row row(int q) const {
    int n, s, j, xw;
    geo.split_haloed(q, n, s, j, xw);
    int y = s * geo.th - geo.hal + j;
    y = y < 0 ? 0 : (y >= geo.H ? geo.H - 1 : y);
    return x + ((static_cast<int64_t>(n) * geo.H + y) * geo.W + xw) * C;
  }
  __device__ __forceinline__ const bf16* src(Row r, int c, bool&) const {
    return r + c;
  }
};

// the 3x3 conv's implicit operand: row m (output sample), col = tap * C +
// c: the haloed h1 of the row's own strip at the tap's source, zero past
// the image columns (and, without a halo, past the image rows)
struct LdConv {
  const bf16* h;
  int C;
  FastDiv dC;
  Geo geo;
  struct Row {
    const bf16* p;  // h at the row's own (n, s, j, x)
    int j, x;
  };
  __device__ __forceinline__ const bf16* base() const { return h; }
  __device__ __forceinline__ Row row(int m) const {
    int n, y, x;
    geo.split_row(m, n, y, x);
    const int s = geo.dth.div(y), j = y - s * geo.th + geo.hal;
    return Row{h + ((static_cast<int64_t>(n * geo.S + s) * geo.th2 + j) *
                        geo.W + x) * C,
               j, x};
  }
  __device__ __forceinline__ const bf16* src(const Row& r, int col,
                                             bool& ok) const {
    const int tap = dC.div(col), c = col - tap * C;
    const int dy = tap / 3, dx = tap - 3 * dy;
    const int js = r.j + dy - 1, xs = r.x + dx - 1;
    ok = js >= 0 && js < geo.th2 && xs >= 0 && xs < geo.W;
    return r.p + static_cast<int64_t>((dy - 1) * geo.W + dx - 1) * C + c;
  }
};

// the 3x3 conv's transpose: row q (haloed sample of strip s), col = tap * C
// + j: da2 at the output sample that read q through this tap, if that
// sample lies in strip s and inside the image columns, else zero
struct LdConvT {
  const bf16* da2;
  int C;
  FastDiv dC;
  Geo geo;
  struct Row {
    const bf16* p;  // da2 at (n, y0, x), y0 = the image row below q
    int y0, lo, x;  // lo = the strip's first row
  };
  __device__ __forceinline__ const bf16* base() const { return da2; }
  __device__ __forceinline__ Row row(int q) const {
    int n, s, j, x;
    geo.split_haloed(q, n, s, j, x);
    const int y0 = s * geo.th - geo.hal + j + 1;
    return Row{da2 + ((static_cast<int64_t>(n) * geo.H + y0) * geo.W + x) * C,
               y0, s * geo.th, x};
  }
  __device__ __forceinline__ const bf16* src(const Row& r, int col,
                                             bool& ok) const {
    const int tap = dC.div(col), j = col - tap * C;
    const int dy = tap / 3, dx = tap - 3 * dy;
    const int yo = r.y0 - dy, xo = r.x - dx + 1;
    ok = yo >= r.lo && yo < r.lo + geo.th && xo >= 0 && xo < geo.W;
    return r.p + static_cast<int64_t>(1 - dx - dy * geo.W) * C + j;
  }
};

// w2 [9, Ci, Co] read as B(k = tap * Co + j, n = i) = w2[tap][i][j]
struct LdW2T {
  const bf16* w;
  int C;
  FastDiv dC;
  typedef const bf16* Row;
  __device__ __forceinline__ const bf16* base() const { return w; }
  __device__ __forceinline__ Row row(int i) const {
    return w + static_cast<int64_t>(i) * C;
  }
  __device__ __forceinline__ const bf16* src(Row r, int col, bool&) const {
    const int tap = dC.div(col);
    return r + static_cast<int64_t>(tap) * C * C + (col - tap * C);
  }
};

// ---------------------------------------------------------------------------
// epilogues (tc_gemm.cuh), 8 columns of a row at a time: row(m) once,
// load(row, col, in) issues the row's 16-byte loads, then (split, row, col,
// v[8], in, sums); NV values a column go to the per-(tile, ghost segment)
// sums
// ---------------------------------------------------------------------------

struct F8 {  // 8 floats in flight
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float operator[](int i) const {
    const float4& h = i < 4 ? a : b;
    switch (i & 3) {
      case 0: return h.x;
      case 1: return h.y;
      case 2: return h.z;
      default: return h.w;
    }
  }
};

struct EpF32 {
  static constexpr int NV = 0;
  float* p;
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
    store8f(p + off + n, v);
  }
};

struct EpPartial {  // split-K partials [splits, M, N]
  static constexpr int NV = 0;
  float* p;
  int M, N;
  typedef int Row;
  typedef NoIn In;
  __device__ __forceinline__ Row row(int m) const { return m; }
  __device__ __forceinline__ void load(Row, int, In&) const {}
  __device__ __forceinline__ void operator()(int z, Row m, int n,
                                             const float* v, const In&,
                                             float*) const {
    store8f(p + (static_cast<int64_t>(z) * M + m) * N + n, v);
  }
};

// the forward's products: the f32 interior, and a and a^2 summed over the
// interior rows (a haloed product's halo rows add nothing)
struct EpMoments {
  static constexpr int NV = 2;
  float* p;
  int ld;
  Geo geo;
  int haloed;
  struct Row {
    int64_t off;
    float in;  // 1 on an interior row
  };
  typedef NoIn In;
  __device__ __forceinline__ Row row(int m) const {
    float in = 1.f;
    if (haloed && geo.hal) {
      const int r = geo.dW.div(m);
      const int jr = r - geo.dth2.div(r) * geo.th2;
      in = jr >= geo.hal && jr < geo.th + geo.hal ? 1.f : 0.f;
    }
    return Row{static_cast<int64_t>(m) * ld, in};
  }
  __device__ __forceinline__ void load(const Row&, int, In&) const {}
  __device__ __forceinline__ void operator()(int, const Row& r, int n,
                                             const float* v, const In&,
                                             float* s) const {
    store8f(p + r.off + n, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[e] = v[e] * r.in;
      s[8 + e] = v[e] * v[e] * r.in;
    }
  }
};

// the forward's sums-only passes (conv3, the projection): a and a^2 of
// every row, nothing stored
struct EpSums {
  static constexpr int NV = 2;
  typedef int Row;
  typedef NoIn In;
  __device__ __forceinline__ Row row(int m) const { return m; }
  __device__ __forceinline__ void load(Row, int, In&) const {}
  __device__ __forceinline__ void operator()(int, Row, int, const float* v,
                                             const In&, float* s) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[e] = v[e];
      s[8 + e] = v[e] * v[e];
    }
  }
};

// the ghost of row m (a haloed row when `haloed`) and whether it lies in
// the image
__device__ __forceinline__ int act_ghost(const Geo& geo, int m, int haloed,
                                         bool& inside) {
  inside = true;
  if (!haloed) return geo.ghost_of_row(m);
  int n, s, j, x;
  geo.split_haloed(m, n, s, j, x);
  const int y = s * geo.th - geo.hal + j;
  inside = y >= 0 && y < geo.H;
  return geo.dbt.div(n) * geo.S + s;
}

// a row of an f32 [rows, C] array with its ghost's statistics
struct StatRow {
  int64_t off, so;  // the row's offset; its ghost's row of the statistics
  bool inside;      // a haloed row inside the image
};

__device__ __forceinline__ StatRow stat_row(const Geo& geo, int m, int C,
                                            int haloed) {
  bool inside;
  const int gh = act_ghost(geo, m, haloed, inside);
  return StatRow{static_cast<int64_t>(m) * C, static_cast<int64_t>(gh) * C,
                 inside};
}

// xh = (a - m) * rs and y = g * xh + b of 8 columns, from m, rs, g and b
// in registers
__device__ __forceinline__ void bn8v(const float* a, const float* mm,
                                     const float* ss, const float* gg,
                                     const float* bb, float* xh, float* y) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    xh[e] = __fmul_rn(__fsub_rn(a[e], mm[e]), ss[e]);
    y[e] = __fadd_rn(__fmul_rn(gg[e], xh[e]), bb[e]);
  }
}

// the same with m, rs, g and b read from where the pointers point: the BN
// of part of a row
__device__ __forceinline__ void bn8(const float* a, const float* mean,
                                    const float* rs, const float* g,
                                    const float* b, float* xh, float* y) {
  float mm[8], ss[8], gg[8], bb[8];
  ldg8(mean, mm);
  ldg8(rs, ss);
  ldg8(g, gg);
  ldg8(b, bb);
  bn8v(a, mm, ss, gg, bb, xh, y);
}

// the backward's recomputed products: the f32 interior and its bf16
// activation h = bf16(relu(BN(a))) with the saved statistics (0 at a
// haloed row outside the image)
struct EpAct {
  static constexpr int NV = 0;
  float* a;
  bf16* h;
  int C;
  const float *mean, *rs, *g, *b;
  Geo geo;
  int haloed;
  typedef StatRow Row;
  typedef NoIn In;
  __device__ __forceinline__ Row row(int m) const {
    return stat_row(geo, m, C, haloed);
  }
  __device__ __forceinline__ void load(const Row&, int, In&) const {}
  __device__ __forceinline__ void operator()(int, const Row& r, int n,
                                             const float* v, const In&,
                                             float*) const {
    store8f(a + r.off + n, v);
    float xh[8], y[8];
    bn8(v, mean + r.so + n, rs + r.so + n, g + n, b + n, xh, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = r.inside ? fmaxf(y[e], 0.f) : 0.f;
    *reinterpret_cast<uint4*>(h + r.off + n) = pack8(y);
  }
};

// the final relu's gradient gz and the BN3 (and proj-BN) sums gz, gz *
// xh3, gz * xhp, from the recomputed conv3 product (a3 in registers)
struct EpOut {
  static constexpr int NV = 3;
  float* a3;
  const float* ap;
  const bf16* x;
  const bf16* g;
  const float *m3, *rs3, *g3, *b3, *mp, *rsp, *gp, *bp;
  int C, proj;
  Geo geo;
  typedef StatRow Row;
  struct In {
    uint4 g, x;  // bf16
    F8 p;        // ap
  };
  __device__ __forceinline__ Row row(int m) const {
    return stat_row(geo, m, C, 0);
  }
  __device__ __forceinline__ void load(const Row& r, int n, In& in) const {
    in.g = __ldg(reinterpret_cast<const uint4*>(g + r.off + n));
    if (proj)
      in.p.load(ap + r.off + n);
    else
      in.x = __ldg(reinterpret_cast<const uint4*>(x + r.off + n));
  }
  __device__ __forceinline__ void operator()(int, const Row& r, int n,
                                             const float* v, const In& in,
                                             float* s) const {
    store8f(a3 + r.off + n, v);
    float xh3[8], y3[8], gz[8], res[8], xhp[8];
    bn8(v, m3 + r.so + n, rs3 + r.so + n, g3 + n, b3 + n, xh3, y3);
    unpack8(in.g, gz);
    if (proj) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) p[e] = in.p[e];
      bn8(p, mp + r.so + n, rsp + r.so + n, gp + n, bp + n, xhp, res);
    } else {
      unpack8(in.x, res);
#pragma unroll
      for (int e = 0; e < 8; ++e) xhp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = __fadd_rn(y3[e], res[e]) > 0.f ? gz[e] : 0.f;
      s[e] = d;
      s[8 + e] = d * xh3[e];
      s[16 + e] = d * xhp[e];
    }
  }
};

// BN2 from the dh2 product (dh2 = dy2 in f32), and BN1 from the dh1
// product over the haloed rows: dz = dh where y = BN(a) > 0 and the row
// lies in the image; sums dz, dz * xh
struct EpBnSums {
  static constexpr int NV = 2;
  float* dh;
  const float* a;
  const float *m, *rs, *g, *b;
  int C;
  Geo geo;
  int haloed;
  typedef StatRow Row;
  struct In {
    F8 a;
  };
  __device__ __forceinline__ Row row(int q) const {
    return stat_row(geo, q, C, haloed);
  }
  __device__ __forceinline__ void load(const Row& r, int n, In& in) const {
    in.a.load(a + r.off + n);
  }
  __device__ __forceinline__ void operator()(int, const Row& r, int n,
                                             const float* v, const In& in,
                                             float* s) const {
    store8f(dh + r.off + n, v);
    float av[8], xh[8], y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) av[e] = in.a[e];
    bn8(av, m + r.so + n, rs + r.so + n, g + n, b + n, xh, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float dz = r.inside && y[e] > 0.f ? v[e] : 0.f;
      s[e] = dz;
      s[8 + e] = dz * xh[e];
    }
  }
};

// dx of a haloed row: interior rows add the residual gradient (f32) and go
// to dx; halo rows go to the seam arrays [N, S, W, C]; all rounded to bf16
struct EpDx {
  static constexpr int NV = 0;
  const float* dres;
  bf16* dx;
  bf16* dxt;
  bf16* dxb;
  int C;
  Geo geo;
  struct Row {
    bf16* out;  // the row of dx, or of a seam array
    int64_t off;
    bool interior;
  };
  struct In {
    F8 r;
  };
  __device__ __forceinline__ Row row(int q) const {
    int n, s, jr, x;
    geo.split_haloed(q, n, s, jr, x);
    if (jr >= geo.hal && jr < geo.th + geo.hal) {
      const int y = s * geo.th - geo.hal + jr;
      return Row{dx, ((static_cast<int64_t>(n) * geo.H + y) * geo.W + x) * C,
                 true};
    }
    return Row{jr == 0 ? dxt : dxb,
               ((static_cast<int64_t>(n) * geo.S + s) * geo.W + x) * C,
               false};
  }
  __device__ __forceinline__ void load(const Row& r, int c, In& in) const {
    if (r.interior) in.r.load(dres + r.off + c);
  }
  __device__ __forceinline__ void operator()(int, const Row& r, int c,
                                             const float* v, const In& in,
                                             float*) const {
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = r.interior ? __fadd_rn(v[e], in.r[e]) : v[e];
    *reinterpret_cast<uint4*>(r.out + r.off + c) = pack8(o);
  }
};

// ---------------------------------------------------------------------------
// reductions
// ---------------------------------------------------------------------------

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

// out[v][gh][c] = the per-(tile, segment) partials of an epilogue with NV
// values (tc_gemm.cuh) summed over ghost gh's segments, in image and tile
// order; L is the segment length in the product's rows
template <int NV>
__global__ void ghost_reduce_kernel(const float* __restrict__ part, int R,
                                    int L, Geo geo, int G, int C,
                                    float* __restrict__ out) {
  const int gh = blockIdx.x, c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int t = gh / geo.S, s = gh - t * geo.S;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float acc = 0.f;
    for (int b = 0; b < geo.bt; ++b) {
      const int seg = (t * geo.bt + b) * geo.S + s;
      const int first = seg * L, last = first + L - 1;
      for (int mt = first / TBM; mt <= last / TBM; ++mt) {
        const int slot = seg - (mt * TBM) / L;
        acc += part[(static_cast<int64_t>(mt * R + slot) * NV + v) * C + c];
      }
    }
    out[(static_cast<int64_t>(v) * G + gh) * C + c] = acc;
  }
}

// forward, per (ghost, channel): m = s0 / n, v = s1 / n - m^2 (written over
// s1, for the averages), mean and rsqrt(v + eps)
__global__ void stats_finalize_kernel(float* __restrict__ sums, int64_t gc,
                                      float count, float eps,
                                      float* __restrict__ mean,
                                      float* __restrict__ rs) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (o >= gc) return;
  const float m = __fdiv_rn(sums[o], count);
  const float v = __fsub_rn(__fdiv_rn(sums[gc + o], count), __fmul_rn(m, m));
  mean[o] = m;
  rs[o] = __frsqrt_rn(__fadd_rn(v, eps));
  sums[gc + o] = v;
}

// backward, per (ghost, channel): the corrections c1 = g * sum(dy) / n, c2 =
// g * sum(dy * xh) / n
__global__ void grad_finalize_kernel(const float* __restrict__ s1,
                                     const float* __restrict__ s2, int64_t gc,
                                     int C, float count,
                                     const float* __restrict__ gamma,
                                     float* __restrict__ c1,
                                     float* __restrict__ c2) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (o >= gc) return;
  const float g = gamma[o % C];
  c1[o] = __fdiv_rn(__fmul_rn(g, s1[o]), count);
  c2[o] = __fdiv_rn(__fmul_rn(g, s2[o]), count);
}

// out_k[c] = scale * sum over ghosts of in_k[g][c] for k = 0, 1, in a fixed
// order: 8 row groups of a block take every 8th ghost, then their partials
// add in group order (the averaged statistics; dgamma and dbeta)
__global__ void __launch_bounds__(256)
colsum2_kernel(const float* __restrict__ in0, const float* __restrict__ in1,
               int G, int C, float scale, float* __restrict__ out0,
               float* __restrict__ out1) {
  __shared__ float red[2][8][32];
  const int lane = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float a0 = 0.f, a1 = 0.f;
  if (c < C)
    for (int g = rg; g < G; g += 8) {
      a0 += in0[static_cast<int64_t>(g) * C + c];
      a1 += in1[static_cast<int64_t>(g) * C + c];
    }
  red[0][rg][lane] = a0;
  red[1][rg][lane] = a1;
  __syncthreads();
  if (rg == 0 && c < C) {
    float s0 = 0.f, s1 = 0.f;
    for (int r = 0; r < 8; ++r) {
      s0 += red[0][r][lane];
      s1 += red[1][r][lane];
    }
    out0[c] = __fmul_rn(s0, scale);
    out1[c] = __fmul_rn(s1, scale);
  }
}

// ---------------------------------------------------------------------------
// elementwise passes: one thread per 8 channels of a row
// ---------------------------------------------------------------------------

struct Vec8 {  // i -> (row, channel), 8 channels a thread
  int C;
  FastDiv dC8;
  __device__ __forceinline__ bool at(int64_t i, int64_t rows, int& row,
                                     int& c) const {
    if (i >= rows * (C / 8)) return false;
    row = dC8.div(static_cast<int>(i));
    c = (static_cast<int>(i) - row * (C / 8)) * 8;
    return true;
  }
};

__device__ __forceinline__ int64_t thread_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// the forward's bf16 activations h = bf16(relu(BN(a))) (0 at a haloed row
// outside the image)
__global__ void norm_kernel(const float* __restrict__ a, bf16* __restrict__ h,
                            Vec8 vc, int rows, const float* __restrict__ mean,
                            const float* __restrict__ rs,
                            const float* __restrict__ g,
                            const float* __restrict__ b, Geo geo,
                            int haloed) {
  int m, c;
  if (!vc.at(thread_index(), rows, m, c)) return;
  const int64_t off = static_cast<int64_t>(m) * vc.C + c;
  bool inside;
  const int gh = act_ghost(geo, m, haloed, inside);
  float v[8], xh[8], y[8];
  load8f(a + off, v);
  const int64_t so = static_cast<int64_t>(gh) * vc.C + c;
  bn8(v, mean + so, rs + so, g + c, b + c, xh, y);
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = inside ? fmaxf(y[i], 0.f) : 0.f;
  *reinterpret_cast<uint4*>(h + off) = pack8(y);
}

struct OutArgs {
  const float *a3, *ap;
  const bf16 *x, *g;
  const float *m3, *rs3, *g3, *b3, *mp, *rsp, *gp, *bp;
  int proj;
};

// y3 and the residual r of 8 channels of row m
__device__ __forceinline__ void out_terms(const OutArgs& o, int64_t off,
                                          int64_t so, int c, float* xh3,
                                          float* y3, float* xhp, float* r) {
  float a[8];
  load8f(o.a3 + off, a);
  bn8(a, o.m3 + so, o.rs3 + so, o.g3 + c, o.b3 + c, xh3, y3);
  if (o.proj) {
    load8f(o.ap + off, a);
    bn8(a, o.mp + so, o.rsp + so, o.gp + c, o.bp + c, xhp, r);
  } else {
    unpack8(*reinterpret_cast<const uint4*>(o.x + off), r);
#pragma unroll
    for (int i = 0; i < 8; ++i) xhp[i] = 0.f;
  }
}

// the forward's output from the output product's tile: y3 = BN3(a3) from
// the first accumulator, r = BNp(ap) from the second with PROJ, else x;
// out = bf16(relu(y3 + r))
// The ghost's statistics of the last row are kept (the rows of a thread
// mostly share a ghost), and the per-column scale and bias are read with
// loads the rows can share.
template <bool PROJ>
struct EpTrainOut {
  static constexpr int NV = 0;
  const bf16* x;
  const float *m3, *rs3, *g3, *b3, *mp, *rsp, *gp, *bp;
  bf16* out;
  int C;  // Cout (= Cin without a projection)
  Geo geo;
  mutable int64_t key = -1;  // ghost row offset + column of the kept stats
  mutable float km3[8], krs3[8], kmp[8], krsp[8];
  typedef StatRow Row;
  struct In {
    uint4 x;  // 8 bf16 of x without a projection
  };
  __device__ __forceinline__ Row row(int m) const {
    return stat_row(geo, m, C, 0);
  }
  __device__ __forceinline__ void load(const Row& r, int n, In& in) const {
    if (!PROJ) in.x = __ldg(reinterpret_cast<const uint4*>(x + r.off + n));
  }
  __device__ __forceinline__ void stats(const Row& r, int n) const {
    if (r.so + n == key) return;
    key = r.so + n;
    ldg8(m3 + key, km3);
    ldg8(rs3 + key, krs3);
    if (PROJ) {
      ldg8(mp + key, kmp);
      ldg8(rsp + key, krsp);
    }
  }
  __device__ __forceinline__ void write(int n, const float* a3,
                                        const float* res, bf16* o) const {
    float xh3[8], y3[8], gg[8], bb[8];
    ldg8(g3 + n, gg);
    ldg8(b3 + n, bb);
    bn8v(a3, km3, krs3, gg, bb, xh3, y3);
#pragma unroll
    for (int e = 0; e < 8; ++e) y3[e] = fmaxf(__fadd_rn(y3[e], res[e]), 0.f);
    *reinterpret_cast<uint4*>(o) = pack8(y3);
  }
  __device__ __forceinline__ void operator()(const Row& r, int n,
                                             const float* a3,
                                             const float* ap, const In&,
                                             float*) const {
    stats(r, n);
    float xhp[8], res[8], gg[8], bb[8];
    ldg8(gp + n, gg);
    ldg8(bp + n, bb);
    bn8v(ap, kmp, krsp, gg, bb, xhp, res);
    write(n, a3, res, out + r.off + n);
  }
  __device__ __forceinline__ void operator()(int, const Row& r, int n,
                                             const float* a3, const In& in,
                                             float*) const {
    stats(r, n);
    float res[8];
    unpack8(in.x, res);
    write(n, a3, res, out + r.off + n);
  }
};

// da = rs * ((dy * g - c1) - xh * c2), the BN backward of the interior BNs
__device__ __forceinline__ float bn_da(float dy, float xh, float rs, float g,
                                       float c1, float c2) {
  return __fmul_rn(rs, __fsub_rn(__fsub_rn(__fmul_rn(dy, g), c1),
                                 __fmul_rn(xh, c2)));
}

// da3 (and dap) in bf16; without proj the residual's gradient gz goes to
// dres in f32
__global__ void out_da_kernel(OutArgs o, Vec8 vc, int rows, Geo geo,
                              const float* __restrict__ c13,
                              const float* __restrict__ c23,
                              const float* __restrict__ c1p,
                              const float* __restrict__ c2p,
                              bf16* __restrict__ da3, bf16* __restrict__ dap,
                              float* __restrict__ dres) {
  int m, c;
  if (!vc.at(thread_index(), rows, m, c)) return;
  const int64_t off = static_cast<int64_t>(m) * vc.C + c;
  const int64_t so = static_cast<int64_t>(geo.ghost_of_row(m)) * vc.C + c;
  float xh3[8], y3[8], xhp[8], r[8], gz[8], d[8], s[8], g[8], k1[8], k2[8];
  out_terms(o, off, so, c, xh3, y3, xhp, r);
  unpack8(*reinterpret_cast<const uint4*>(o.g + off), gz);
  ldg8(o.rs3 + so, s);
  ldg8(o.g3 + c, g);
  ldg8(c13 + so, k1);
  ldg8(c23 + so, k2);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    gz[i] = __fadd_rn(y3[i], r[i]) > 0.f ? gz[i] : 0.f;
    d[i] = bn_da(gz[i], xh3[i], s[i], g[i], k1[i], k2[i]);
  }
  *reinterpret_cast<uint4*>(da3 + off) = pack8(d);
  if (o.proj) {
    ldg8(o.rsp + so, s);
    ldg8(o.gp + c, g);
    ldg8(c1p + so, k1);
    ldg8(c2p + so, k2);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      d[i] = bn_da(gz[i], xhp[i], s[i], g[i], k1[i], k2[i]);
    *reinterpret_cast<uint4*>(dap + off) = pack8(d);
  } else {
    store8f(dres + off, gz);
  }
}

// an interior BN's backward: the f32 interior a, its gradient dh (both
// [rows, C]) and the BN's statistics, scale and bias
struct DaArgs {
  const float *a, *dh, *m, *rs, *g, *b;
};

__global__ void mid_da_kernel(DaArgs f, Vec8 vc, int rows, Geo geo,
                              const float* __restrict__ c1,
                              const float* __restrict__ c2,
                              bf16* __restrict__ da2) {
  int m, c;
  if (!vc.at(thread_index(), rows, m, c)) return;
  const int64_t off = static_cast<int64_t>(m) * vc.C + c;
  const int64_t so = static_cast<int64_t>(geo.ghost_of_row(m)) * vc.C + c;
  float a[8], dh[8], d[8], mv[8], sv[8], gv[8], bv[8], k1[8], k2[8];
  load8f(f.a + off, a);
  load8f(f.dh + off, dh);
  ldg8(f.m + so, mv);
  ldg8(f.rs + so, sv);
  ldg8(f.g + c, gv);
  ldg8(f.b + c, bv);
  ldg8(c1 + so, k1);
  ldg8(c2 + so, k2);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float xh = __fmul_rn(__fsub_rn(a[i], mv[i]), sv[i]);
    const float y = __fadd_rn(__fmul_rn(gv[i], xh), bv[i]);
    const float dz = y > 0.f ? dh[i] : 0.f;
    d[i] = bn_da(dz, xh, sv[i], gv[i], k1[i], k2[i]);
  }
  *reinterpret_cast<uint4*>(da2 + off) = pack8(d);
}

// da1 over the haloed rows: rs * (dxh - (c1 + xh * c2)) on interior rows,
// rs * dxh on halo rows, zero outside the image
__global__ void in_da_kernel(DaArgs f, Vec8 vc, int rows, Geo geo,
                             const float* __restrict__ c1,
                             const float* __restrict__ c2,
                             bf16* __restrict__ da1) {
  int q, c;
  if (!vc.at(thread_index(), rows, q, c)) return;
  const int64_t off = static_cast<int64_t>(q) * vc.C + c;
  int n, s, jr, x;
  geo.split_haloed(q, n, s, jr, x);
  const int y = s * geo.th - geo.hal + jr;
  float d[8];
  if (y < 0 || y >= geo.H) {
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = 0.f;
    *reinterpret_cast<uint4*>(da1 + off) = pack8(d);
    return;
  }
  const int64_t so =
      static_cast<int64_t>(geo.dbt.div(n) * geo.S + s) * vc.C + c;
  const bool interior = jr >= geo.hal && jr < geo.th + geo.hal;
  float a[8], dh[8], mv[8], sv[8], gv[8], bv[8], k1[8], k2[8];
  load8f(f.a + off, a);
  load8f(f.dh + off, dh);
  ldg8(f.m + so, mv);
  ldg8(f.rs + so, sv);
  ldg8(f.g + c, gv);
  ldg8(f.b + c, bv);
  ldg8(c1 + so, k1);
  ldg8(c2 + so, k2);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float xh = __fmul_rn(__fsub_rn(a[i], mv[i]), sv[i]);
    const float yv = __fadd_rn(__fmul_rn(gv[i], xh), bv[i]);
    const float dxh = __fmul_rn(yv > 0.f ? dh[i] : 0.f, gv[i]);
    const float dd = interior
        ? __fsub_rn(dxh, __fadd_rn(k1[i], __fmul_rn(xh, k2[i])))
        : dxh;
    d[i] = __fmul_rn(sv[i], dd);
  }
  *reinterpret_cast<uint4*>(da1 + off) = pack8(d);
}

// dx[n, row, x, c] += seam[n, s, x, c] in bf16 for s in [s_lo, s_hi), row =
// s * th + row_off
__global__ void seam_add_kernel(bf16* __restrict__ dx,
                                const bf16* __restrict__ seam, Geo geo, int C,
                                int s_lo, int s_hi, int row_off) {
  const int64_t per = static_cast<int64_t>(s_hi - s_lo) * geo.W * C;
  const int64_t i = thread_index();
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

int blocks_for(int64_t n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

// split-K for the wgrad products (K = samples): about 4 blocks an SM
void wgrad_split(int M, int N, int K, int* splits, int* kchunk) {
  const int64_t tiles =
      static_cast<int64_t>((M + TBM - 1) / TBM) * ((N + TBN - 1) / TBN);
  int64_t want = (528 + tiles - 1) / tiles;
  const int64_t most = (K + 255) / 256;
  if (want > most) want = most;
  if (want < 1) want = 1;
  int64_t chunk = (K + want - 1) / want;
  chunk = (chunk + TBK - 1) / TBK * TBK;
  *kchunk = static_cast<int>(chunk);
  *splits = static_cast<int>((K + chunk - 1) / chunk);
}

int64_t wgrad_floats(int M, int N, int K) {
  int splits, chunk;
  wgrad_split(M, N, K, &splits, &chunk);
  return static_cast<int64_t>(splits) * M * N;
}

// out [M, N] f32 = sum over samples of A(m, i) B(m, n), through partials
template <class LA, class LB>
cudaError_t wgrad(LA la, LB lb, int M, int N, int K, float* part, float* out,
                  cudaStream_t st) {
  int splits, chunk;
  wgrad_split(M, N, K, &splits, &chunk);
  cudaError_t e = tc_gemm<false, false>(la, lb, EpPartial{part, M, N},
                                        SegSums{nullptr, 1, 1}, M, N, K,
                                        splits, chunk, st);
  if (e != cudaSuccess) return e;
  const int64_t n = static_cast<int64_t>(M) * N;
  reduce_splits_kernel<<<blocks_for(n, 256), 256, 0, st>>>(part, splits, n,
                                                            out);
  return cudaGetLastError();
}

template <int NV>
cudaError_t ghost_reduce(const SegSums& seg, const Geo& geo, int G, int C,
                         float* out, cudaStream_t st) {
  const dim3 grid(G, (C + 127) / 128);
  ghost_reduce_kernel<NV><<<grid, 128, 0, st>>>(seg.part, seg.R, seg.L, geo,
                                                G, C, out);
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
  // f32 per-ghost mean and rsqrt(v + eps): [G, Cmid] m1, rs1, m2, rs2, then
  // [G, Cout] m3, rs3, mp, rsp. The forward writes them; the backward reads
  // them, or recomputes them when 0
  float* ghost;
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

struct Dims {  // the block's sizes as the launches use them
  Geo geo;
  int M, Mh, G, Cin, Cmid, Cout, L, Lh;
};

Dims dims_of(const KftpuBlockArgs& a) {
  Dims d;
  Geo& g = d.geo;
  g.N = static_cast<int>(a.N);
  g.H = static_cast<int>(a.H);
  g.W = static_cast<int>(a.W);
  g.bt = static_cast<int>(a.bt);
  g.th = static_cast<int>(a.th);
  g.hal = static_cast<int>(a.hal);
  g.S = static_cast<int>(a.H / a.th);
  g.th2 = g.th + 2 * g.hal;
  d.L = g.th * g.W;
  d.Lh = g.th2 * g.W;
  g.dW = fast_div(g.W);
  g.dH = fast_div(g.H);
  g.dth = fast_div(g.th);
  g.dth2 = fast_div(g.th2);
  g.dS = fast_div(g.S);
  g.dbt = fast_div(g.bt);
  g.dL = fast_div(d.L);
  g.dLh = fast_div(d.Lh);
  d.M = static_cast<int>(a.N * a.H * a.W);
  d.Mh = g.N * g.S * d.Lh;
  d.G = (g.N / g.bt) * g.S;
  d.Cin = static_cast<int>(a.Cin);
  d.Cmid = static_cast<int>(a.Cmid);
  d.Cout = static_cast<int>(a.Cout);
  return d;
}

GhostStats ghost_stats(float* p, const Dims& d) {
  const int64_t gm = static_cast<int64_t>(d.G) * d.Cmid;
  const int64_t go = static_cast<int64_t>(d.G) * d.Cout;
  GhostStats s;
  s.m1 = p;
  s.rs1 = s.m1 + gm;
  s.m2 = s.rs1 + gm;
  s.rs2 = s.m2 + gm;
  s.m3 = s.rs2 + gm;
  s.rs3 = s.m3 + go;
  s.mp = s.rs3 + go;
  s.rsp = s.mp + go;
  return s;
}

int64_t ghost_floats(const Dims& d) {
  return static_cast<int64_t>(d.G) * (4 * d.Cmid + 4 * d.Cout);
}

struct Bufs {  // the forward's interiors, their activations, sums
  float *a1, *acc2;  // a1 over the haloed rows
  bf16 *h1, *h2;               // h1 over the haloed rows
  float *part, *sums;
};

// partials of an NV-value epilogue over `rows` product rows
int64_t seg_floats(int rows, int L, int NV, int C) {
  const SegSums s = seg_sums(nullptr, L);
  return static_cast<int64_t>((rows + TBM - 1) / TBM) * s.R * NV * C;
}

Bufs carve_fwd(const KftpuBlockArgs& a, const Dims& d, Carve& cv) {
  Bufs b;
  b.a1 = cv.take<float>(static_cast<int64_t>(d.Mh) * d.Cmid);
  b.h1 = cv.take<bf16>(static_cast<int64_t>(d.Mh) * d.Cmid);
  b.acc2 = cv.take<float>(static_cast<int64_t>(d.M) * d.Cmid);
  b.h2 = cv.take<bf16>(static_cast<int64_t>(d.M) * d.Cmid);
  int64_t part = seg_floats(d.Mh, d.Lh, 2, d.Cmid);
  const int64_t p3 = seg_floats(d.M, d.L, 3, d.Cout);
  const int64_t p2 = seg_floats(d.M, d.L, 2, d.Cmid);
  if (p3 > part) part = p3;
  if (p2 > part) part = p2;
  b.part = cv.take<float>(part);
  const int cmax = d.Cmid > d.Cout ? d.Cmid : d.Cout;
  b.sums = cv.take<float>(3 * static_cast<int64_t>(d.G) * cmax);
  return b;
}

struct BwdBufs {
  float *a3, *ap;  // the backward's recomputed conv3 and projection
  float *c13, *c23, *c1p, *c2p, *dres, *dh2, *c12, *c22;
  float *dh1, *c11, *c21, *part;
  bf16 *da3, *dap, *da2, *da1;
  float* ghost;  // recomputed statistics when the caller gives none
};

BwdBufs carve_bwd(const KftpuBlockArgs& a, const Dims& d, Carve& cv) {
  const int64_t M = d.M, Mh = d.Mh, G = d.G;
  BwdBufs b;
  b.ghost = a.ghost == nullptr ? cv.take<float>(ghost_floats(d)) : a.ghost;
  b.a3 = cv.take<float>(M * d.Cout);
  b.ap = a.proj ? cv.take<float>(M * d.Cout) : nullptr;
  b.c13 = cv.take<float>(G * d.Cout);
  b.c23 = cv.take<float>(G * d.Cout);
  b.c1p = cv.take<float>(G * d.Cout);
  b.c2p = cv.take<float>(G * d.Cout);
  b.da3 = cv.take<bf16>(M * d.Cout);
  b.dap = a.proj ? cv.take<bf16>(M * d.Cout) : nullptr;
  b.dres = cv.take<float>(M * d.Cin);
  b.dh2 = cv.take<float>(M * d.Cmid);
  b.c12 = cv.take<float>(G * d.Cmid);
  b.c22 = cv.take<float>(G * d.Cmid);
  b.da2 = cv.take<bf16>(M * d.Cmid);
  b.dh1 = cv.take<float>(Mh * d.Cmid);
  b.c11 = cv.take<float>(G * d.Cmid);
  b.c21 = cv.take<float>(G * d.Cmid);
  b.da1 = cv.take<bf16>(Mh * d.Cmid);
  int64_t part = wgrad_floats(d.Cmid, d.Cout, d.M);           // dw3
  const int64_t p2 = wgrad_floats(9 * d.Cmid, d.Cmid, d.M);   // dw2
  const int64_t p1 = wgrad_floats(d.Cin, d.Cmid, d.Mh);       // dw1
  const int64_t pp = a.proj ? wgrad_floats(d.Cin, d.Cout, d.M) : 0;
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

Vec8 vec8(int C) { return Vec8{C, fast_div(C / 8)}; }

// the forward: interiors, activations and per-ghost statistics (into
// `gs`); the output and the averaged statistics when `final_out`
cudaError_t run_forward(const KftpuBlockArgs& a, const Dims& d,
                        const Bufs& b, const GhostStats& gs, bool final_out,
                        cudaStream_t st) {
  const Geo& geo = d.geo;
  const int G = d.G, Cin = d.Cin, Cmid = d.Cmid, Cout = d.Cout;
  const float count = static_cast<float>(a.bt * a.th * a.W);
  const float eps = static_cast<float>(a.eps);
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w1 = static_cast<const bf16*>(a.w1);
  const bf16* w2 = static_cast<const bf16*>(a.w2);
  const bf16* w3 = static_cast<const bf16*>(a.w3);
  const bf16* wp = static_cast<const bf16*>(a.wp);
  const SegSums sh = seg_sums(b.part, d.Lh), sr = seg_sums(b.part, d.L);
  // sums -> per-ghost m, rsqrt (and the averages when final_out)
  auto stats = [&](const SegSums& seg, int C, float* mean, float* rs,
                   float* am, float* av) -> cudaError_t {
    KFTPU_TRY(ghost_reduce<2>(seg, geo, G, C, b.sums, st));
    const int64_t gc = static_cast<int64_t>(G) * C;
    stats_finalize_kernel<<<blocks_for(gc, 256), 256, 0, st>>>(
        b.sums, gc, count, eps, mean, rs);
    KFTPU_TRY(cudaGetLastError());
    if (final_out) {
      colsum2_kernel<<<(C + 31) / 32, 256, 0, st>>>(
          mean, b.sums + gc, G, C, 1.f / static_cast<float>(G), am, av);
      KFTPU_TRY(cudaGetLastError());
    }
    return cudaSuccess;
  };
  auto norm = [&](const float* src, bf16* h, int rows, int C,
                  const float* mean, const float* rs, const float* g,
                  const float* bb, int haloed) {
    const int64_t n = static_cast<int64_t>(rows) * (C / 8);
    norm_kernel<<<blocks_for(n, 256), 256, 0, st>>>(
        src, h, vec8(C), rows, mean, rs, g, bb, geo, haloed);
    return cudaGetLastError();
  };

  // conv1 1x1 over the haloed rows (x gathered with its halo, or plain x
  // by TMA without one), BN1 statistics over the interior, h1
  const Plain xm{x, d.M, Cin, Cin}, w1m{w1, Cin, Cmid, Cmid};
  const EpMoments e1{b.a1, Cmid, geo, 1};
  if (geo.hal)
    KFTPU_TRY(wg_gemm_gather(LdXHaloed{x, Cin, geo}, w1m, e1, d.Mh, Cmid,
                             Cin, st, sh));
  else
    KFTPU_TRY(wg_gemm(xm, w1m, e1, d.Mh, Cmid, Cin, st, sh));
  KFTPU_TRY(stats(sh, Cmid, gs.m1, gs.rs1, a.m1, a.v1));
  KFTPU_TRY(norm(b.a1, b.h1, d.Mh, Cmid, gs.m1, gs.rs1, a.g1, a.b1, 1));
  // the projection's BN statistics (its product is run again for out)
  const Plain wpm{wp, Cin, Cout, Cout};
  if (a.proj) {
    KFTPU_TRY(wg_gemm(xm, wpm, EpSums{}, d.M, Cout, Cin, st, sr));
    KFTPU_TRY(stats(sr, Cout, gs.mp, gs.rsp, a.mp, a.vp));
  }
  // conv2 3x3 over h1, BN2 statistics, h2
  KFTPU_TRY(wg_gemm_gather(LdConv{b.h1, Cmid, fast_div(Cmid), geo},
                           Plain{w2, 9 * Cmid, Cmid, Cmid},
                           EpMoments{b.acc2, Cmid, geo, 0}, d.M, Cmid,
                           9 * Cmid, st, sr));
  KFTPU_TRY(stats(sr, Cmid, gs.m2, gs.rs2, a.m2, a.v2));
  KFTPU_TRY(norm(b.acc2, b.h2, d.M, Cmid, gs.m2, gs.rs2, a.g2, a.b2, 0));
  // conv3 1x1 over h2: BN3 statistics
  const Plain h2m{b.h2, d.M, Cmid, Cmid}, w3m{w3, Cmid, Cout, Cout};
  KFTPU_TRY(wg_gemm(h2m, w3m, EpSums{}, d.M, Cout, Cmid, st, sr));
  KFTPU_TRY(stats(sr, Cout, gs.m3, gs.rs3, a.m3, a.v3));
  if (!final_out) return cudaSuccess;
  // the output product: conv3 (and the projection) again, BN, add, relu
  bf16* out = static_cast<bf16*>(a.out);
  if (a.proj)
    return wg_gemm2(h2m, w3m, xm, wpm,
                    EpTrainOut<true>{x, gs.m3, gs.rs3, a.g3, a.b3, gs.mp,
                                     gs.rsp, a.gp, a.bp, out, Cout, geo},
                    d.M, Cout, Cmid, Cin, st);
  return wg_gemm(h2m, w3m,
                 EpTrainOut<false>{x, gs.m3, gs.rs3, a.g3, a.b3, nullptr,
                                   nullptr, nullptr, nullptr, out, Cout, geo},
                 d.M, Cout, Cmid, st);
}

bool args_ok(const KftpuBlockArgs& a) {
  if (a.N <= 0 || a.H <= 0 || a.W <= 0 || a.bt <= 0 || a.th <= 0) return false;
  if (a.N % a.bt || a.H % a.th) return false;
  if (a.Cin % 8 || a.Cmid % 8 || a.Cout % 8) return false;
  if (a.hal != 0 && a.hal != 1) return false;
  if (a.hal == 0 && a.th != a.H) return false;
  if (!a.proj && a.Cin != a.Cout) return false;
  // every row index and 9 * Cmid in 31 bits (the products' int indices)
  const int64_t mh = a.N * (a.H / a.th) * (a.th + 2 * a.hal) * a.W;
  if (mh >= (int64_t(1) << 31) || 9 * a.Cmid >= (int64_t(1) << 31))
    return false;
  return true;
}

}  // namespace

// Bytes of scratch the forward (backward = 0) or the backward (1) needs.
extern "C" int64_t kftpu_block_train_workspace(const KftpuBlockArgs* a,
                                               int backward) {
  const Dims d = dims_of(*a);
  Carve cv{nullptr, 0};
  carve_fwd(*a, d, cv);
  if (backward) carve_bwd(*a, d, cv);
  return static_cast<int64_t>(cv.off) + 256;
}

// out, the 8 ghost-averaged statistics and the per-ghost ones (`ghost`).
// Returns a cudaError_t.
extern "C" int kftpu_block_train_fwd(const KftpuBlockArgs* a, void* stream) {
  if (!args_ok(*a) || a->ghost == nullptr) return cudaErrorInvalidValue;
  const Dims d = dims_of(*a);
  Carve cv{static_cast<char*>(a->workspace), 0};
  const Bufs b = carve_fwd(*a, d, cv);
  return run_forward(*a, d, b, ghost_stats(a->ghost, d), true,
                     static_cast<cudaStream_t>(stream));
}

// dx (with the seam rows added) and the 9 or 12 weight gradients, from x,
// the output's gradient g, the weights and the forward's per-ghost
// statistics (recomputed with the forward's launches when `ghost` is 0).
extern "C" int kftpu_block_train_bwd(const KftpuBlockArgs* a, void* stream) {
  if (!args_ok(*a)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = dims_of(*a);
  const Geo& geo = d.geo;
  Carve cv{static_cast<char*>(a->workspace), 0};
  const Bufs b = carve_fwd(*a, d, cv);
  const BwdBufs w = carve_bwd(*a, d, cv);
  const GhostStats gs = ghost_stats(w.ghost, d);
  if (a->ghost == nullptr) KFTPU_TRY(run_forward(*a, d, b, gs, false, st));

  const int M = d.M, Mh = d.Mh, G = d.G;
  const int Cin = d.Cin, Cmid = d.Cmid, Cout = d.Cout;
  const float count = static_cast<float>(a->bt * a->th * a->W);
  const bf16* x = static_cast<const bf16*>(a->x);
  const bf16* w1 = static_cast<const bf16*>(a->w1);
  const bf16* w2 = static_cast<const bf16*>(a->w2);
  const bf16* w3 = static_cast<const bf16*>(a->w3);
  const bf16* wp = static_cast<const bf16*>(a->wp);
  const FastDiv dCmid = fast_div(Cmid);
  const SegSums sh = seg_sums(b.part, d.Lh), sr = seg_sums(b.part, d.L);
  // per-ghost sums s1 (dy), s2 (dy * xh) -> corrections; dgamma, dbeta
  auto finalize = [&](const float* s1, const float* s2, int C,
                      const float* gamma, float* c1, float* c2, float* dg,
                      float* db) -> cudaError_t {
    const int64_t gc = static_cast<int64_t>(G) * C;
    grad_finalize_kernel<<<blocks_for(gc, 256), 256, 0, st>>>(
        s1, s2, gc, C, count, gamma, c1, c2);
    KFTPU_TRY(cudaGetLastError());
    colsum2_kernel<<<(C + 31) / 32, 256, 0, st>>>(s2, s1, G, C, 1.f, dg, db);
    return cudaGetLastError();
  };

  // the interiors with the saved statistics: a1 and h1 over the haloed
  // rows, acc2 and h2; ap
  KFTPU_TRY((tc_gemm_full<true, false>(
      LdXHaloed{x, Cin, geo}, LdRows{w1, Cmid},
      EpAct{b.a1, b.h1, Cmid, gs.m1, gs.rs1, a->g1, a->b1, geo, 1}, Mh,
      Cmid, Cin, st)));
  if (a->proj)
    KFTPU_TRY((tc_gemm_full<true, false>(LdRows{x, Cin}, LdRows{wp, Cout},
                                         EpF32{w.ap, Cout}, M, Cout, Cin,
                                         st)));
  KFTPU_TRY((tc_gemm_full<true, false>(
      LdConv{b.h1, Cmid, dCmid, geo}, LdRows{w2, Cmid},
      EpAct{b.acc2, b.h2, Cmid, gs.m2, gs.rs2, a->g2, a->b2, geo, 0}, M,
      Cmid, 9 * Cmid, st)));
  // conv3 with the final relu's and BN3's (and proj BN's) sums in its
  // epilogue; corrections; da3 / dap / dres
  const bf16* g = static_cast<const bf16*>(a->g);
  KFTPU_TRY((tc_gemm_full<true, false>(
      LdRows{b.h2, Cmid}, LdRows{w3, Cout},
      EpOut{w.a3, w.ap, x, g, gs.m3, gs.rs3, a->g3, a->b3, gs.mp, gs.rsp,
            a->gp, a->bp, Cout, static_cast<int>(a->proj), geo},
      M, Cout, Cmid, st, sr)));
  KFTPU_TRY(ghost_reduce<3>(sr, geo, G, Cout, b.sums, st));
  const int64_t gc = static_cast<int64_t>(G) * Cout;
  KFTPU_TRY(finalize(b.sums, b.sums + gc, Cout, a->g3, w.c13, w.c23,
                     a->dg3, a->db3));
  if (a->proj)
    KFTPU_TRY(finalize(b.sums, b.sums + 2 * gc, Cout, a->gp, w.c1p, w.c2p,
                       a->dgp, a->dbp));
  const OutArgs o{w.a3, w.ap, x, g, gs.m3, gs.rs3, a->g3, a->b3, gs.mp,
                  gs.rsp, a->gp, a->bp, static_cast<int>(a->proj)};
  const int64_t tout = static_cast<int64_t>(M) * (Cout / 8);
  out_da_kernel<<<blocks_for(tout, 256), 256, 0, st>>>(
      o, vec8(Cout), M, geo, w.c13, w.c23, w.c1p, w.c2p, w.da3, w.dap,
      w.dres);
  KFTPU_TRY(cudaGetLastError());

  // conv3: dw3 = h2^T da3; dh2 = da3 w3^T with BN2's sums; da2
  KFTPU_TRY(wgrad(LdRows{b.h2, Cmid}, LdRows{w.da3, Cout}, Cmid, Cout, M,
                  w.part, a->dw3, st));
  KFTPU_TRY((tc_gemm_full<true, true>(
      LdRows{w.da3, Cout}, LdRows{w3, Cout},
      EpBnSums{w.dh2, b.acc2, gs.m2, gs.rs2, a->g2, a->b2, Cmid, geo, 0}, M,
      Cmid,
      Cout, st, sr)));
  KFTPU_TRY(ghost_reduce<2>(sr, geo, G, Cmid, b.sums, st));
  const int64_t gm = static_cast<int64_t>(G) * Cmid;
  KFTPU_TRY(finalize(b.sums, b.sums + gm, Cmid, a->g2, w.c12, w.c22,
                     a->dg2, a->db2));
  const int64_t tmid = static_cast<int64_t>(M) * (Cmid / 8);
  mid_da_kernel<<<blocks_for(tmid, 256), 256, 0, st>>>(
      DaArgs{b.acc2, w.dh2, gs.m2, gs.rs2, a->g2, a->b2}, vec8(Cmid), M, geo,
      w.c12, w.c22, w.da2);
  KFTPU_TRY(cudaGetLastError());

  // conv2: dw2 = h1_tap^T da2 per tap; dh1 (haloed) = the transposed conv
  // with BN1's sums over the haloed rows; da1
  KFTPU_TRY(wgrad(LdConv{b.h1, Cmid, dCmid, geo}, LdRows{w.da2, Cmid},
                  9 * Cmid, Cmid, M, w.part, a->dw2, st));
  KFTPU_TRY((tc_gemm_full<true, true>(
      LdConvT{w.da2, Cmid, dCmid, geo}, LdW2T{w2, Cmid, dCmid},
      EpBnSums{w.dh1, b.a1, gs.m1, gs.rs1, a->g1, a->b1, Cmid, geo, 1}, Mh,
      Cmid,
      9 * Cmid, st, sh)));
  KFTPU_TRY(ghost_reduce<2>(sh, geo, G, Cmid, b.sums, st));
  KFTPU_TRY(finalize(b.sums, b.sums + gm, Cmid, a->g1, w.c11, w.c21,
                     a->dg1, a->db1));
  const int64_t tin = static_cast<int64_t>(Mh) * (Cmid / 8);
  in_da_kernel<<<blocks_for(tin, 256), 256, 0, st>>>(
      DaArgs{b.a1, w.dh1, gs.m1, gs.rs1, a->g1, a->b1}, vec8(Cmid), Mh, geo,
      w.c11, w.c21, w.da1);
  KFTPU_TRY(cudaGetLastError());

  // conv1: dw1 = x_haloed^T da1; proj: dwp = x^T dap, dres = dap wp^T
  KFTPU_TRY(wgrad(LdXHaloed{x, Cin, geo}, LdRows{w.da1, Cmid}, Cin, Cmid,
                  Mh, w.part, a->dw1, st));
  if (a->proj) {
    KFTPU_TRY(wgrad(LdRows{x, Cin}, LdRows{w.dap, Cout}, Cin, Cout, M,
                    w.part, a->dwp, st));
    KFTPU_TRY((tc_gemm_full<true, true>(LdRows{w.dap, Cout},
                                        LdRows{wp, Cout}, EpF32{w.dres, Cin},
                                        M, Cin, Cout, st)));
  }
  // dx = da1 w1^T (+ the residual's gradient on interior rows), seam rows
  // to the thin arrays, then added into dx: top halos, then bottom halos
  bf16* dx = static_cast<bf16*>(a->dx);
  bf16* dxt = static_cast<bf16*>(a->dxt);
  bf16* dxb = static_cast<bf16*>(a->dxb);
  KFTPU_TRY((tc_gemm_full<true, true>(LdRows{w.da1, Cmid}, LdRows{w1, Cmid},
                                      EpDx{w.dres, dx, dxt, dxb, Cin, geo},
                                      Mh, Cin, Cmid, st)));
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
