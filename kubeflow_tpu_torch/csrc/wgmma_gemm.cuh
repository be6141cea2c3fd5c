// The warpgroup bf16 product of the fused ResNet bottleneck kernels on
// Hopper (sm_90a): C[M, N] = sum_k A(m, k) B(k, n), bf16 operands, f32
// accumulators, on `wgmma.mma_async` (K6's three products in
// fused_block.cu, the K4/K5 forward's in fused_block_train.cu; the K4/K5
// backward stays on tc_gemm.cuh's `mma.sync` product).
//
// - A block of 256 + P threads owns output tiles of 128 x BN (BN 64 or 128)
//   and walks k in steps of 64: warpgroups 0 and 1 are the consumers, each
//   of which owns 64 rows of the tile and issues m64nBNk16 `wgmma`s, four
//   per k step, on operands in shared memory; after them comes the
//   producer, P = 32 threads where every operand comes by TMA, 128 where A
//   is gathered.
// - The grid is persistent: as many blocks as fit the card (two an SM at
//   BN 64 with one accumulator, about 110 KB of shared memory each, so one
//   block's epilogue overlaps the other's main loop; one otherwise), each
//   walking the tiles t = blockIdx.x + i * gridDim.x in tile order (the N
//   tiles of an M tile together, so A is read once from device memory).
//   The ring runs on across tiles, so the producer loads tile i + 1 while
//   the consumers run tile i's epilogue, and a block's fixed costs
//   (barrier set-up, the first loads' latency) are paid once. Short
//   contractions (conv3, the projection, K = 64-256) stay bound by their
//   epilogues: staging the accumulators and the epilogue's arithmetic.
// - Operands are staged in a ring of 3 (two blocks an SM) or 4 stages in
//   128-byte-swizzled shared memory (16-byte chunk c of a
//   128-byte row r sits at chunk c ^ (r % 8)), which is the layout the
//   `wgmma` descriptors read. B is a weight stored [K, N] (N contiguous),
//   read N-major (the transpose bit of the instruction). Two `mbarrier`s a
//   stage order the ring: `full` (the stage has landed) and `empty` (both
//   consumers are done with it).
// - Plain row operands (x, h2) and every weight come by TMA: a
//   `CUtensorMap` passed as `__grid_constant__` and prefetched; one
//   producer thread asks for the whole box, the hardware swizzles it and
//   counts its bytes on the stage's `full` barrier, and zero-fills what
//   lies past the tensor's edge (the ragged M and K). The host keeps the
//   maps it encoded (a map is a function of its pointer and shape).
// - Gathered operands (the 3x3 conv's taps, the haloed x rows, zeros past
//   an image edge) come by 16-byte `cp.async` from all 128 producer
//   threads through tc_gemm.cuh's loader contract (`row(r)` once per tile,
//   `src(row, c, ok)` per chunk); each thread writes the swizzled address
//   itself. A thread keeps the copies of STAGES - 1 steps in flight: before
//   it waits for a free stage it waits for its copies of the oldest step,
//   fences them to the async proxy that `wgmma` reads through, and arrives
//   on that step's `full` barrier.
// - A consumer keeps one k step of `wgmma`s in flight: it releases stage
//   k - 1 once the group of step k is issued and the group of step k - 1
//   has completed, and a tile's last stage when its group has.
// - Results leave as in tc_gemm.cuh: the accumulators are staged through
//   shared memory of their own (the `wgmma` fragment layout is absorbed
//   there), then the 256 consumer threads run the epilogue 8 columns of 4
//   rows at a time, 64 columns at once, with the same per-(tile, ghost
//   segment) sums; so the epilogues and ghost_reduce_kernel carry over
//   unchanged. A tile inside one ghost segment sums in registers and
//   across warps; one that straddles segments stages each value's rows in
//   the staging memory and cuts each column at the segment ends. NACC = 2
//   runs two products into two accumulators of one tile (h2.w3 and x.wp,
//   one after the other in the ring), whose epilogue gets both.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tc_gemm.cuh"

namespace {

constexpr int WG_BM = 128, WG_BK = 64;
constexpr int WG_CONSUMERS = 256;   // two consumer warpgroups
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;  // 16 KB, rows of 128 bytes
constexpr int WG_HALF = 64;         // epilogue columns at a time
constexpr int WG_RED_LD = WG_HALF + 1;

template <int BN>
__host__ __device__ constexpr int wg_stage_bytes() {
  return WG_A_BYTES + WG_BK * BN * 2;
}

// ring stages and blocks an SM: a one-accumulator BN 64 block fits two an
// SM with a 3-stage ring (at most 112 registers a thread with the TMA
// producer, 80 with the gathering one); the others take one SM with 4
// stages (two accumulators and their epilogue's statistics would spill)
template <int BN, int NACC>
__host__ __device__ constexpr bool wg_pair() {
  return BN == 64 && NACC == 1;
}

template <int BN, int NACC>
__host__ __device__ constexpr int wg_stages() {
  return wg_pair<BN, NACC>() ? 3 : 4;
}

template <int BN, int NACC>
__host__ __device__ constexpr int wg_min_blocks() {
  return wg_pair<BN, NACC>() ? 2 : 1;
}

// the ring, then one staged tile [WG_BM][BN + 8] f32 (the accumulators go
// through it one at a time; the epilogue's sums reuse it once the tile is
// in registers), plus 1 KB to align the ring to the 1024 bytes of the
// swizzle pattern
template <int BN, int NACC>
constexpr size_t wg_smem_bytes() {
  return static_cast<size_t>(wg_stages<BN, NACC>()) * wg_stage_bytes<BN>() +
         sizeof(float) * WG_BM * (BN + 8) + 1024;
}

// A read by TMA: plain row-major bf16 rows [M, K] (the map is built on
// the host)
struct TmaA {
  typedef int Row;
  __device__ __forceinline__ const bf16* base() const { return nullptr; }
  __device__ __forceinline__ Row row(int r) const { return r; }
  __device__ __forceinline__ const bf16* src(Row, int, bool&) const {
    return nullptr;
  }
};

template <class L>
struct IsTma {
  static constexpr bool value = false;
};
template <>
struct IsTma<TmaA> {
  static constexpr bool value = true;
};

// 8 read-only floats through the non-coherent cache (the epilogues' scales
// and statistics: the compiler may share the load between the rows of a
// thread that read the same address)
__device__ __forceinline__ void ldg8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// -- barriers, TMA, `wgmma` ---------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(b))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` of barrier b has completed; a wait
// that lasts about 10 s (2^34 cycles) is a fault in the ring's order, so it
// traps (a launch error) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_addr(b);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > (1ll << 34))
      __trap();
  }
}

// this thread's shared-memory writes made visible to the async proxy
// (`wgmma` operand reads)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// the box at (c0 innermost, c1) of `map` into dst, its bytes counted on b
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* b, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(b)), "r"(c0),
      "r"(c1)
      : "memory");
}

// the consumers' own barrier (named barrier 1, 256 threads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// a `wgmma` descriptor of a 128-byte-swizzled operand at shared address a:
// lbo and sbo in bytes (K-major: sbo = 1024 between 8-row groups; N-major:
// lbo = the 64-column block stride, sbo = 1024 between 8-k-row groups)
__device__ __forceinline__ uint64_t wg_desc(uint32_t a, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous `wgmma`s
template <int R>
__device__ __forceinline__ void wg_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A.B over one k16 step, m64n64k16, bf16 operands from shared
// memory (A K-major, B N-major), f32 accumulators
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d += A.B over one k16 step, m64n128k16, bf16 operands from shared
// memory (A K-major, B N-major), f32 accumulators
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 64)
    wgmma_n64(d, da, db);
  else
    wgmma_n128(d, da, db);
}

// -- the kernel ---------------------------------------------------------------

// One k step of a consumer warpgroup (rows [64 cw, 64 cw + 64) of the
// tile) on stage st: four m64nBNk16 products
template <int BN>
__device__ __forceinline__ void wg_step(uint32_t st, int cw,
                                        float (&acc)[BN / 2]) {
  const uint32_t a = st + 8192 * cw, b = st + WG_A_BYTES;
#pragma unroll
  for (int kk = 0; kk < WG_BK / 16; ++kk)
    wgmma_bn<BN>(acc, wg_desc(a + 32 * kk, 16, 1024),
                 wg_desc(b + 2048 * kk, 8192, 1024));
}

// a consumer thread's accumulators (`wgmma`'s layout: warp w of the
// warpgroup holds rows 16 w + lane / 4 and + 8; value 4 j + 2 h + e is
// column 8 j + 2 (lane % 4) + e of row + 8 h) to rows of the staged tile
// [WG_BM][BN + 8]
template <int BN>
__device__ __forceinline__ void wg_stage_acc(float* tile,
                                             const float (&acc)[BN / 2],
                                             int ct) {
  const int lane = ct & 31, wr = (ct >> 5) & 3, cw = ct / 128;
  const int r0 = 64 * cw + 16 * wr + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (r0 + 8 * h) * (BN + 8) + 8 * j +
                                 c0) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// the block's producer threads
template <bool GATHER>
__host__ __device__ constexpr int wg_producers() {
  return GATHER ? 128 : 32;
}

// Tiles t = (M tile t / (N / BN), N tile t % (N / BN)), walked by a
// persistent grid. Product 0 is A0 (tmA0 or the gathered loader la) times
// the weight tmB0 over K0; with NACC = 2, product 1 is tmA1 times tmB1
// over K1 into the second accumulator. The maps' boxes: A 64 x 128 (k, m),
// B 64 x 64 (n, k), 128-byte swizzle.
template <int BN, int NACC, class LA, class EP>
__global__ void __launch_bounds__(
    WG_CONSUMERS + wg_producers<!IsTma<LA>::value>(),
    (wg_min_blocks<BN, NACC>()))
wg_gemm_kernel(const __grid_constant__ CUtensorMap tmA0,
               const __grid_constant__ CUtensorMap tmB0,
               const __grid_constant__ CUtensorMap tmA1,
               const __grid_constant__ CUtensorMap tmB1, LA la, EP ep,
               SegSums seg, int M, int N, int K0, int K1) {
  constexpr bool GATHER = !IsTma<LA>::value;
  static_assert(!GATHER || NACC == 1, "a gathered A runs one product");
  static_assert(NACC == 1 || BN == 64, "two accumulators take BN 64");
  constexpr int S = wg_stages<BN, NACC>();
  constexpr int LAG = S - 1;  // gathered steps a producer has in flight
  constexpr int STAGE = wg_stage_bytes<BN>();
  constexpr int NB = BN / 64;  // TMA boxes of B a stage
  __shared__ __align__(8) uint64_t full[S], empty[S];
  extern __shared__ __align__(16) unsigned char wg_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + WG_BM - 1) / WG_BM) * tiles_n;
  const int nk0 = (K0 + WG_BK - 1) / WG_BK;
  const int nk = nk0 + (NACC == 2 ? (K1 + WG_BK - 1) / WG_BK : 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], GATHER ? 1 + 128 : 1);
      mbar_init(&empty[s], WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WG_CONSUMERS) {
    // -- the producer ---------------------------------------------------------
    const int p = threadIdx.x - WG_CONSUMERS;
    if (p == 0) {
      if (!GATHER) tma_prefetch(&tmA0);
      tma_prefetch(&tmB0);
      if (NACC == 2) {
        tma_prefetch(&tmA1);
        tma_prefetch(&tmB1);
      }
    }
    const uint32_t tx0 = (GATHER ? 0 : WG_A_BYTES) + WG_BK * BN * 2;
    const uint32_t tx1 = WG_A_BYTES + WG_BK * BN * 2;
    typename LA::Row arow[8];
    int kt = 0;  // the ring's step, across tiles
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * WG_BM, n0 = t % tiles_n * BN;
      if constexpr (GATHER)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int m = m0 + p / 8 + 16 * i;
          if (m < M) arow[i] = la.row(m);
        }
      for (int j = 0; j < nk; ++j, ++kt) {
        const int s = kt % S;
        if constexpr (GATHER) {
          if (kt >= LAG) {  // the copies of step kt - LAG have landed
            cp_async_wait<LAG - 1>();
            fence_async_shared();
            mbar_arrive(&full[(kt - LAG) % S]);
          }
        }
        mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
        unsigned char* A = smem + s * STAGE;
        unsigned char* B = A + WG_A_BYTES;
        const bool first = j < nk0;
        const int k0 = (first ? j : j - nk0) * WG_BK;
        if (p == 0) {
          mbar_expect_tx(&full[s], first ? tx0 : tx1);
          if (!GATHER || !first)
            tma_load(A, first ? &tmA0 : &tmA1, &full[s], k0, m0);
#pragma unroll
          for (int h = 0; h < NB; ++h)
            tma_load(B + 8192 * h, first ? &tmB0 : &tmB1, &full[s],
                     n0 + 64 * h, k0);
        }
        if constexpr (GATHER) {
          // chunk c8 of rows p / 8 + 16 i: 8 of the stage's 1024
          const int c8 = p % 8, c = k0 + 8 * c8;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = p / 8 + 16 * i;
            bool ok = m0 + r < M && c < K0;
            const bf16* src = la.base();
            if (ok) src = la.src(arow[i], c, ok);
            cp_async16(A + r * 128 + ((c8 ^ (r & 7)) << 4),
                       ok ? src : la.base(), ok);
          }
          cp_async_commit();
        }
      }
    }
    if constexpr (GATHER) {
      cp_async_wait<0>();
      fence_async_shared();
      for (int j = kt > LAG ? kt - LAG : 0; j < kt; ++j)
        mbar_arrive(&full[j % S]);
    }
    return;
  }

  // -- the consumers ----------------------------------------------------------
  constexpr int NV = EP::NV;
  constexpr int CS_LDW = BN + 8;
  constexpr int HALVES = BN / WG_HALF;
  const int ct = threadIdx.x;  // 0..255
  const int cw = ct / 128;     // rows [64 cw, 64 cw + 64) of the tile
  const uint32_t ring = smem_addr(smem);
  // the staged tile [WG_BM][CS_LDW]; once it is in registers, the
  // epilogue's sums: per (warp, value, column) for a tile inside one
  // segment, per (row, column) of one value for a straddling tile
  float* cs = reinterpret_cast<float*>(smem + S * STAGE);
  float* red = cs;
  EP e = ep;  // an epilogue may keep what its rows share (mutable members)
  int kt = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int mt = t / tiles_n, m0 = mt * WG_BM, n0 = t % tiles_n * BN;
    float acc0[BN / 2], acc1[NACC == 2 ? BN / 2 : 1];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (NACC == 2 ? BN / 2 : 1); ++i) acc1[i] = 0.f;
    wg_fence_acc(acc0);
    wg_fence_acc(acc1);
    for (int j = 0; j < nk; ++j, ++kt) {
      const int s = kt % S;
      mbar_wait(&full[s], (kt / S) & 1);
      wg_fence();
      if constexpr (NACC == 2) {
        if (j < nk0)
          wg_step<BN>(ring + s * STAGE, cw, acc0);
        else
          wg_step<BN>(ring + s * STAGE, cw, acc1);
      } else {
        wg_step<BN>(ring + s * STAGE, cw, acc0);
      }
      wg_commit();
      wg_wait<1>();  // step kt - 1 has read its stage
      if (j > 0) mbar_arrive(&empty[(kt - 1) % S]);
    }
    wg_wait<0>();
    mbar_arrive(&empty[(kt - 1) % S]);  // the tile's last stage
    wg_fence_acc(acc0);
    wg_fence_acc(acc1);

    // the accumulators through shared memory into registers, one at a
    // time: 8 columns of 4 rows a thread (rows ct / 8 + 32 i, columns
    // (ct % 8) * 8 of each 64-column half), as tc_gemm.cuh's epilogue
    // takes them
    const int cg = (ct % 8) * 8;
    float v[NACC][HALVES][4][8];
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      consumers_sync();  // the tile (or accumulator) before is out of cs
      if (a == 0)
        wg_stage_acc<BN>(cs, acc0, ct);
      else if constexpr (NACC == 2)
        wg_stage_acc<BN>(cs, acc1, ct);
      consumers_sync();
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* src =
              cs + (ct / 8 + 32 * i) * CS_LDW + WG_HALF * hf + cg;
          const float4 x = *reinterpret_cast<const float4*>(src);
          const float4 y = *reinterpret_cast<const float4*>(src + 4);
          v[a][hf][i][0] = x.x; v[a][hf][i][1] = x.y;
          v[a][hf][i][2] = x.z; v[a][hf][i][3] = x.w;
          v[a][hf][i][4] = y.x; v[a][hf][i][5] = y.y;
          v[a][hf][i][6] = y.z; v[a][hf][i][7] = y.w;
        }
    }
    if (NV > 0) consumers_sync();  // cs becomes red
    const int nrows = M - m0 < WG_BM ? M - m0 : WG_BM;
    // a tile inside one ghost segment sums in registers and across the
    // warp (the lanes l ^ 8, l ^ 16 hold the same columns), then the 8
    // warps' partials in warp order
    const bool one_seg = NV > 0 && m0 / seg.L == (m0 + nrows - 1) / seg.L;
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) {
      const int col = n0 + WG_HALF * hf + cg;
      typename EP::Row rows[4];
      typename EP::In in[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + ct / 8 + 32 * i;
        if (m < M && col < N) {
          rows[i] = e.row(m);
          e.load(rows[i], col, in[i]);
        }
      }
      float s[4][NV > 0 ? 8 * NV : 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int u = 0; u < (NV > 0 ? 8 * NV : 1); ++u) s[i][u] = 0.f;
        if (m0 + ct / 8 + 32 * i >= M || col >= N) continue;
        if constexpr (NACC == 2)
          e(rows[i], col, v[0][hf][i], v[1][hf][i], in[i], s[i]);
        else
          e(0, rows[i], col, v[0][hf][i], in[i], s[i]);
      }
      if constexpr (NV > 0) {
        if (one_seg) {
          float ts[8 * NV];
#pragma unroll
          for (int u = 0; u < 8 * NV; ++u) {
            ts[u] = (s[0][u] + s[1][u]) + (s[2][u] + s[3][u]);
            ts[u] += __shfl_xor_sync(0xffffffffu, ts[u], 8);
            ts[u] += __shfl_xor_sync(0xffffffffu, ts[u], 16);
          }
          const int warp = ct >> 5;
          if ((ct & 31) < 8)
#pragma unroll
            for (int u = 0; u < 8 * NV; ++u)  // [warp][value][column]
              red[(warp * NV + u / 8) * WG_HALF + cg + u % 8] = ts[u];
          consumers_sync();
          for (int u = ct; u < NV * WG_HALF; u += WG_CONSUMERS) {
            const int vi = u / WG_HALF, c = u % WG_HALF;
            const int n = n0 + WG_HALF * hf + c;
            if (n >= N) continue;
            float a = 0.f;
#pragma unroll
            for (int w = 0; w < 8; ++w) a += red[(w * NV + vi) * WG_HALF + c];
            seg.part[(mt * seg.R * NV + vi) * N + n] = a;
          }
          consumers_sync();  // red is written again
        } else {
          // one value at a time: its rows through red, each column cut at
          // the segment ends and each piece summed in a fixed order (eight
          // interleaved partial sums, then their pairwise sum)
#pragma unroll
          for (int vi = 0; vi < NV; ++vi) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int e = 0; e < 8; ++e)
                red[(ct / 8 + 32 * i) * WG_RED_LD + cg + e] = s[i][8 * vi + e];
            consumers_sync();
            if (ct < WG_HALF && n0 + WG_HALF * hf + ct < N) {
              const int n = n0 + WG_HALF * hf + ct;
              const float* colv = red + ct;
              int slot = 0, next = (m0 / seg.L + 1) * seg.L - m0;
              for (int lo = 0; lo < nrows; lo = next, next += seg.L, ++slot) {
                const int hi = next < nrows ? next : nrows;
                float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
                int r = lo;
                for (; r + 8 <= hi; r += 8)
#pragma unroll
                  for (int e = 0; e < 8; ++e) a[e] += colv[(r + e) * WG_RED_LD];
                for (; r < hi; ++r) a[0] += colv[r * WG_RED_LD];
                seg.part[((mt * seg.R + slot) * NV + vi) * N + n] =
                    ((a[0] + a[1]) + (a[2] + a[3])) +
                    ((a[4] + a[5]) + (a[6] + a[7]));
              }
            }
            consumers_sync();  // red is written again
          }
        }
      }
    }
  }
}

// -- host side ----------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no
// -lcuda)
EncodeTiledFn encode_tiled() {
  static std::atomic<EncodeTiledFn> fn{nullptr};
  EncodeTiledFn f = fn.load(std::memory_order_acquire);
  if (f != nullptr) return f;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                       cudaEnableDefault, &q) !=
          cudaSuccess ||
      q != cudaDriverEntryPointSuccess)
    return nullptr;
  f = reinterpret_cast<EncodeTiledFn>(p);
  fn.store(f, std::memory_order_release);
  return f;
}

// a map of the bf16 matrix [rows, cols] (row stride ld elements) whose
// box is box_cols x box_rows, 128-byte swizzled, zero past the edges.
// Encoding is a host call at every launch, and the weights and the
// workspace mostly stay where they were, so each host thread keeps the
// last 128 maps it encoded (a map is a function of its key alone).
cudaError_t tma_map(CUtensorMap* map, const bf16* p, int rows, int cols,
                    int ld, int box_cols, int box_rows) {
  struct Entry {
    const bf16* p;
    int rows, cols, ld, bc, br;
    CUtensorMap map;
  };
  constexpr int SLOTS = 128;
  thread_local Entry cache[SLOTS] = {};
  thread_local int next = 0;
  for (const Entry& e : cache)
    if (e.p == p && e.rows == rows && e.cols == cols && e.ld == ld &&
        e.bc == box_cols && e.br == box_rows && p != nullptr) {
      *map = e.map;
      return cudaSuccess;
    }
  const EncodeTiledFn f = encode_tiled();
  if (f == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r = f(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                       const_cast<bf16*>(p), dims, strides, box, one,
                       CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  cache[next] = Entry{p, rows, cols, ld, box_cols, box_rows, *map};
  next = (next + 1) % SLOTS;
  return cudaSuccess;
}

// a plain operand A [M, K] (row stride ld), or a weight B [K, N]
struct Plain {
  const bf16* p;
  int rows, cols, ld;
};

cudaError_t map_a(CUtensorMap* m, const Plain& a) {
  return tma_map(m, a.p, a.rows, a.cols, a.ld, WG_BK, WG_BM);
}

cudaError_t map_b(CUtensorMap* m, const Plain& b) {
  return tma_map(m, b.p, b.rows, b.cols, b.ld, 64, WG_BK);
}

// SMs of the current device, read once per device
inline int sm_count() {
  static std::atomic<int> counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 132;
  int n = counts[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      n = 132;
    counts[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// The N tile of a product with a gathered A: 64 where N is at most 64,
// else whichever of 64 (two blocks an SM) and 128 (one) leaves fewer block
// slots idle in the last round of tiles, 128 on a tie or within 10%, since
// it gathers each A tile half as often. A product whose A comes by TMA
// takes 64.
inline int wg_pick_bn(int M, int N) {
  if (N <= 64) return 64;
  const int sms = sm_count();
  auto fill = [&](int bn, int slots) {
    const int64_t tiles = static_cast<int64_t>((M + WG_BM - 1) / WG_BM) *
                          ((N + bn - 1) / bn);
    const int64_t rounds = (tiles + slots - 1) / slots;
    return static_cast<double>(tiles) / static_cast<double>(rounds * slots);
  };
  return fill(64, 2 * sms) > 1.1 * fill(128, sms) ? 64 : 128;
}

// a persistent grid: one block per tile up to the blocks that fit the card
template <int BN, int NACC, class LA, class EP>
cudaError_t wg_launch(const CUtensorMap& a0, const CUtensorMap& b0,
                      const CUtensorMap& a1, const CUtensorMap& b1,
                      const LA& la, const EP& ep, const SegSums& seg, int M,
                      int N, int K0, int K1, cudaStream_t st) {
  constexpr size_t smem = wg_smem_bytes<BN, NACC>();
  static std::atomic<uint64_t> done{0};
  const cudaError_t e =
      allow_smem(done, wg_gemm_kernel<BN, NACC, LA, EP>, smem);
  if (e != cudaSuccess) return e;
  const int64_t tiles = static_cast<int64_t>((M + WG_BM - 1) / WG_BM) *
                        ((N + BN - 1) / BN);
  const int64_t slots =
      static_cast<int64_t>(sm_count()) * wg_min_blocks<BN, NACC>();
  constexpr int threads = WG_CONSUMERS + wg_producers<!IsTma<LA>::value>();
  wg_gemm_kernel<BN, NACC, LA, EP>
      <<<static_cast<unsigned>(tiles < slots ? tiles : slots), threads, smem,
         st>>>(a0, b0, a1, b1, la, ep, seg, M, N, K0, K1);
  return cudaGetLastError();
}

// C[M, N] = A.w over K through ep: A a gathered loader over [M, K], w a
// weight [K, N]
template <class LA, class EP>
cudaError_t wg_gemm_gather(const LA& la, const Plain& w, const EP& ep,
                           int M, int N, int K, cudaStream_t st,
                           SegSums seg = SegSums{nullptr, 1, 1}) {
  CUtensorMap b;
  cudaError_t e = map_b(&b, w);
  if (e != cudaSuccess) return e;
  return wg_pick_bn(M, N) == 64
             ? wg_launch<64, 1>(b, b, b, b, la, ep, seg, M, N, K, 0, st)
             : wg_launch<128, 1>(b, b, b, b, la, ep, seg, M, N, K, 0, st);
}

// the same with a plain A [M, K] by TMA, at BN 64
template <class EP>
cudaError_t wg_gemm(const Plain& a, const Plain& w, const EP& ep, int M,
                    int N, int K, cudaStream_t st,
                    SegSums seg = SegSums{nullptr, 1, 1}) {
  CUtensorMap am, b;
  cudaError_t e = map_a(&am, a);
  if (e == cudaSuccess) e = map_b(&b, w);
  if (e != cudaSuccess) return e;
  return wg_launch<64, 1>(am, b, am, b, TmaA{}, ep, seg, M, N, K, 0, st);
}

// two products into two accumulators of each tile: a0.w0 over K0 and
// a1.w1 over K1, both [M, N], at BN 64 as every product with a TMA A (so
// each accumulator equals that single product's, bit for bit)
template <class EP>
cudaError_t wg_gemm2(const Plain& a0, const Plain& w0, const Plain& a1,
                     const Plain& w1, const EP& ep, int M, int N, int K0,
                     int K1, cudaStream_t st) {
  CUtensorMap ma0, mb0, ma1, mb1;
  cudaError_t e = map_a(&ma0, a0);
  if (e == cudaSuccess) e = map_b(&mb0, w0);
  if (e == cudaSuccess) e = map_a(&ma1, a1);
  if (e == cudaSuccess) e = map_b(&mb1, w1);
  if (e != cudaSuccess) return e;
  return wg_launch<64, 2>(ma0, mb0, ma1, mb1, TmaA{}, ep,
                          SegSums{nullptr, 1, 1}, M, N, K0, K1, st);
}

}  // namespace
