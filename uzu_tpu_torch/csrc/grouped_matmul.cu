// Grouped (ragged) expert matmul for MoE: over INT4 expert stacks with
// in-kernel dequantization (K9) and over dense bf16 / f32 stacks (K10).
//
//   out[r, n] = sum_k x[r, k] * W[tile_expert[r / bm]][n, k]   for r < bm * used[0]
//
// Replaces the TPU kernels uzu_tpu/ops/pallas/grouped_matmul.py::_q_kernel
// (K9, launched by _grouped_matmul_q_p) and ::_kernel (K10, launched by
// grouped_matmul). x is the expert-sorted, tile-padded activation buffer
// [Tp, K] (bf16 or f32) that route_layout describes: every bm-row tile
// belongs to one expert, tile_expert[Tp / bm] (int32) names it, and
// used[0] (int32, read on the device) counts the tiles in use. Tiles at or
// past used[0] return at once and leave their output rows unwritten: the
// caller reads back only real rows. K9's stack is symmetric INT4: codes u8
// [E, N, K/2] packed like quant_matmul.cu's, scales [E, N, ceil(K/g)] bf16
// or f32, w = scale * code + coeff * scale. K10's stack is [E, N, K] bf16
// or f32. out is f32 [Tp, N]. An expert id outside [0, E) is clamped into
// it.
//
// Numerical contract: x and the (dequantized) weight enter the tensor
// cores as bf16 (f32 x is rounded as it is loaded; with bf16 scales an
// INT4 weight is one bf16x2 FMA, rounded once), products accumulate in f32
// in a fixed order with no atomics, so the result repeats run to run.
//
// The wrapper's launch plan (ops/cuda/grouped_matmul.py::grouped_plan,
// shapes and the SM count only) picks the route, bm and the block
// geometry; the kernels take them as arguments.
//
// What bounds it on the H100. At the paged decode step (8 slots x 4
// experts = 32 routed rows, ~21 distinct experts of 32) and in prefill
// chunks up to 256 rows each routed expert holds few rows, and the time is
// reading each routed expert's plane once (gpt-oss's up plane: 9.3 MB of
// INT4 codes and scales, 33 MB in bf16). Only K10's 1024-row chunks (~128
// rows an expert) come near the tensor cores' share.
//
// Small route (K9, bm = 8, 16 or 32; the plan takes it for chunks of S <=
// 32 rows, where an expert holds at most S rows, so each routed expert
// owns exactly one tile): grouped_small, qmm_small.cuh's swapped mma.sync
// product on the tile's expert plane. The weights are the A operand,
// dequantized in registers from 16-byte code loads, and the tile's bm rows
// of x are bm / 8 n8 operands, so each routed plane is read once and only
// the tile's rows are multiplied. Each (tile, 16 * 8 / kw weight rows)
// item is one block's pass; a block walks a contiguous range of items, so
// it stages a tile's rows of x once in shared memory, as bf16 in the
// fragment's k order, for all of that tile's items (f32 x re-read by every
// warp was 4x the bytes of the codes, and held 32 registers); a K whose
// staged x would not fit in shared memory takes the tile route (the
// plan's bm 64). kw depends on K only and the kw warps sum in warp order,
// so a row's output does not depend on the other rows of its tile.
//
// Tile route (bm = 64, the JAX package's _GROUPED_BM): one warpgroup per
// (64-row tile, BN weight rows), wgmma m64nBNk16 on a ring of 64-wide K
// chunks. grouped_tile_q (K9) brings x (f32 rows raw, bf16 rows straight
// into wgmma's swizzle) and the raw codes with each row's window of group
// scales by cp.async (S = 3 stages), and the block's threads dequantize
// each chunk once into a swizzled W tile (and round f32 x into a swizzled
// bf16 tile) while the previous chunk's products run. grouped_tile_dense
// (K10, bf16 x and stack) has no dequantization at all: TMA brings the x
// box and the W box (row e * N + n0 of the [E * N, K] plane stack) straight
// into the swizzle wgmma reads, on a 4-stage mbarrier ring whose stages
// are refilled once the products of the chunk before have retired. A
// 64-row tile needs one warpgroup's registers (BN / 2 accumulators a
// thread), so two or more blocks share an SM and their chains overlap,
// where qmm_tile's 256-row blocks run one to an SM. The m-tile is the
// fastest grid dimension: the blocks of one N-slice run side by side, so
// the tiles that share an expert (adjacent in the sorted layout) read its
// N-slice at the same time, through L2 once, and the unused tail tiles
// exit together. On the H100 grouped_tile_q still spends ~1.4 us per
// chunk and block (PERF.md section 6), as qmm_tile does.
//
// mma route (K10 with an f32 stack or f32 rows, which no main path
// launches): the 64x64 mma.sync tile of quant_tiles.cuh per 64-row tile
// and 64 weight rows, x and W staged through shared memory as bf16.
//
// Not carried over from the TPU kernels: the scalar-prefetch grid, the
// clamped weight index of unused tail tiles (here they return before any
// load), the flattened [E*N, ...] 2D views of the codes and scales, the
// even/odd deinterleave of x, the 0/1 expansion-matrix dot for the scales,
// and the Mosaic block rules.

#include "qmm_small.cuh"

namespace {

using namespace uzq;

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// Small route (K9): grouped_small.

// The used tiles' (tile, row block) items, tile-major, dealt to the blocks
// in contiguous ranges, so a block walks one tile's weight rows after
// another. Each tile's rows of x are staged once as bf16 in the fragment
// order (stage_x, dynamic shared memory) for all its row blocks.
template <typename XT, typename ST, int NT>
__global__ void __launch_bounds__(SM_WARPS * 32)
grouped_small(const XT* __restrict__ x, const int* __restrict__ tile_expert,
              const int* __restrict__ used, const uint8_t* __restrict__ codes,
              const ST* __restrict__ scales, float coeff, float* __restrict__ out, int N,
              int K, int G, int E, int vec16, int kw) {
  constexpr int BM = 8 * NT;
  extern __shared__ uint4 staged[];
  const int ld = staged_ld(K);
  const int row_blocks = ((N + 15) / 16 + SM_WARPS / kw - 1) / (SM_WARPS / kw);
  const int items = used[0] * row_blocks;
  const int per = (items + gridDim.x - 1) / gridDim.x;
  const int last = min(items, (blockIdx.x + 1) * per);
  const int row_bytes = K / 2;
  const int SK = (K + G - 1) / G;
  int staged_tile = -1;
  for (int item = blockIdx.x * per; item < last; ++item) {
    const int tile = item / row_blocks;
    const int e = min(max(tile_expert[tile], 0), E - 1);
    const XT* xt = x + static_cast<size_t>(tile) * BM * K;
    const uint8_t* cplane = codes + static_cast<size_t>(e) * N * row_bytes;
    const ST* splane = scales + static_cast<size_t>(e) * N * SK;
    float* ot = out + static_cast<size_t>(tile) * BM * N;
    if (tile != staged_tile) {  // the previous item's barrier freed the stage
      stage_x(staged, ld, xt, BM, K);
      __syncthreads();
      staged_tile = tile;
    }
    small_rows<4, ST, NT>(XStaged{staged, ld}, cplane, splane, nullptr, coeff, ot, BM, N, K, G,
                          SK, vec16, kw, item % row_blocks);
    __syncthreads();  // the kw reduction's and the stage's shared memory are reused next
  }
}

// ---------------------------------------------------------------------------
// Tile route: 64-row tiles on wgmma.

constexpr int GT_M = 64;        // rows per tile
constexpr int GT_BK = 64;       // k per chunk: one 128-byte swizzled row of bf16
constexpr int GT_THREADS = 128;  // one warpgroup
constexpr int X_TILE = GT_M * 128;  // a swizzled bf16 chunk of x

// K9's shared memory: per stage the raw x chunk (f32) or its swizzled bf16
// tile, the raw codes and the group windows; two dequantized W tiles, and
// for f32 x two converted x tiles.
template <typename XT, int BN, int S>
struct QTileGeo {
  static constexpr bool XF = sizeof(XT) == 4;
  static constexpr int X_STAGE = GT_M * GT_BK * static_cast<int>(sizeof(XT));
  static constexpr int C_STAGE = BN * 32;          // 32 code bytes of a row per chunk
  static constexpr int UPT = BN * 2 / GT_THREADS;  // 16-byte code units per thread
  static constexpr int G_SLOT = 8;                 // a row's group window: 2 words
  static constexpr int G_STAGE = BN * G_SLOT;
  static constexpr int W_TILE = BN * 128;
  static constexpr int W_OFF = S * X_STAGE;
  static constexpr int XB_OFF = W_OFF + 2 * W_TILE;
  static constexpr int C_OFF = XB_OFF + (XF ? 2 * X_TILE : 0);
  static constexpr int G_OFF = C_OFF + S * C_STAGE;
  static constexpr int BYTES = G_OFF + S * G_STAGE;
  static constexpr int LAUNCH_BYTES = BYTES + 1024;  // room to align the base to 1024
};

// Write the accumulators of a 64 x BN tile at (m_base, n_base) of out [*, N]:
// warp w of the warpgroup holds rows 16 w + gid (+ 8), n8 block j columns
// 8 j + 2 tig (+ 1).
template <int BN>
__device__ __forceinline__ void store_acc(float* __restrict__ out, const float (&acc)[BN / 2],
                                          int m_base, int n_base, int N) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wrow = (tid >> 5) * 16 + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* orow = out + static_cast<size_t>(m_base + wrow + 8 * h) * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n_base + 8 * j + col_t;
      const float v0 = acc[4 * j + 2 * h];
      const float v1 = acc[4 * j + 2 * h + 1];
      if (pairs && n + 1 < N) {
        *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
      } else {
        if (n < N) orow[n] = v0;
        if (n + 1 < N) orow[n + 1] = v1;
      }
    }
  }
}

template <typename XT, typename ST, int BN, int S>
__global__ void __launch_bounds__(GT_THREADS)
grouped_tile_q(const XT* __restrict__ x, const int* __restrict__ tile_expert,
               const int* __restrict__ used, const uint8_t* __restrict__ codes,
               const ST* __restrict__ scales, float coeff, float* __restrict__ out, int N, int K,
               int G, int E, int vec16) {
  using L = QTileGeo<XT, BN, S>;
  constexpr int ES = static_cast<int>(sizeof(ST));
  const int mt = blockIdx.x;
  if (mt >= used[0]) return;
  const int e = min(max(tile_expert[mt], 0), E - 1);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);
  const int tid = threadIdx.x;
  const int n_base = blockIdx.y * BN;
  const int nk = (K + GT_BK - 1) / GT_BK;
  const int row_bytes = K / 2;
  const int SK = (K + G - 1) / G;
  const int glast = SK - 1;
  const XT* xt = x + static_cast<size_t>(mt) * GT_M * K;
  const uint8_t* cplane = codes + static_cast<size_t>(e) * N * row_bytes;
  const ST* splane = scales + static_cast<size_t>(e) * N * SK;
  // With G % 32 == 0 a 64-wide chunk touches at most 2 groups of a row, and
  // the 2 words from the one holding the first lie in the ring beside the
  // codes; other group sizes read each word's group from global memory.
  const bool ring_groups = G % 32 == 0;
  const size_t g_bytes = static_cast<size_t>(E) * N * SK * ES;

  auto load_stage = [&](int chunk, int stage) {
    const int k0 = chunk * GT_BK;
    const uint32_t xs = sbase + stage * L::X_STAGE;
    if constexpr (L::XF) {  // 64 rows x 16 units of 4 f32, raw
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = tid + j * GT_THREADS;
        const int r = i >> 4;
        const int k = k0 + 4 * (i & 15);
        cp_async16(xs + r * 256 + (i & 15) * 16, xt + static_cast<size_t>(r) * K + (k < K ? k : 0),
                   k < K ? 16 : 0);
      }
    } else {  // 64 rows x 8 units of 8 bf16, into wgmma's swizzle
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = tid + j * GT_THREADS;
        const int r = i >> 3;
        const int k = k0 + 8 * (i & 7);
        cp_async16(xs + swz(r, i & 7), xt + static_cast<size_t>(r) * K + (k < K ? k : 0),
                   k < K ? 16 : 0);
      }
    }
    // codes: BN rows x 2 units of 16 bytes, as 4-byte words where a row's
    // units are not 16-byte aligned (one flat loop: ptxas crashes on nested
    // word loops here)
    const uint32_t cs = sbase + L::C_OFF + stage * L::C_STAGE;
#pragma unroll
    for (int v = 0; v < L::UPT * 4; ++v) {
      const int i = tid + (v >> 2) * GT_THREADS;
      const int w = v & 3;
      const int r = i >> 1;
      const int off = k0 / 2 + (i & 1) * 16;
      const int left = n_base + r < N ? max(0, min(16, row_bytes - off)) : 0;
      const uint8_t* src =
          cplane + (left > 0 ? static_cast<size_t>(n_base + r) * row_bytes + off : 0);
      if (!vec16) {
        cp_async4(cs + i * 16 + 4 * w, src + 4 * w, 4 * w < left);
      } else if (w == 0) {
        cp_async16(cs + i * 16, src, left);
      }
    }
    if (ring_groups) {
      const int g0 = k0 / G;
      for (int i = tid; i < BN * 2; i += GT_THREADS) {
        const int r = i % BN;
        const int n = n_base + r;
        const size_t word = ((static_cast<size_t>(e) * N + n) * SK + g0) * ES / 4 + i / BN;
        const bool ok = n < N && word * 4 < g_bytes;
        cp_async4(sbase + L::G_OFF + stage * L::G_STAGE + r * L::G_SLOT + 4 * (i / BN),
                  reinterpret_cast<const uint8_t*>(scales) + (ok ? word * 4 : 0), ok);
      }
    }
  };

  // dequantize the chunk in `stage` into W buffer `wb` (and round f32 x
  // into x buffer `wb`)
  auto dequant = [&](int chunk, int stage, int wb) {
    const int k0 = chunk * GT_BK;
    const int g0 = k0 / G;
    const uint8_t* cs = base + L::C_OFF + stage * L::C_STAGE;
    uint8_t* wt = base + L::W_OFF + wb * L::W_TILE;
#pragma unroll
    for (int v = 0; v < L::UPT * 4; ++v) {  // a word: 8 k, one 16-byte swizzle chunk
      const int i = tid + (v >> 2) * GT_THREADS;
      const int q = v & 3;
      const int r = i >> 1;
      const int u = i & 1;
      const int n = n_base + r;
      const int k = k0 + 32 * u + 8 * q;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(cs + i * 16 + 4 * q);
      Group<ST> g;
      if (ring_groups) {
        const int lead = static_cast<int>(((static_cast<size_t>(e) * N + n) * SK + g0) * ES & 3);
        const int at = stage * L::G_STAGE + r * L::G_SLOT + lead + (min(k / G, glast) - g0) * ES;
        g.set(*reinterpret_cast<const ST*>(base + L::G_OFF + at), ST(0.f), false, coeff);
      } else {
        ST sv, bv;
        raw_group<ST>(splane, nullptr, n, n < N, SK, k, G, glast, sv, bv);
        g.set(sv, bv, false, coeff);
      }
      *reinterpret_cast<uint4*>(wt + swz(r, u * 4 + q)) = int4_k_order(w, g);
    }
    if constexpr (L::XF) {
      const uint8_t* xr = base + stage * L::X_STAGE;
      uint8_t* xb = base + L::XB_OFF + wb * X_TILE;
      // kept rolled: ptxas (CUDA 12.8) crashes on this loop unrolled
#pragma unroll 1
      for (int j = 0; j < 4; ++j) {  // 64 rows x 8 chunks of 8 k
        const int i = tid + j * GT_THREADS;
        const int r = i >> 3;
        const int c = i & 7;
        const float4* p = reinterpret_cast<const float4*>(xr + r * 256 + c * 32);
        const float4 a = p[0], b = p[1];
        *reinterpret_cast<uint4*>(xb + swz(r, c)) =
            make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                       pack_bf16x2(b.z, b.w));
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  // Chunk it is dequantized while chunk it - 1's products run on the
  // tensor cores; its stage is refilled once those products are done.
  for (int it = 0; it < nk; ++it) {
    const int stage = it % S;
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk it's copies have landed, every thread's
    dequant(it, stage, it & 1);
    fence_async_smem();
    wg_wait0();       // chunk it - 1's products
    __syncthreads();  // chunk it's tiles written; chunk it - 1's buffers free
    if (it + S - 1 < nk) load_stage(it + S - 1, (it + S - 1) % S);
    cp_async_commit();
    wg_fence();
    const uint32_t xs = L::XF ? sbase + L::XB_OFF + (it & 1) * X_TILE : sbase + stage * L::X_STAGE;
    const uint32_t ws = sbase + L::W_OFF + (it & 1) * L::W_TILE;
#pragma unroll
    for (int kk = 0; kk < GT_BK / 16; ++kk) {
      wgmma_ss(acc, sw128_desc(xs + kk * 32), sw128_desc(ws + kk * 32));
    }
    wg_commit();
  }
  wg_wait0();
  fence_regs(acc);
  store_acc<BN>(out, acc, mt * GT_M, n_base, N);
}

// K10's shared memory: per stage the x box and the W box, both in wgmma's
// swizzle, and an mbarrier.
template <int BN, int S>
struct DTileGeo {
  static constexpr int W_STAGE = BN * 128;
  static constexpr int STAGE = X_TILE + W_STAGE;
  static constexpr int BAR_OFF = S * STAGE;
  static constexpr int BYTES = BAR_OFF + S * 8;
  static constexpr int LAUNCH_BYTES = BYTES + 1024;
};

template <int BN, int S>
__global__ void __launch_bounds__(GT_THREADS)
grouped_tile_dense(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, const int* __restrict__ tile_expert,
                   const int* __restrict__ used, float* __restrict__ out, int N, int K, int E) {
  using L = DTileGeo<BN, S>;
  const int mt = blockIdx.x;
  if (mt >= used[0]) return;
  const int e = min(max(tile_expert[mt], 0), E - 1);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);
  const int tid = threadIdx.x;
  const int n_base = blockIdx.y * BN;
  const int nk = (K + GT_BK - 1) / GT_BK;

  auto load = [&](int chunk, int stage) {  // one thread: x and W boxes of a chunk
    const uint32_t bar = sbase + L::BAR_OFF + 8 * stage;
    const uint32_t dst = sbase + stage * L::STAGE;
    mbar_expect_tx(bar, L::STAGE);
    tma_load_2d(dst, &xmap, bar, chunk * GT_BK, mt * GT_M);
    tma_load_2d(dst + X_TILE, &wmap, bar, chunk * GT_BK, e * N + n_base);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(sbase + L::BAR_OFF + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < S && s < nk; ++s) load(s, s);
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int stage = it % S;
    mbar_wait(sbase + L::BAR_OFF + 8 * stage, (it / S) & 1);
    wg_fence();
    const uint32_t xs = sbase + stage * L::STAGE;
#pragma unroll
    for (int kk = 0; kk < GT_BK / 16; ++kk) {
      wgmma_ss(acc, sw128_desc(xs + kk * 32), sw128_desc(xs + X_TILE + kk * 32));
    }
    wg_commit();
    wg_wait0();
    __syncthreads();  // every warp's products of chunk it are done: refill its stage
    if (tid == 0 && it + S < nk) load(it + S, stage);
  }
  fence_regs(acc);
  store_acc<BN>(out, acc, mt * GT_M, n_base, N);
}

// ---------------------------------------------------------------------------
// mma route (K10, f32 stack or f32 rows): the 64x64 mma.sync tile.

template <typename XT, typename WT>
__global__ void __launch_bounds__(MM_THREADS)
grouped_mma(const XT* __restrict__ x, const int* __restrict__ tile_expert,
            const int* __restrict__ used, const WT* __restrict__ w, float* __restrict__ out,
            int Tp, int N, int K, int E) {
  const int mt = blockIdx.y;
  if (mt >= used[0]) return;
  const int e = min(max(tile_expert[mt], 0), E - 1);
  const WT* plane = w + static_cast<size_t>(e) * N * K;
  __shared__ __align__(16) Tile xs;
  __shared__ __align__(16) Tile ws;
  const int tid = threadIdx.x;
  const TileCoord t(tid);
  const int m_base = mt * MM_M;
  const int n_base = blockIdx.x * MM_N;
  float acc[2][4][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < K; k0 += MM_K) {
    stage_dense<XT>(xs, x, m_base, Tp, K, k0, tid);
    stage_dense<WT>(ws, plane, n_base, N, K, k0, tid);
    __syncthreads();
    mma_chunk(xs, ws, t, acc);
    __syncthreads();
  }
  store_tile(out, acc, t, m_base, n_base, Tp, N);
}

// ---------------------------------------------------------------------------
// Launchers

struct QArgs {
  const void* x;
  const int* tile_expert;
  const int* used;
  const uint8_t* codes;
  const void* scales;
  float coeff;
  float* out;
  int Tp, N, K, G, E, vec16;
};

template <typename XT, typename ST, int NT>
int launch_small(const QArgs& a, int kw, int blocks, cudaStream_t s) {
  const int smem = 8 * NT * staged_ld(a.K) * 16;
  static int limit[MAX_DEVICES] = {};
  const cudaError_t e = allow_smem(grouped_small<XT, ST, NT>, smem, limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  grouped_small<XT, ST, NT><<<blocks, SM_WARPS * 32, smem, s>>>(
      static_cast<const XT*>(a.x), a.tile_expert, a.used, a.codes,
      static_cast<const ST*>(a.scales), a.coeff, a.out, a.N, a.K, a.G, a.E, a.vec16, kw);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename ST>
int run_small(const QArgs& a, int bm, int kw, int blocks, cudaStream_t s) {
  if (bm == 8) return launch_small<XT, ST, 1>(a, kw, blocks, s);
  if (bm == 16) return launch_small<XT, ST, 2>(a, kw, blocks, s);
  if (bm == 32) return launch_small<XT, ST, 4>(a, kw, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename XT, typename ST, int BN>
int launch_tile_q(const QArgs& a, cudaStream_t s) {
  constexpr int S = 3;
  constexpr int smem = QTileGeo<XT, BN, S>::LAUNCH_BYTES;
  static int limit[MAX_DEVICES] = {};
  const cudaError_t e = allow_smem(grouped_tile_q<XT, ST, BN, S>, smem, limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.Tp / GT_M, (a.N + BN - 1) / BN);
  grouped_tile_q<XT, ST, BN, S><<<grid, GT_THREADS, smem, s>>>(
      static_cast<const XT*>(a.x), a.tile_expert, a.used, a.codes,
      static_cast<const ST*>(a.scales), a.coeff, a.out, a.N, a.K, a.G, a.E, a.vec16);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename ST>
int run_q(const QArgs& a, int route, int bm, int p0, int p1, cudaStream_t s) {
  if (route == 0) {  // small: p0 = kw, p1 = blocks
    if (p0 < 1 || p0 > SM_WARPS || SM_WARPS % p0 || p1 < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return run_small<XT, ST>(a, bm, p0, p1, s);
  } else if (route == 1 && bm == GT_M) {  // tile: p0 = BN
    if (p0 == 64) return launch_tile_q<XT, ST, 64>(a, s);
    if (p0 == 128) return launch_tile_q<XT, ST, 128>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int BN>
int launch_tile_dense(const void* x, const int* te, const int* used, const void* w, float* out,
                      int Tp, int N, int K, int E, cudaStream_t s) {
  constexpr int S = 4;
  constexpr int smem = DTileGeo<BN, S>::LAUNCH_BYTES;
  static int limit[MAX_DEVICES] = {};
  cudaError_t e = allow_smem(grouped_tile_dense<BN, S>, smem, limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap xmap, wmap;
  e = bf16_tensor_map(&xmap, x, Tp, K, GT_M);
  if (e == cudaSuccess) e = bf16_tensor_map(&wmap, w, static_cast<long long>(E) * N, K, BN);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(Tp / GT_M, (N + BN - 1) / BN);
  grouped_tile_dense<BN, S><<<grid, GT_THREADS, smem, s>>>(xmap, wmap, te, used, out, N, K, E);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename WT>
int launch_mma(const void* x, const int* te, const int* used, const void* w, float* out, int Tp,
               int N, int K, int E, cudaStream_t s) {
  const dim3 grid((N + MM_N - 1) / MM_N, Tp / MM_M);
  grouped_mma<XT, WT><<<grid, MM_THREADS, 0, s>>>(static_cast<const XT*>(x), te, used,
                                                  static_cast<const WT*>(w), out, Tp, N, K, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. The caller guarantees: Tp a
// multiple of bm, K % 8 == 0, G % 8 == 0, every pointer contiguous and
// 16-byte aligned. route, bm and p0 are the wrapper's plan. Each returns
// cudaGetLastError() after the launch.

// K9: INT4 symmetric expert stack. route 0: grouped_small (bm 8, 16 or 32,
// p0 = kw, p1 = blocks; x staged in bm * 16 * staged_ld(K) bytes of shared
// memory, which must fit the card's limit per block); route 1:
// grouped_tile_q (bm 64, p0 = BN of 64 or 128).
// vec16: the codes' rows are a multiple of 16 bytes.
extern "C" int uz_grouped_matmul_q(const void* x, int x_bf16, const void* tile_expert,
                                   const void* used, const void* codes, const void* scales,
                                   int s_bf16, float coeff, void* out, int Tp, int N, int K,
                                   int G, int E, int vec16, int route, int bm, int p0, int p1,
                                   void* stream) {
  const QArgs a{x, static_cast<const int*>(tile_expert), static_cast<const int*>(used),
                static_cast<const uint8_t*>(codes), scales, coeff, static_cast<float*>(out),
                Tp, N, K, G, E, vec16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return s_bf16 ? run_q<bf16, bf16>(a, route, bm, p0, p1, s)
                  : run_q<bf16, float>(a, route, bm, p0, p1, s);
  }
  return s_bf16 ? run_q<float, bf16>(a, route, bm, p0, p1, s)
                : run_q<float, float>(a, route, bm, p0, p1, s);
}

// K10: dense expert stack, 64-row tiles. route 1: grouped_tile_dense (bf16
// x and stack, p0 = BN of 64, 128 or 256); route 2: grouped_mma (any mix of
// bf16 and f32, Tp / 64 <= 65535).
extern "C" int uz_grouped_matmul(const void* x, int x_bf16, const void* tile_expert,
                                 const void* used, const void* w, int w_bf16, void* out,
                                 int Tp, int N, int K, int E, int route, int p0, void* stream) {
  const int* te = static_cast<const int*>(tile_expert);
  const int* u = static_cast<const int*>(used);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1 && x_bf16 && w_bf16) {
    if (p0 == 64) return launch_tile_dense<64>(x, te, u, w, o, Tp, N, K, E, s);
    if (p0 == 128) return launch_tile_dense<128>(x, te, u, w, o, Tp, N, K, E, s);
    if (p0 == 256) return launch_tile_dense<256>(x, te, u, w, o, Tp, N, K, E, s);
  } else if (route == 2) {
    if (x_bf16) {
      return w_bf16 ? launch_mma<bf16, bf16>(x, te, u, w, o, Tp, N, K, E, s)
                    : launch_mma<bf16, float>(x, te, u, w, o, Tp, N, K, E, s);
    }
    return w_bf16 ? launch_mma<float, bf16>(x, te, u, w, o, Tp, N, K, E, s)
                  : launch_mma<float, float>(x, te, u, w, o, Tp, N, K, E, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
