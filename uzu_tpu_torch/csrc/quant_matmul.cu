// Fused dequant matmul over INT4 / INT8 grouped-quantized weights (K1, K2).
//
//   out[m, n] = sum_k x[m, k] * (scale[n, k/g] * code[n, k] + qbias[n, k/g])
//
// Replaces the TPU kernels uzu_tpu/ops/pallas/quant_matmul.py::_int4_kernel
// and ::_int8_kernel (launched by _quant_matmul_p). Codes are u8 [N, K*bits/8],
// packed little-endian along K (4-bit: low nibble = even k); scales and the
// optional stored qbias are bf16 or f32 rows of at least ceil(K/g) groups,
// SK elements apart (a row may be zero-padded past its groups); a symmetric
// tensor passes qbias = nullptr and qbias = coeff * scale is derived in
// registers. x is bf16 or f32 [M, K]; out is f32 [M, N].
//
// Numerical contract. x and the dequantized weight enter the tensor cores
// as bf16 and sums are f32. With bf16 scales an INT4 weight is made in one
// bf16x2 FMA, code * scale + qbias rounded once from the exact value; every
// other weight (INT8, f32 scales) is dequantized in f32 and rounded to bf16.
// f32 x at M <= GEMV_MAX_M keeps the f32 CUDA-core GEMV (f32 throughout);
// above it the wrapper rounds f32 x to bf16 for the tile. Each output is
// summed in a fixed order with no atomics (a split-K tile's partials are
// added in split order by qmm_split_sum), so greedy output repeats.
//
// The wrapper's launch plan (ops/cuda/quant_matmul.py::qmm_plan, shapes and
// the SM count only) picks the route and its parameters; the kernels take
// them as arguments.
//
// Small M (1 <= M <= GEMV_MAX_M, bf16 x): qmm_small. What bounds it on the
// H100: ~2*M FLOP per weight against 0.5 (INT4) or 1 (INT8) byte of codes,
// far below the ~295 FLOP/byte where the tensor cores rather than HBM are
// the limit: streaming the codes once. Design: "swapped" tensor cores. A
// warp owns 16 weight rows; the dequantized rows are the A operand of
// mma.sync m16n8k16, built in registers straight from 16-byte code loads
// (no shared memory for W), and x's rows are the n8 operand, so M <= 8
// costs one mma per 16x16 weights and M <= 32 four. Each lane's 16 code
// bytes of a row are its four k-steps' (INT8) or eight k-steps' (INT4)
// share: the contraction index is permuted so that the INT4 pairs that one
// shift-and-mask gives, (n_i, n_i+4) of a 32-bit word, are the fragment's
// pairs, and x's fragment is permuted to match with byte permutes
// (tests/test_torch_qmm_plan.py holds the permutation). Every weight is read
// once for all M rows; x is read once per lane per chunk from L1. A block is
// 8 warps: 8/kw row tiles, each walked by kw warps over interleaved chunks
// of K (the plan's kw, from N and K only), summed in shared memory in warp
// order. The codes of 4 chunks are loaded before any is used, so each lane
// keeps 4 (INT4: 8 at two rows) 16-byte loads in flight. Since the plan and
// each column's product do not depend on M, row i of an M-row product is
// bitwise the M=1 product of row i.
//
// Large M (> GEMV_MAX_M): qmm_tile. At prefill M each weight is used M
// times and the FLOPs dominate: they belong on wgmma. A block owns BM = 128
// or 256 rows of x (two consumer warpgroups, one or two m64 tiles each) and
// 128 weight rows; K walks in chunks of 64 through a 4-stage ring. x comes
// by TMA (a tensor map of 64 x 64 boxes in the 128-byte swizzle that
// wgmma's descriptors read, zeros past M and K, completion on an mbarrier
// per stage); the raw codes and each row's window of group scales (and
// stored qbias) come by cp.async, so scales are copied once per chunk,
// beside the codes. The block's threads dequantize each chunk's codes once
// into a swizzled bf16 W tile (two buffers), so at M=256 each weight is
// dequantized once where the 64x64 tile did it four times; x is wgmma's A
// operand and W its B operand, both from shared memory (m64n128k16). The
// dequantization of chunk k overlaps the products of chunk k-1 and the
// copies of chunks k+1..k+3. Where the (M, N) blocks do not fill the SMs,
// the plan splits K into ranges of whole chunks (grid.z); the partials go
// to f32 scratch and qmm_split_sum adds them in split order. Ragged N,
// ragged M and a K that is not a multiple of the chunk are zero-filled by
// the copies and masked at the store.
// What holds the tile back on the H100 (PERF.md section 6): the readout
// at M=256 (1002 blocks of 32 chunks on 132 SMs) works out to ~1.6 us per
// 64-wide chunk, where the chunk's products take ~0.5 us at the tensor
// cores' peak. Loading x once instead of per chunk, deeper rings, clusters
// that multicast x, and a warp-specialized split (one warpgroup
// dequantizing into a W ring, two issuing wgmma) each left that time
// unchanged in probes; what is left is the chain of dequantization,
// barriers and waits per chunk on one block per SM.
//
// Not carried over from the TPU kernel: the even/odd deinterleave of x,
// the 0/1 expansion-matrix dot for the group scales, M padding to 8, and
// the Mosaic tile policy / VMEM budget.

#include <cuda.h>  // CUtensorMap (the encoder is fetched through the runtime)

#include "quant_tiles.cuh"

namespace {

using namespace uzq;

typedef __nv_bfloat16 bf16;

constexpr int GEMV_MAX_M = 32;  // the small-M route's limit (the wrapper's too)

// ---------------------------------------------------------------------------
// PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (0..7) of row r in a tile of 128-byte rows
// in the 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + (((c ^ r) & 7) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  constexpr uint32_t lbo = 16, sbo = 1024;  // 8 rows of 128 bytes a core-matrix group
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 16-byte copy of which the first `bytes` (0..16) come from src, the rest zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes (st.shared, cp.async) made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of wgmma's accumulators across its
// issue and its wait
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// mbarriers and TMA (the x tiles of qmm_tile)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait for the phase of `parity` to complete; a copy that never lands traps
// (a launch error) rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spins = 0; !mbar_try_wait(bar, parity); ++spins) {
    if (spins > (1ll << 26)) __trap();
  }
}

// a 2-D box of `map` at (c0 innermost, c1) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

#define UZ_D64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
  "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), \
  "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
  "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define UZ_R64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] += A[64 x 16] B[16 x 128]; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " UZ_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : UZ_D64
      : "l"(da), "l"(db), "r"(1));
}

// 16 code bytes at p, streamed past the L1 (x lives there)
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bf2_of(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// ---------------------------------------------------------------------------
// Dequantization. A group's (scale, qbias) as the operands each path takes.

template <typename ST>
struct Group;

template <>
struct Group<bf16> {  // bf16 scales: one bf16x2 FMA per pair of INT4 weights
  __nv_bfloat162 s2, b2;
  float s, b;  // the same values in f32, for INT8
  // sv, and bv where stored, else qbias = coeff * sv (coeff a power of two:
  // exact in bf16)
  __device__ __forceinline__ void set(bf16 sv, bf16 bv, bool stored, float coeff) {
    s = __bfloat162float(sv);
    const bf16 bq = stored ? bv : __float2bfloat16_rn(coeff * s);
    b = __bfloat162float(bq);
    s2 = __bfloat162bfloat162(sv);
    b2 = __bfloat162bfloat162(bq);
  }
};

template <>
struct Group<float> {
  float s, b;
  __device__ __forceinline__ void set(float sv, float bv, bool stored, float coeff) {
    s = sv;
    b = stored ? bv : coeff * sv;
  }
};

__device__ __forceinline__ float code_f32(uint32_t c) {  // c < 2^23, exact
  return __uint_as_float(0x4B000000u | c) - 8388608.f;
}

// The four bf16x2 pairs (n_i, n_i+4), i = 0..3, of one word of 8 INT4 codes
// (n0 in bits 0-3): 128 + n is built in each half's mantissa, 128 comes off
// exactly, and one FMA rounds n * scale + qbias once.
__device__ __forceinline__ void int4_pairs(uint32_t w, const Group<bf16>& g, uint32_t (&p)[4]) {
  const __nv_bfloat162 k128 = bf2_of(0x43004300u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = bf2_of(((w >> (4 * i)) & 0x000F000Fu) | 0x43004300u);
    p[i] = bits_of(__hfma2(__hsub2(v, k128), g.s2, g.b2));
  }
}

// the same pairs with the weight dequantized in f32 and rounded to bf16
__device__ __forceinline__ void int4_pairs(uint32_t w, const Group<float>& g, uint32_t (&p)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[i] = pack_bf16x2(fmaf(code_f32((w >> (4 * i)) & 15u), g.s, g.b),
                       fmaf(code_f32((w >> (4 * i + 16)) & 15u), g.s, g.b));
  }
}

// Two bf16x2 pairs (c0, c1), (c2, c3) of one word of 4 INT8 codes, each
// dequantized in f32 and rounded to bf16.
template <typename ST>
__device__ __forceinline__ void int8_pairs(uint32_t w, const Group<ST>& g, uint32_t (&p)[2]) {
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    f[b] = fmaf(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | b)) - 8388608.f, g.s, g.b);
  }
  p[0] = pack_bf16x2(f[0], f[1]);
  p[1] = pack_bf16x2(f[2], f[3]);
}

// ---------------------------------------------------------------------------
// Small M: qmm_small.

constexpr int SM_WARPS = 8;  // warps per block
constexpr int SM_UNROLL = 4;  // chunks whose codes are loaded before any is used

template <int BITS>
struct SmallGeo {
  static constexpr int CK = 512 / BITS;    // k per chunk: 4 lanes x 16 bytes of codes
  static constexpr int SPAN = CK / 4;      // k per lane per chunk
  static constexpr int VPW = 32 / BITS;    // codes per 32-bit word
  static constexpr int XV = SPAN / 8;      // 16-byte x loads per lane per chunk and row
};

// 16 bytes of row `row` from byte `off`: one load where the row starts
// 16-byte aligned and the bytes lie inside it, else word by word; bytes past
// the row are zeros.
__device__ __forceinline__ uint4 load_codes(const uint8_t* __restrict__ codes, int row,
                                            int row_bytes, int off, bool ok, int vec16) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!ok) return v;
  const uint8_t* p = codes + static_cast<size_t>(row) * row_bytes + off;
  const int left = row_bytes - off;
  if (vec16 && left >= 16) return ld_stream16(p);
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
  if (left > 0) v.x = __ldg(q);
  if (left > 4) v.y = __ldg(q + 1);
  if (left > 8) v.z = __ldg(q + 2);
  if (left > 12) v.w = __ldg(q + 3);
  return v;
}

// The raw (scale, qbias) of row `row`'s group at k (zeros where !ok or no
// stored qbias).
template <typename ST>
__device__ __forceinline__ void raw_group(const ST* __restrict__ scales,
                                          const ST* __restrict__ qbias, int row, bool ok,
                                          int SK, int k, int G, int glast, ST& sv, ST& bv) {
  const size_t at = static_cast<size_t>(row) * SK + min(k / G, glast);
  sv = ok ? scales[at] : ST(0.f);
  bv = ok && qbias != nullptr ? qbias[at] : ST(0.f);
}

// x[m, kb .. kb + 8 XV) of the rows m = 8 t + gid, zeros past M and K
template <int NT, int XV>
__device__ __forceinline__ void load_x(const bf16* __restrict__ x, int M, int K, int gid, int kb,
                                       uint4 (&xv)[NT][XV]) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int m = t * 8 + gid;
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int k = kb + 8 * v;
      xv[t][v] = m < M && k < K
                     ? __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K + k))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Warp w of a block: row tile w / kw of the block's 8 / kw, K share kq = w %
// kw (chunks kq, kq + kw, ... of CK each). NT: n8 tiles of x (M <= 8 * NT).
template <int BITS, typename ST, int NT>
__global__ void __launch_bounds__(SM_WARPS * 32)
qmm_small(const bf16* __restrict__ x, const uint8_t* __restrict__ codes,
          const ST* __restrict__ scales, const ST* __restrict__ qbias, float coeff,
          float* __restrict__ out, int M, int N, int K, int G, int SK, int vec16, int kw) {
  using Geo = SmallGeo<BITS>;
  __shared__ float red[SM_WARPS][4 * NT][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int kq = warp % kw;
  const int n0 = (blockIdx.x * (SM_WARPS / kw) + warp / kw) * 16;
  const int rows[2] = {n0 + gid, n0 + gid + 8};
  const bool rok[2] = {rows[0] < N, rows[1] < N};
  const int row_bytes = K * BITS / 8;
  const int nchunks = (K + Geo::CK - 1) / Geo::CK;
  const int glast = (K - 1) / G;
  const bool one_group = G % Geo::SPAN == 0;  // a lane's span of a chunk is one group
  const bool stored = qbias != nullptr;

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  if (n0 < N) {
    for (int c0 = kq; c0 < nchunks; c0 += SM_UNROLL * kw) {
      // the batch's codes and group values first, then x a chunk ahead
      uint4 cw[SM_UNROLL][2];
      ST sr[SM_UNROLL][2], br[SM_UNROLL][2];
#pragma unroll
      for (int u = 0; u < SM_UNROLL; ++u) {
        const int c = c0 + u * kw;
        const int kb = c * Geo::CK + tig * Geo::SPAN;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          cw[u][r] = load_codes(codes, rows[r], row_bytes, kb * BITS / 8, rok[r] && c < nchunks,
                                vec16);
          if (one_group) {
            raw_group<ST>(scales, qbias, rows[r], rok[r], SK, kb, G, glast, sr[u][r],
                          br[u][r]);
          }
        }
      }
      uint4 xn[NT][Geo::XV];
      load_x<NT, Geo::XV>(x, M, K, gid, c0 * Geo::CK + tig * Geo::SPAN, xn);
#pragma unroll
      for (int u = 0; u < SM_UNROLL; ++u) {
        const int c = c0 + u * kw;
        if (c >= nchunks) break;
        const int kb = c * Geo::CK + tig * Geo::SPAN;  // this lane's first k
        uint4 xv[NT][Geo::XV];
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int v = 0; v < Geo::XV; ++v) xv[t][v] = xn[t][v];
        if (u + 1 < SM_UNROLL && c + kw < nchunks) {
          load_x<NT, Geo::XV>(x, M, K, gid, kb + kw * Geo::CK, xn);
        }
        Group<ST> g[2];
        if (one_group) {
          g[0].set(sr[u][0], br[u][0], stored, coeff);
          g[1].set(sr[u][1], br[u][1], stored, coeff);
        }
        const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&cw[u][0]);
        const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&cw[u][1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // one code word of each row
          if (!one_group) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              ST sv, bv;
              raw_group<ST>(scales, qbias, rows[r], rok[r], SK, kb + q * Geo::VPW, G, glast,
                            sv, bv);
              g[r].set(sv, bv, stored, coeff);
            }
          }
          if constexpr (BITS == 4) {
            // two k-steps: step h takes the pairs (n_2h, n_2h+4), (n_2h+1, n_2h+5)
            uint32_t p0[4], p1[4];
            int4_pairs(w0[q], g[0], p0);
            int4_pairs(w1[q], g[1], p1);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t a[4] = {p0[2 * h], p1[2 * h], p0[2 * h + 1], p1[2 * h + 1]};
#pragma unroll
              for (int t = 0; t < NT; ++t) {
                // x[8q .. 8q+7] of row t*8+gid: (x_2h, x_2h+4) and (x_2h+1, x_2h+5)
                const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv[t][q]);
                const uint32_t b[2] = {__byte_perm(xw[h], xw[h + 2], 0x5410),
                                       __byte_perm(xw[h], xw[h + 2], 0x7632)};
                mma_16816(acc[t], a, b);
              }
            }
          } else {
            // one k-step: pairs (c0, c1), (c2, c3) in k order
            uint32_t p0[2], p1[2];
            int8_pairs<ST>(w0[q], g[0], p0);
            int8_pairs<ST>(w1[q], g[1], p1);
            const uint32_t a[4] = {p0[0], p1[0], p0[1], p1[1]};
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv[t][q >> 1]);
              const uint32_t b[2] = {xw[2 * (q & 1)], xw[2 * (q & 1) + 1]};
              mma_16816(acc[t], a, b);
            }
          }
        }
      }
    }
  }

  // the kw warps of a row tile summed in warp order; D[n][m] of each fragment:
  // e = 0, 1 at row gid, columns 2 tig, 2 tig + 1; e = 2, 3 at row gid + 8
  if (kw > 1) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp][4 * t + e][lane] = acc[t][e];
    __syncthreads();
    if (kq != 0) return;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = red[warp][4 * t + e][lane];
        for (int j = 1; j < kw; ++j) s += red[warp + j][4 * t + e][lane];
        acc[t][e] = s;
      }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = rows[e >> 1];
      const int m = t * 8 + 2 * tig + (e & 1);
      if (n < N && m < M) out[static_cast<size_t>(m) * N + n] = acc[t][e];
    }
}

// ---------------------------------------------------------------------------
// Large M: qmm_tile.

constexpr int T_BK = 64;    // k per chunk: one 128-byte swizzled row of bf16

template <int BITS, int NWG, int MW, int S>
struct TileGeo {
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BM = 64 * NWG * MW;         // rows of x: MW m64 tiles per warpgroup
  static constexpr int BN = 128;                   // weight rows: wgmma's N
  static constexpr int X_STAGE = BM * 128;         // x chunk, swizzled, 64-row boxes
  static constexpr int C_ROW = T_BK * BITS / 8;    // code bytes of a row per chunk
  static constexpr int C_STAGE = BN * C_ROW;       // raw codes
  static constexpr int UPR = C_ROW / 16;           // 16-byte code units per row
  static constexpr int UPT = BN * UPR / THREADS;   // code units per thread
  static constexpr int UNIT_K = 128 / BITS;        // k per unit
  static constexpr int W_TILE = BN * 128;          // dequantized chunk, swizzled
  static constexpr int G_SLOT = 16;                // a row's group window per chunk
  static constexpr int G_STAGE = BN * G_SLOT;
  static constexpr int C_OFF = S * X_STAGE;
  static constexpr int W_OFF = C_OFF + S * C_STAGE;
  static constexpr int S_OFF = W_OFF + 2 * W_TILE;     // scales' windows
  static constexpr int Q_OFF = S_OFF + S * G_STAGE;    // stored qbias' windows
  static constexpr int BAR_OFF = Q_OFF + S * G_STAGE;  // an mbarrier per stage
  static constexpr int BYTES = BAR_OFF + S * 8;
  static constexpr int LAUNCH_BYTES = BYTES + 1024;  // room to align the base to 1024
};

template <int BITS, typename ST, int NWG, int MW, int S>
__global__ void __launch_bounds__(128 * NWG, 1)
qmm_tile(const __grid_constant__ CUtensorMap xmap, const uint8_t* __restrict__ codes,
         const ST* __restrict__ scales, const ST* __restrict__ qbias, float coeff,
         float* __restrict__ out, int M, int N, int K, int G, int SK, int vec16, int cps) {
  using L = TileGeo<BITS, NWG, MW, S>;
  constexpr int ES = static_cast<int>(sizeof(ST));
  constexpr int GW = ES == 2 ? 2 : 3;  // 4-byte words that hold a chunk's groups
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);
  const CUtensorMap* xm = &xmap;  // the parameter's own address, as TMA needs it
  const int tid = threadIdx.x;
  const int m_base = blockIdx.x * L::BM;
  const int n_base = blockIdx.y * L::BN;
  const int nchunks = (K + T_BK - 1) / T_BK;
  const int c_begin = blockIdx.z * cps;
  const int nk = min(nchunks, c_begin + cps) - c_begin;
  const int row_bytes = K * BITS / 8;
  const int glast = (K - 1) / G;
  const bool stored = qbias != nullptr;
  // With G % 32 == 0 a 64-wide chunk touches at most 3 groups of a row (2
  // when G == 32), and the GW words from the one holding the first lie in
  // the ring beside the codes; other group sizes read each word's group
  // from global memory.
  const bool ring_groups = G % 32 == 0;
  const size_t g_bytes = static_cast<size_t>(N) * SK * ES;

  auto load_stage = [&](int chunk, int stage) {
    const int k0 = chunk * T_BK;
    if (tid == 0) {  // x by TMA: 64-row boxes in wgmma's swizzle, zeros past M and K
      const uint32_t bar = sbase + L::BAR_OFF + 8 * stage;
      mbar_expect_tx(bar, L::X_STAGE);
#pragma unroll
      for (int b = 0; b < L::BM / 64; ++b) {
        tma_load_2d(sbase + stage * L::X_STAGE + b * 8192, xm, bar, k0, m_base + 64 * b);
      }
    }
    const uint32_t cs = sbase + L::C_OFF + stage * L::C_STAGE;
#pragma unroll
    for (int j = 0; j < L::UPT; ++j) {
      const int i = tid + j * L::THREADS;
      const int r = i / L::UPR;
      const int off = k0 * BITS / 8 + (i % L::UPR) * 16;
      const int left = n_base + r < N ? max(0, min(16, row_bytes - off)) : 0;
      const uint8_t* src = codes + (left > 0 ? static_cast<size_t>(n_base + r) * row_bytes + off : 0);
      if (vec16) {
        cp_async16(cs + i * 16, src, left);
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) cp_async4(cs + i * 16 + 4 * w, src + 4 * w, 4 * w < left);
      }
    }
    if (ring_groups) {
      const int g0 = k0 / G;
      for (int i = tid; i < L::BN * GW * (stored ? 2 : 1); i += L::THREADS) {
        const int r = i % L::BN;
        const int w = (i / L::BN) % GW;
        const int a = i / (L::BN * GW);  // 0 scales, 1 qbias
        const size_t word = (static_cast<size_t>(n_base + r) * SK + g0) * ES / 4 + w;
        const bool ok = n_base + r < N && word * 4 < g_bytes;
        const uint8_t* src = reinterpret_cast<const uint8_t*>(a ? qbias : scales) + (ok ? word * 4 : 0);
        cp_async4(sbase + (a ? L::Q_OFF : L::S_OFF) + stage * L::G_STAGE + r * L::G_SLOT + 4 * w,
                  src, ok);
      }
    }
  };

  // dequantize the chunk in `stage` into W buffer `wb`
  auto dequant = [&](int chunk, int stage, int wb) {
    const int k0 = chunk * T_BK;
    const int g0 = k0 / G;
    const uint8_t* cs = base + L::C_OFF + stage * L::C_STAGE;
    uint8_t* wt = base + L::W_OFF + wb * L::W_TILE;
#pragma unroll
    for (int j = 0; j < L::UPT; ++j) {
      const int i = tid + j * L::THREADS;
      const int r = i / L::UPR;
      const int u = i % L::UPR;
      const int n = n_base + r;
      const int k = k0 + u * L::UNIT_K;
      const uint4 raw = *reinterpret_cast<const uint4*>(cs + i * 16);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
      Group<ST> g;
      if (ring_groups) {  // the unit's k lie in one group
        const int lead = static_cast<int>(((static_cast<size_t>(n) * SK + g0) * ES) & 3);
        const int at = stage * L::G_STAGE + r * L::G_SLOT + lead + (min(k / G, glast) - g0) * ES;
        g.set(*reinterpret_cast<const ST*>(base + L::S_OFF + at),
              *reinterpret_cast<const ST*>(base + L::Q_OFF + at), stored, coeff);
      }
      if constexpr (BITS == 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // a word: 8 k, one 16-byte swizzle chunk
          if (!ring_groups) {
            ST sv, bv;
            raw_group<ST>(scales, qbias, n, n < N, SK, k + 8 * q, G, glast, sv, bv);
            g.set(sv, bv, stored, coeff);
          }
          uint32_t p[4];  // (n_i, n_i+4)
          int4_pairs(w[q], g, p);
          *reinterpret_cast<uint4*>(wt + swz(r, u * 4 + q)) =
              make_uint4(__byte_perm(p[0], p[1], 0x5410), __byte_perm(p[2], p[3], 0x5410),
                         __byte_perm(p[0], p[1], 0x7632), __byte_perm(p[2], p[3], 0x7632));
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // a word: 4 k, half a 16-byte swizzle chunk
          if (!ring_groups) {
            ST sv, bv;
            raw_group<ST>(scales, qbias, n, n < N, SK, k + 4 * q, G, glast, sv, bv);
            g.set(sv, bv, stored, coeff);
          }
          uint32_t pq[2];
          int8_pairs<ST>(w[q], g, pq);
          *reinterpret_cast<uint2*>(wt + swz(r, u * 2 + (q >> 1)) + 8 * (q & 1)) =
              make_uint2(pq[0], pq[1]);
        }
      }
    }
  };

  const int wg = tid >> 7;
  float acc[MW][64];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[i][e] = 0.f;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(sbase + L::BAR_OFF + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load_stage(c_begin + s, s);
    cp_async_commit();
  }
  // Chunk it is dequantized while chunk it - 1's products run on the
  // tensor cores; its stage is refilled once every warpgroup is past them.
  for (int it = 0; it < nk; ++it) {
    const int stage = it % S;
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk it's codes and groups have landed, every thread's
    dequant(c_begin + it, stage, it & 1);
    fence_async_smem();
    wg_wait0();     // this warpgroup's products of chunk it - 1
    __syncthreads();  // W of chunk it written; chunk it - 1's stage and W buffer free
    if (it + S - 1 < nk) load_stage(c_begin + it + S - 1, (it + S - 1) % S);
    cp_async_commit();
    mbar_wait(sbase + L::BAR_OFF + 8 * stage, (it / S) & 1);  // x of chunk it
    wg_fence();
    const uint32_t xs = sbase + stage * L::X_STAGE + wg * MW * 8192;
    const uint32_t ws = sbase + L::W_OFF + (it & 1) * L::W_TILE;
#pragma unroll
    for (int kk = 0; kk < T_BK / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        wgmma_ss(acc[i], sw128_desc(xs + i * 8192 + kk * 32), sw128_desc(ws + kk * 32));
      }
    }
    wg_commit();
  }
  wg_wait0();
#pragma unroll
  for (int i = 0; i < MW; ++i) fence_regs(acc[i]);

  // the accumulator fragment: warp w of the warpgroup holds rows 16 w + gid
  // (+ 8), n8 block j columns 8 j + 2 tig (+ 1)
  float* dst = out + static_cast<size_t>(blockIdx.z) * M * N;
  const int lane = tid & 31;
  const int wrow = ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < MW; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + (wg * MW + i) * 64 + wrow + 8 * h;
      if (m >= M) continue;
      float* orow = dst + static_cast<size_t>(m) * N;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n_base + 8 * j + col_t;
        const float v0 = acc[i][4 * j + 2 * h];
        const float v1 = acc[i][4 * j + 2 * h + 1];
        if (pairs && n + 1 < N) {
          *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
        } else {
          if (n < N) orow[n] = v0;
          if (n + 1 < N) orow[n + 1] = v1;
        }
      }
    }
  }
}

// out[i] = sum over z in order of part[z][i]
__global__ void __launch_bounds__(256)
qmm_split_sum(const float* __restrict__ part, float* __restrict__ out, int total, int splits) {
  const size_t stride = static_cast<size_t>(total);
  const int i4 = blockIdx.x * blockDim.x + threadIdx.x;
  if (total % 4 == 0) {
    if (4 * i4 >= total) return;
    const float4* p = reinterpret_cast<const float4*>(part);
    float4 s = p[i4];
    for (int z = 1; z < splits; ++z) {
      const float4 v = p[z * (stride / 4) + i4];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    reinterpret_cast<float4*>(out)[i4] = s;
  } else {
    for (int i = 4 * i4; i < min(total, 4 * i4 + 4); ++i) {
      float s = part[i];
      for (int z = 1; z < splits; ++z) s += part[z * stride + i];
      out[i] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// f32 x at small M: one warp per output row, MT rows of x per pass, f32
// throughout (the GEMV K7/K8 share, quant_tiles.cuh).

template <int BITS, typename XT, typename ST, int MT>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qmm_gemv(const XT* __restrict__ x, const uint32_t* __restrict__ codes,
         const ST* __restrict__ scales, const ST* __restrict__ qbias,
         float coeff, float* __restrict__ out, int M, int N, int K, int G,
         int SK, int vec16) {
  constexpr int VPW = 32 / BITS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + warp;
  if (n >= N) return;
  const int m0 = blockIdx.y * MT;
  const int mrows = min(MT, M - m0);
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;
  gemv_row<BITS, XT, ST, MT>(
      x + static_cast<size_t>(m0) * K, codes + static_cast<size_t>(n) * (K / VPW),
      scales + static_cast<size_t>(n) * SK,
      qbias != nullptr ? qbias + static_cast<size_t>(n) * SK : nullptr, coeff, K, G, mrows,
      vec16, lane, acc);
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = warp_sum(acc[m]);
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < mrows) out[static_cast<size_t>(m0 + m) * N + n] = acc[m];
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers

struct Args {
  const void* x;
  const void* codes;
  const void* scales;
  const void* qbias;
  float coeff;
  float* out;
  int M, N, K, G, SK, vec16;
};

template <int BITS, typename ST, int MT>
void launch_gemv(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.N + GEMV_WARPS - 1) / GEMV_WARPS, (a.M + MT - 1) / MT);
  qmm_gemv<BITS, float, ST, MT><<<grid, GEMV_WARPS * 32, 0, stream>>>(
      static_cast<const float*>(a.x), static_cast<const uint32_t*>(a.codes),
      static_cast<const ST*>(a.scales), static_cast<const ST*>(a.qbias), a.coeff, a.out, a.M,
      a.N, a.K, a.G, a.SK, a.vec16);
}

template <int BITS, typename ST>
int run_gemv(const Args& a, cudaStream_t s) {
  if (a.M == 1) {
    launch_gemv<BITS, ST, 1>(a, s);
  } else if (a.M == 2) {
    launch_gemv<BITS, ST, 2>(a, s);
  } else if (a.M <= 4) {
    launch_gemv<BITS, ST, 4>(a, s);
  } else {
    launch_gemv<BITS, ST, 8>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, typename ST, int NT>
void launch_small(const Args& a, int kw, cudaStream_t stream) {
  const int tiles = (a.N + 15) / 16;
  const int per_block = SM_WARPS / kw;
  qmm_small<BITS, ST, NT><<<(tiles + per_block - 1) / per_block, SM_WARPS * 32, 0, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const uint8_t*>(a.codes),
      static_cast<const ST*>(a.scales), static_cast<const ST*>(a.qbias), a.coeff, a.out, a.M,
      a.N, a.K, a.G, a.SK, a.vec16, kw);
}

template <int BITS, typename ST>
int run_small(const Args& a, int kw, cudaStream_t s) {
  if (kw < 1 || kw > SM_WARPS || SM_WARPS % kw || a.M > GEMV_MAX_M) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.M <= 8) {
    launch_small<BITS, ST, 1>(a, kw, s);
  } else if (a.M <= 16) {
    launch_small<BITS, ST, 2>(a, kw, s);
  } else {
    launch_small<BITS, ST, 4>(a, kw, s);
  }
  return static_cast<int>(cudaGetLastError());
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// x [M, K] bf16 as a TMA tensor map of 64 x 64 boxes (128 bytes of k by 64
// rows) in the 128-byte swizzle; reads past M and K fill zeros
cudaError_t x_tensor_map(CUtensorMap* map, const void* x, int M, int K) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BITS, typename ST, int NWG, int MW, int S>
int launch_tile(const Args& a, int splits, int cps, float* scratch, cudaStream_t stream) {
  using L = TileGeo<BITS, NWG, MW, S>;
  constexpr int smem = L::LAUNCH_BYTES;
  // the shared-memory attribute is per device: set it once on each
  constexpr int MAX_DEVICES = 64;
  static bool attr[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES || !attr[dev]) {
    e = cudaFuncSetAttribute(qmm_tile<BITS, ST, NWG, MW, S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) attr[dev] = true;
  }
  CUtensorMap xmap;
  e = x_tensor_map(&xmap, a.x, a.M, a.K);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.M + L::BM - 1) / L::BM, (a.N + L::BN - 1) / L::BN, splits);
  qmm_tile<BITS, ST, NWG, MW, S><<<grid, L::THREADS, smem, stream>>>(
      xmap, static_cast<const uint8_t*>(a.codes), static_cast<const ST*>(a.scales),
      static_cast<const ST*>(a.qbias), a.coeff, splits > 1 ? scratch : a.out, a.M, a.N, a.K,
      a.G, a.SK, a.vec16, cps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (splits > 1) {
    const int total = a.M * a.N;
    qmm_split_sum<<<(total / 4 + 1 + 255) / 256, 256, 0, stream>>>(scratch, a.out, total,
                                                                   splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, typename ST>
int run_tile(const Args& a, int bm, int splits, int cps, float* scratch, cudaStream_t s) {
  if (splits < 1 || cps < 1 || (splits > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bm == 128) return launch_tile<BITS, ST, 2, 1, 4>(a, splits, cps, scratch, s);
  if (bm == 256) return launch_tile<BITS, ST, 2, 2, 4>(a, splits, cps, scratch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int BITS, typename ST>
int run(const Args& a, int x_bf16, int route, int p0, int p1, int p2, float* scratch,
        cudaStream_t s) {
  switch (route) {
    case 0:  // f32 x, M <= GEMV_MAX_M
      if (x_bf16 || a.M > GEMV_MAX_M) return static_cast<int>(cudaErrorInvalidValue);
      return run_gemv<BITS, ST>(a, s);
    case 1:  // bf16 x, M <= GEMV_MAX_M: p0 = kw
      if (!x_bf16) return static_cast<int>(cudaErrorInvalidValue);
      return run_small<BITS, ST>(a, p0, s);
    case 2:  // bf16 x: p0 = BM, p1 = splits, p2 = chunks per split
      if (!x_bf16) return static_cast<int>(cudaErrorInvalidValue);
      return run_tile<BITS, ST>(a, p0, p1, p2, scratch, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. The caller guarantees: K % 8 == 0,
// G % 8 == 0, SK >= ceil(K/G), x/codes/scales/qbias/out contiguous and
// 16-byte aligned, qbias == nullptr for coefficient tensors. vec16: the codes
// row stride is a multiple of 16 bytes. route and p0..p2 are the wrapper's
// plan: 0 the f32 GEMV (f32 x, M <= 32); 1 qmm_small (bf16 x, M <= 32, p0 =
// kw warps over K per row tile); 2 qmm_tile (bf16 x, p0 = BM of 64, 128 or
// 256, p1 = splits of K, p2 = 64-wide chunks per split, scratch f32
// [splits, M, N] when p1 > 1). Returns cudaGetLastError() after the launches.
extern "C" int uz_quant_matmul(const void* x, int x_bf16, const void* codes,
                               const void* scales, const void* qbias, int s_bf16,
                               float coeff, void* out, int M, int N, int K, int G, int SK,
                               int bits, int vec16, int route, int p0, int p1, int p2,
                               void* scratch, void* stream) {
  const Args a{x, codes, scales, qbias, coeff, static_cast<float*>(out), M, N, K, G, SK, vec16};
  float* part = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4) {
    return s_bf16 ? run<4, bf16>(a, x_bf16, route, p0, p1, p2, part, s)
                  : run<4, float>(a, x_bf16, route, p0, p1, p2, part, s);
  }
  if (bits == 8) {
    return s_bf16 ? run<8, bf16>(a, x_bf16, route, p0, p1, p2, part, s)
                  : run<8, float>(a, x_bf16, route, p0, p1, p2, part, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
