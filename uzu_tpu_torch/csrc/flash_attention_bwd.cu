// Backward of causal GQA flash attention over a contiguous KV cache (K3b),
// on Hopper's warpgroup tensor cores.
//
// K3 (flash_attention.cu) computes, for query row s at position pos0 + s
// (pos0 = q_positions[0], read on the device) and head h of KV group
// g = h / rep (rep = H / G):
//   S[s,h,c] = scale * q[s,h] . k[c,g]     masked to c <= qpos (and
//              c > qpos - window when window > 0)
//   P = softmax_c(S),  O[s,h] = sum_c P[s,h,c] v[c,g]
// and, when asked, each row's log-sum-exp L[s,h] = logsumexp_c S[s,h,c].
// Given dO (f32 [S, H, DH]), K3's output O and its L, this computes
//   P       = exp(S - L)
//   D[s,h]  = sum_d dO[s,h,d] * O[s,h,d]
//   dS      = P * (dO . v[c] - D)
//   dQ[s,h] = scale * sum_c dS[s,h,c] k[c,g]
//   dK[c,g] = scale * sum_{s, h in g} dS[s,h,c] q[s,h]
//   dV[c,g] = sum_{s, h in g} P[s,h,c] dO[s,h]
// in f32, for q, k, v in bf16 or f32. It replaces no TPU kernel: the JAX
// package differentiates attention through XLA (its flash kernel stays off
// the TPU, uzu_tpu/ops/attention.py), but the port sends every causal
// prefill over a contiguous cache to K3, which has no autograd, so training
// through the port's forward needs this gradient as a kernel
// (uzu_tpu/tools/train_tiny.py:110 takes jax.value_and_grad of that
// forward).
//
// What bounds it on the H100. Per (query row, head, visible key) the
// gradient is five products of DH (S, dP = dO . v, dV, dQ, dK): ~10 DH
// FLOP against ~2 DH bytes of K/V per key read once, so at every training
// shape (S = 512 over 512 visible keys) it is bound by operations, and
// those belong on the tensor cores (989 TFLOP/s in bf16; the CUDA cores
// give ~67).
//
// Design (no atomics: every output element is written by one thread, in
// one order, so the gradient repeats bitwise):
// - Every product is wgmma m64nNk16 (N = 64, or 32 at DH 32 and for f32's
//   32-row tiles at DH 256) with f32 accumulators in registers, on the
//   operand layout K3 uses: bf16 tiles of [rows][DH] in the 128-byte swizzle
//   (the 64-byte one at DH 32), read K-major where DH is the product's
//   depth and MN-major (transposed B) where the tile's rows are.
// - Launch 0, flash_bwd_prep: D = rowsum(dO O) of every query row and dO
//   as bf16 operand pairs, to scratch for launch 2; for f32 inputs q, k and
//   v split once into bf16 hi + lo copies too, so both main launches copy
//   bf16 operand tiles straight into shared memory with cp.async.
// - Launches 1 and 2 run side by side: launch 2 (and 3) on a side stream
//   that waits for launch 0, launch 1 on the caller's stream, which then
//   waits for launch 3. Neither fills the card alone at a training shape
//   (launch 1 gives one block per query tile and column slice).
// - Launch 1, flash_bwd_dq: one warpgroup per (64 query rows of one KV
//   group in K3's (s, r) order, column slice of dQ). Its prologue stages Q,
//   converts dO to bf16 operand pairs and computes D from dO and O as
//   launch 0 does (the same D). K and V tiles of the visible keys stream
//   through a cp.async ring of 1-4 stages. Per key tile: S = Q K^T and
//   dP = dO V^T (both operands in shared memory, issued together;
//   P = exp2(S scale log2e - L log2e) runs while dP is in flight), dS = P (dP - D), and dQ += dS K with dS packed
//   from the accumulator into wgmma's A registers (a bf16 pair), as K3
//   packs P for P V, and K read transposed from the same tile. L is K3's:
//   no recompute.
// - Launch 2, flash_bwd_dkdv: one warpgroup per (64 keys of one group,
//   column slice of dK and dV, part of the query tiles). K and V stay in
//   shared memory; the Q, dO, L and D tiles of the query tiles that see the
//   block's keys stream through the ring. Per query tile: S^T = K Q^T and
//   dP^T = V dO^T, P^T and dS^T on that fragment (each column's L and D
//   from the stage), dV += P^T dO and dK += dS^T Q with P^T and dS^T as
//   register A operands. Computing S^T directly puts the transposed tile in
//   the accumulator layout the A operand needs: nothing is transposed in
//   shared memory. A block whose keys no query of its part sees writes
//   zeros and loads nothing (slots past the last query: zero gradient at no
//   cost).
// - Launch 3, flash_bwd_sum: with parts > 1, each part's partial dK/dV went
//   to scratch; this adds them in part order. The parts exist because a
//   chunk from position 0 has few key tiles with work (S=512 over 6/2
//   heads: 8 a group, the first walking all 24 query tiles); the wrapper's
//   `bwd_parts` picks them from the shapes and the SM count.
// - Column slices: a dQ block owns at most 128 columns of dQ (DH 256: two
//   slices), a dK/dV block at most 64 columns of each of dK and dV (DH 128:
//   two, DH 256: four), so the accumulators (dQ's, or dK's and dV's) stay at
//   64 registers a thread beside S's and dP's. Each slice recomputes S and
//   dP over the whole DH: at DH 256 that repeats the score products, which
//   buys the registers.
// - A dh between two instantiations (32, 64, 128, 256) runs in the next one
//   up with the columns past dh zero-filled on load and never stored, as K3
//   does. Rows past S*rep and keys past C load as zeros; zero rows add
//   exactly zero, keys past C are masked in launch 1 and never stored in
//   launch 2.
//
// Rounding: every sum is f32. bf16 q, k, v are operands as they are; f32
// q, k, v go as bf16 pairs hi + lo (x - hi), as K3 carries them. dO (f32),
// P and dS go as pairs for both input types: rounding each to bf16 once,
// as K3 rounds P, puts a plain model of the kernel up to 3.5e-2 of RMS
// (max abs error) off jax.grad (tests/test_torch_flash_bwd.py), past the
// 2e-2 the port holds its kernels to: dK and dV sum many rounded terms, and
// a few of their elements sit far above RMS. With pairs the gradient lies
// within ~2e-4 of RMS of the f32 plain version (NVIDIA H100 80GB HBM3,
// 700 W). A product of a pair and a bf16 operand is two wgmma (hi.b +
// lo.b), of two pairs three (hi.hi + hi.lo + lo.hi): ten for bf16 inputs,
// fifteen for f32, in place of five. dP is summed in f32 from the split
// operands and dS = P (dP - D) is taken in f32 before it is split, so the
// subtraction loses no digits to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using uzq::smem_u32;

constexpr int THREADS = 128;  // one warpgroup
constexpr int BM = 64;        // a block's own rows: query rows (launch 1), keys (launch 2)
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREE_PER_SM = 75776;  // bytes a block may take for three to share an SM
constexpr int TWO_PER_SM = 114688;    // for two
constexpr int ONE_PER_SM = 231424;    // 227 KB less the base's alignment slack

// the most ring stages, up to 4, within `cap` bytes (0: not even two)
constexpr int stages_within(int fixed, int stage, int cap) {
  return fixed + 4 * stage <= cap   ? 4
         : fixed + 3 * stage <= cap ? 3
         : fixed + 2 * stage <= cap ? 2
                                    : 0;
}

// ring depth: with `three`, the most stages (at least two) that keep three
// blocks on an SM; else the most, at least three, that keep two; else two,
// else one
constexpr int ring_stages(int fixed, int stage, bool three) {
  return three && stages_within(fixed, stage, THREE_PER_SM)
             ? stages_within(fixed, stage, THREE_PER_SM)
         : stages_within(fixed, stage, TWO_PER_SM) >= 3 ? stages_within(fixed, stage, TWO_PER_SM)
         : fixed + 2 * stage <= ONE_PER_SM              ? 2
                                                        : 1;
}

// blocks of `bytes` (alignment slack included) that share an SM
constexpr int per_sm(int bytes) {
  return bytes - 1024 <= THREE_PER_SM ? 3 : bytes - 1024 <= TWO_PER_SM ? 2 : 1;
}

// The shapes of one instantiation (the wrapper's bwd_plan holds a table of
// the three it needs, which uz_flash_attention_bwd_plan reports).
template <bool SPLIT, int DH>
struct Plan {
  static constexpr int LO = SPLIT ? 2 : 1;                 // tiles of q, k, v: hi (, lo); dO: 2
  static constexpr int BN = SPLIT && DH == 256 ? 32 : 64;  // rows of a streamed tile
  static constexpr int TM = BM * DH * 2;                   // one bf16 tile of a block's own rows
  static constexpr int TN = BN * DH * 2;                   // one bf16 tile of a streamed tensor
  static constexpr int ON = DH < 64 ? DH : 64;             // columns of one output block (N)
  static constexpr int OC_Q = DH < 128 ? DH : 128;         // dQ columns a dQ block owns
  static constexpr int OC_KV = DH < 64 ? DH : 64;          // dK and dV columns a dK/dV block owns
  // bf16 inputs up to DH 64 keep three blocks of each launch on an SM:
  // each block is one warpgroup whose products wait on its own exponentials
  static constexpr bool THREE = !SPLIT && DH <= 64;
  // launch 1: Q and dO; per stage K and V
  static constexpr int DQ_FIXED = (LO + 2) * TM;
  static constexpr int DQ_STAGE = 2 * LO * TN;
  static constexpr int DQ_STAGES = ring_stages(DQ_FIXED, DQ_STAGE, THREE);
  static constexpr int DQ_BYTES = DQ_FIXED + DQ_STAGES * DQ_STAGE + 1024;  // + alignment
  // launch 2: K and V; per stage Q, dO and the tile's L and D
  static constexpr int KV_FIXED = 2 * LO * TM;
  static constexpr int KV_STAGE = (LO + 2) * TN + 2 * BN * 4;
  static constexpr int KV_STAGES = ring_stages(KV_FIXED, KV_STAGE, THREE);
  static constexpr int KV_BYTES = KV_FIXED + KV_STAGES * KV_STAGE + 1024;
  static constexpr int DQ_PER_SM = per_sm(DQ_BYTES);
  static constexpr int KV_PER_SM = per_sm(KV_BYTES);
  static_assert(DQ_BYTES <= 232448 && KV_BYTES <= 232448,
                "K3b's layout passes 227 KB of shared memory");
};

// Byte offset of 16-byte chunk c (8 bf16 along DH) of row r in a tile of
// ROWS rows: DH >= 64, [DH/64 atoms][ROWS][128 bytes] with the chunk index
// XOR (r % 8); DH 32, [ROWS][64 bytes] in the 64-byte swizzle (K3's swz).
template <int DH, int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  if constexpr (DH == 32) {
    return r * 64 + (((c & 3) ^ ((r >> 1) & 3)) << 4);
  } else {
    return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  }
}

// wgmma shared-memory descriptor; swizzle mode 1 is 128 bytes, 2 is 64
template <int DH>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t mode = DH == 32 ? 2ull : 1ull;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// a tile read K-major (DH is the depth): k-step kk's 16 columns
template <int DH, int ROWS>
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
  constexpr int ROWB = DH == 32 ? 64 : 128;
  const uint32_t off = DH == 32 ? kk * 32 : (kk >> 2) * (ROWS * 128) + (kk & 3) * 32;
  return sw_desc<DH>(base + off, 16, 8 * ROWB);
}

// a tile read MN-major (its rows are the depth): rows [16 kk, 16 kk + 16)
// of output column block n
template <int DH, int ROWS>
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk, int n) {
  constexpr int ROWB = DH == 32 ? 64 : 128;
  return sw_desc<DH>(base + n * (ROWS * 128) + kk * 16 * ROWB, ROWS * 128, 8 * ROWB);
}

#define UZ_D16                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define UZ_D32                                                                               \
  UZ_D16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),     \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),          \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define UZ_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define UZ_R32                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " UZ_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : UZ_D32
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 32] (+)= A[64 x 16] B[16 x 32]
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " UZ_R16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : UZ_D16
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += A[64 x 16] (registers, bf16x2) B[16 x 64], B MN-major
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " UZ_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : UZ_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 32] += A[64 x 16] (registers) B[16 x 32], B MN-major
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " UZ_R16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : UZ_D16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef UZ_D16
#undef UZ_D32
#undef UZ_R16
#undef UZ_R32

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as a bf16x2 pair hi and the rest lo = bf16x2(x - hi)
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(a - back.x, b - back.y);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 8 f32 values as bf16 hi and lo
__device__ __forceinline__ void convert8(const float (&x)[8], uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_bf16x2(x[2 * i], x[2 * i + 1], h[i], l[i]);
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// A fragments (K3's packing of P for P V) of a 64 x (4 NA) accumulator as
// bf16 pairs hi and lo: k-step kk holds columns [16 kk, 16 kk + 16) of
// this thread's two rows
template <int NA>
__device__ __forceinline__ void pack_a(const float (&x)[NA], uint32_t (&hi)[NA / 8][4],
                                       uint32_t (&lo)[NA / 8][4]) {
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int kk = j >> 1;
    const int ai = (j & 1) * 2;
    split_bf16x2(x[4 * j], x[4 * j + 1], hi[kk][ai], lo[kk][ai]);
    split_bf16x2(x[4 * j + 2], x[4 * j + 3], hi[kk][ai + 1], lo[kk][ai + 1]);
  }
}

// d (+)= A B^T over DH, A and B tiles K-major (hi at a / b, lo one tile
// further where split): hi.hi, + hi.lo where B is split, + lo.hi where A is
template <bool ASPLIT, bool BSPLIT, int DH, int AROWS, int BROWS, int N>
__device__ __forceinline__ void product_ss(float (&d)[N], uint32_t a, uint32_t b) {
  constexpr int ALO = AROWS * DH * 2, BLO = BROWS * DH * 2;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint64_t da = kmajor<DH, AROWS>(a, kk);
    const uint64_t db = kmajor<DH, BROWS>(b, kk);
    mma_ss(d, da, db, kk > 0);
    if constexpr (BSPLIT) mma_ss(d, da, kmajor<DH, BROWS>(b + BLO, kk), 1);
    if constexpr (ASPLIT) mma_ss(d, kmajor<DH, AROWS>(a + ALO, kk), db, 1);
  }
}

// acc[n] += A B over the tile's rows, A a pair in registers (hi, lo) and
// B's tile of BROWS rows read MN-major from column block cb0 + n (hi at b,
// lo one tile further where BSPLIT): hi.hi, + hi.lo where B is split, + lo.hi
template <bool BSPLIT, int DH, int BROWS, int NB, int NR, int KS>
__device__ __forceinline__ void product_rs(float (&acc)[NB][NR], const uint32_t (&hi)[KS][4],
                                           const uint32_t (&lo)[KS][4], uint32_t b, int cb0) {
  constexpr int BLO = BROWS * DH * 2;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const uint64_t db = mnmajor<DH, BROWS>(b, kk, cb0 + n);
      mma_rs(acc[n], hi[kk], db);
      if constexpr (BSPLIT) mma_rs(acc[n], hi[kk], mnmajor<DH, BROWS>(b + BLO, kk, cb0 + n));
      mma_rs(acc[n], lo[kk], db);
    }
  }
}

// cp.async of a bf16 tile of ROWS rows into its operand layout (and lo's
// one tile further where SPLIT); row r comes from `at(r)` (an element
// offset, or -1: a zero row); columns past dh are zeros
template <bool SPLIT, int DH, int ROWS, typename At>
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* hi, const bf16* lo, int dh,
                                          At at) {
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH;
    const int c = i % CH;
    const long long row = at(r);
    const bool ok = row >= 0 && c * 8 < dh;
    const size_t off = ok ? static_cast<size_t>(row) + c * 8 : 0;
    const uint32_t to = dst + swz<DH, ROWS>(r, c);
    uzq::cp_async16(to, hi + off, ok ? 16 : 0);
    if constexpr (SPLIT) uzq::cp_async16(to + ROWS * DH * 2, lo + off, ok ? 16 : 0);
  }
}

// Launch 1: dQ of 64 query rows, its D and dO pairs made from dout and out
// as launch 0 makes them. q/q_lo, k/k_lo, v/v_lo: bf16 operands (lo only
// where SPLIT).
template <bool SPLIT, int DH>
__global__ void __launch_bounds__(THREADS, Plan<SPLIT, DH>::DQ_PER_SM)
flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ q_lo,
             const bf16* __restrict__ k, const bf16* __restrict__ k_lo,
             const bf16* __restrict__ v, const bf16* __restrict__ v_lo,
             const float* __restrict__ out, const float* __restrict__ dout,
             const float* __restrict__ lse, const int* __restrict__ q_positions,
             float* __restrict__ dq, int S, int H, int G, int C, int dh, float scale,
             int window) {
  using P = Plan<SPLIT, DH>;
  constexpr int LO = P::LO, BN = P::BN, TM = P::TM, TN = P::TN, ON = P::ON;
  constexpr int OC = P::OC_Q, NB = OC / ON, NSL = DH / OC, CH = DH / 8;
  constexpr int STAGES = P::DQ_STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;               // [LO][TM]
  uint8_t* sdO = sQ + LO * TM;      // [2][TM]
  uint8_t* ring = sdO + 2 * TM;     // [STAGES][K LO tiles, V LO tiles]

  const int rep = H / G;
  const int R = S * rep;
  const int g = blockIdx.y;
  const int cs = static_cast<int>(blockIdx.x) % NSL;  // dQ's column slice
  const int row0 = static_cast<int>(blockIdx.x) / NSL * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pos0 = q_positions[0];

  // the key tiles the block's rows see
  const int row_last = min(row0 + BM, R) - 1;
  const int qp_first = pos0 + row0 / rep;
  const int qp_last = pos0 + row_last / rep;
  const int kv_begin = window > 0 ? max(0, qp_first - window + 1) : 0;
  const int kv_end = min(C, qp_last + 1);
  const int t_begin = kv_begin / BN;
  const int t_end = kv_end > kv_begin ? (kv_end + BN - 1) / BN : t_begin;

  // element offset of the block's query row r (-1 past R)
  auto qrow = [&](int r) -> long long {
    const int row = row0 + r;
    if (row >= R) return -1;
    const int s = row / rep;
    return (static_cast<long long>(s) * H + g * rep + row % rep) * dh;
  };
  auto load_kv = [&](int t, int stage) {
    const uint32_t dst = smem_u32(ring + stage * P::DQ_STAGE);
    auto slot = [&](int r) -> long long {
      const int c = t * BN + r;
      return c < C ? (static_cast<long long>(c) * G + g) * dh : -1;
    };
    copy_tile<SPLIT, DH, BN>(dst, k, k_lo, dh, slot);
    copy_tile<SPLIT, DH, BN>(dst + LO * TN, v, v_lo, dh, slot);
  };

  copy_tile<SPLIT, DH, BM>(smem_u32(sQ), q, q_lo, dh, qrow);
  uzq::cp_async_commit();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (t_begin + i < t_end) load_kv(t_begin + i, i);
    uzq::cp_async_commit();
  }

  // dO as operand pairs
  for (int i = tid; i < BM * CH; i += THREADS) {
    const int r = i / CH;
    const int c = i % CH;
    const long long row = qrow(r);
    uint4 hi = make_uint4(0u, 0u, 0u, 0u), lo = hi;
    if (row >= 0 && c * 8 < dh) {
      float x[8];
      load8(dout + row + c * 8, x);
      convert8(x, hi, lo);
    }
    *reinterpret_cast<uint4*>(sdO + swz<DH, BM>(r, c)) = hi;
    *reinterpret_cast<uint4*>(sdO + TM + swz<DH, BM>(r, c)) = lo;
  }

  // this thread's two rows of every accumulator fragment, lr0 and lr0 + 8:
  // their L, and D = rowsum(dO * O), each of a row's four threads summing
  // every fourth 8-column chunk (launch 0's order: the same D)
  const int lr0 = 16 * warp + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  float lb[2], dl[2];
  int lo_k[2], hi_k[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = lr0 + 8 * half;
    const long long row = qrow(r);
    float part = 0.f;
    for (int c = 4 * col_t; row >= 0 && c < dh; c += 32) {
      float x[8], o[8];
      load8(dout + row + c, x);
      load8(out + row + c, o);
#pragma unroll
      for (int e = 0; e < 8; ++e) part = fmaf(x[e], o[e], part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dl[half] = part;
    lb[half] = row >= 0 ? lse[row / dh] * LOG2E : 0.f;
    const int qp = pos0 + (row0 + r) / rep;
    lo_k[half] = window > 0 ? qp - window + 1 : 0;
    hi_k[half] = min(qp, C - 1);
  }
  const float sl2 = scale * LOG2E;
  const uint32_t q_base = smem_u32(sQ);
  const uint32_t do_base = smem_u32(sdO);

  float acc[NB][ON / 2];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < ON / 2; ++i) acc[n][i] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) % STAGES;
    if (t + STAGES - 1 < t_end) load_kv(t + STAGES - 1, (stage + STAGES - 1) % STAGES);
    uzq::cp_async_commit();
    uzq::cp_async_wait<STAGES - 1>();
    uzq::fence_async_smem();
    __syncthreads();
    const uint32_t k_base = smem_u32(ring + stage * P::DQ_STAGE);
    const uint32_t v_base = k_base + LO * TN;

    float sc[BN / 2], dp[BN / 2];
    uzq::wg_fence();
    product_ss<SPLIT, SPLIT, DH, BM, BN>(sc, q_base, k_base);
    uzq::wg_commit();
    product_ss<true, SPLIT, DH, BM, BN>(dp, do_base, v_base);
    uzq::wg_commit();
    uzq::wg_wait<1>();
    uzq::fence_regs(sc);

    // P = exp2(S scale log2e - L log2e), zero outside each row's keys
    const int c0 = t * BN;
    const bool full =
        c0 + BN - 1 <= qp_first && c0 + BN <= C && (window <= 0 || c0 > qp_last - window);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const float p = ex2(fmaf(sc[4 * j + e], sl2, -lb[half]));
        const int kp = c0 + 8 * j + col_t + (e & 1);
        sc[4 * j + e] = full || (kp >= lo_k[half] && kp <= hi_k[half]) ? p : 0.f;
      }
    }
    uzq::wg_wait<0>();
    uzq::fence_regs(dp);
    // dS = P (dP - D)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
    uint32_t ahi[BN / 16][4], alo[BN / 16][4];
    pack_a(dp, ahi, alo);

    // dQ += dS K over the tile's keys, K read transposed
#pragma unroll
    for (int n = 0; n < NB; ++n) uzq::fence_regs(acc[n]);
    uzq::wg_fence();
    product_rs<SPLIT, DH, BN>(acc, ahi, alo, k_base, cs * NB);
    uzq::wg_commit();
    uzq::wg_wait<0>();
#pragma unroll
    for (int n = 0; n < NB; ++n) uzq::fence_regs(acc[n]);
    __syncthreads();  // this stage may be refilled
  }
  uzq::cp_async_wait<0>();  // Q's copies, where no key tile was loaded

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long row = qrow(lr0 + 8 * half);
    if (row < 0) continue;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int j = 0; j < ON / 8; ++j) {
        const int col = cs * OC + n * ON + 8 * j + col_t;  // col + 1 < dh with col
        if (col >= dh) continue;
        *reinterpret_cast<float2*>(dq + row + col) =
            make_float2(acc[n][4 * j + 2 * half] * scale, acc[n][4 * j + 2 * half + 1] * scale);
      }
    }
  }
}

// Launch 2: dK and dV of 64 keys (columns [cs * OC, cs * OC + OC)) over
// the query tiles of part blockIdx.z; with parts > 1 the partial sums go
// to slot blockIdx.z of dk/dv ([parts][C][G][dh]).
template <bool SPLIT, int DH>
__global__ void __launch_bounds__(THREADS, Plan<SPLIT, DH>::KV_PER_SM)
flash_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ q_lo,
               const bf16* __restrict__ k, const bf16* __restrict__ k_lo,
               const bf16* __restrict__ v, const bf16* __restrict__ v_lo,
               const bf16* __restrict__ do_hi, const bf16* __restrict__ do_lo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ q_positions, float* __restrict__ dk,
               float* __restrict__ dv, int S, int H, int G, int C, int dh, float scale,
               int window, int parts) {
  using P = Plan<SPLIT, DH>;
  constexpr int LO = P::LO, BN = P::BN, TM = P::TM, TN = P::TN, ON = P::ON;
  constexpr int OC = P::OC_KV, NB = OC / ON, NSL = DH / OC;
  constexpr int STAGES = P::KV_STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = base;             // [LO][TM]
  uint8_t* sV = sK + LO * TM;     // [LO][TM]
  uint8_t* ring = sV + LO * TM;   // [STAGES][Q LO tiles, dO 2 tiles]
  float* sLD = reinterpret_cast<float*>(ring + STAGES * (LO + 2) * TN);  // [STAGES][L, D][BN]

  const int rep = H / G;
  const int R = S * rep;
  const int g = blockIdx.y;
  const int z = blockIdx.z;
  const int cs = static_cast<int>(blockIdx.x) % NSL;
  const int c0 = static_cast<int>(blockIdx.x) / NSL * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pos0 = q_positions[0];

  // this part's query tiles that see any key of [c0, c_last]
  const int row_tiles = (R + BN - 1) / BN;
  const int per = (row_tiles + parts - 1) / parts;
  const int c_last = min(c0 + BM, C) - 1;
  const int s_lo = max(0, c0 - pos0);
  const int s_hi = window > 0 ? min(S - 1, c_last + window - 1 - pos0) : S - 1;
  const int rt_lo = max(s_lo * rep / BN, z * per);
  const int rt_hi = s_lo <= s_hi ? min((s_hi * rep + rep - 1) / BN, (z + 1) * per - 1) : -1;

  const int lr0 = 16 * warp + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  float acc_k[NB][ON / 2], acc_v[NB][ON / 2];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < ON / 2; ++i) acc_k[n][i] = acc_v[n][i] = 0.f;

  if (rt_lo <= rt_hi) {
    auto load_q = [&](int rt, int stage) {
      const uint32_t dst = smem_u32(ring + stage * (LO + 2) * TN);
      auto qrow = [&](int r) -> long long {
        const int row = rt * BN + r;
        if (row >= R) return -1;
        const int s = row / rep;
        return (static_cast<long long>(s) * H + g * rep + row % rep) * dh;
      };
      copy_tile<SPLIT, DH, BN>(dst, q, q_lo, dh, qrow);
      copy_tile<true, DH, BN>(dst + LO * TN, do_hi, do_lo, dh, qrow);
      if (tid < 2 * BN) {
        const int b = tid % BN;
        const int row = rt * BN + b;
        const bool ok = row < R;
        const size_t at = ok ? static_cast<size_t>(row / rep) * H + g * rep + row % rep : 0;
        uzq::cp_async4(smem_u32(sLD + (stage * 2 + tid / BN) * BN + b),
                       (tid < BN ? lse : delta) + at, ok);
      }
    };
    auto slot = [&](int r) -> long long {
      const int c = c0 + r;
      return c < C ? (static_cast<long long>(c) * G + g) * dh : -1;
    };
    copy_tile<SPLIT, DH, BM>(smem_u32(sK), k, k_lo, dh, slot);
    copy_tile<SPLIT, DH, BM>(smem_u32(sV), v, v_lo, dh, slot);
    uzq::cp_async_commit();
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (rt_lo + i <= rt_hi) load_q(rt_lo + i, i);
      uzq::cp_async_commit();
    }

    const float sl2 = scale * LOG2E;
    const uint32_t k_base = smem_u32(sK);
    const uint32_t v_base = smem_u32(sV);
    const int key0 = c0 + lr0;  // this thread's keys: key0 and key0 + 8

    for (int rt = rt_lo; rt <= rt_hi; ++rt) {
      const int stage = (rt - rt_lo) % STAGES;
      if (rt + STAGES - 1 <= rt_hi) load_q(rt + STAGES - 1, (stage + STAGES - 1) % STAGES);
      uzq::cp_async_commit();
      uzq::cp_async_wait<STAGES - 1>();
      uzq::fence_async_smem();
      __syncthreads();
      const uint32_t qt = smem_u32(ring + stage * (LO + 2) * TN);
      const uint32_t dot = qt + LO * TN;
      const float* sL = sLD + stage * 2 * BN;
      const float* sDl = sL + BN;

      float sc[BN / 2], dp[BN / 2];
      uzq::wg_fence();
      product_ss<SPLIT, SPLIT, DH, BM, BN>(sc, k_base, qt);  // S^T = K Q^T
      uzq::wg_commit();
      product_ss<SPLIT, true, DH, BM, BN>(dp, v_base, dot);  // dP^T = V dO^T
      uzq::wg_commit();
      uzq::wg_wait<1>();
      uzq::fence_regs(sc);

      // P^T: rows are keys, columns query rows rt * BN + 8 j + col_t (+1)
      const int rho0 = rt * BN;
      const int qp_min = pos0 + rho0 / rep;
      const int qp_max = pos0 + (rho0 + BN - 1) / rep;
      const bool full = c0 + BM - 1 <= qp_min && (window <= 0 || c0 > qp_max - window);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(sL + 8 * j + col_t);
        const int qp0 = full ? 0 : pos0 + (rho0 + 8 * j + col_t) / rep;
        const int qp1 = full ? 0 : pos0 + (rho0 + 8 * j + col_t + 1) / rep;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lb = ((e & 1) ? l2.y : l2.x) * LOG2E;
          const float p = ex2(fmaf(sc[4 * j + e], sl2, -lb));
          const int key = key0 + 8 * (e >> 1);
          const int qp = (e & 1) ? qp1 : qp0;
          const bool ok = full || (key <= qp && (window <= 0 || key > qp - window));
          sc[4 * j + e] = ok ? p : 0.f;
        }
      }
      uzq::wg_wait<0>();
      uzq::fence_regs(dp);
      // dS^T = P^T (dP^T - D), D of each column
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(sDl + 8 * j + col_t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      uint32_t phi[BN / 16][4], plo[BN / 16][4], shi[BN / 16][4], slo[BN / 16][4];
      pack_a(sc, phi, plo);
      pack_a(dp, shi, slo);

      // dV += P^T dO, dK += dS^T Q over the tile's query rows
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        uzq::fence_regs(acc_v[n]);
        uzq::fence_regs(acc_k[n]);
      }
      uzq::wg_fence();
      product_rs<true, DH, BN>(acc_v, phi, plo, dot, cs * NB);
      product_rs<SPLIT, DH, BN>(acc_k, shi, slo, qt, cs * NB);
      uzq::wg_commit();
      uzq::wg_wait<0>();
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        uzq::fence_regs(acc_v[n]);
        uzq::fence_regs(acc_k[n]);
      }
      __syncthreads();  // this stage may be refilled
    }
  }

  const size_t slot0 = parts > 1 ? static_cast<size_t>(z) * C * G * dh : 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = c0 + lr0 + 8 * half;
    if (c >= C) continue;
    const size_t row = slot0 + (static_cast<size_t>(c) * G + g) * dh;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int j = 0; j < ON / 8; ++j) {
        const int col = cs * OC + n * ON + 8 * j + col_t;
        if (col >= dh) continue;
        *reinterpret_cast<float2*>(dk + row + col) = make_float2(
            acc_k[n][4 * j + 2 * half] * scale, acc_k[n][4 * j + 2 * half + 1] * scale);
        *reinterpret_cast<float2*>(dv + row + col) =
            make_float2(acc_v[n][4 * j + 2 * half], acc_v[n][4 * j + 2 * half + 1]);
      }
    }
  }
}

constexpr int PREP_ROWS = 64;  // query rows a launch-0 block prepares: four threads a row

// Launch 0: for launch 2, D = rowsum(dO * O) of each query row ([S, H]
// rows of dh), its four threads summing every fourth 8-column chunk in
// launch 1's order, and dO as bf16 hi + lo; for f32 inputs, the blocks
// past row_blocks split q, k and v into bf16 hi + lo, 8 values a thread.
template <bool SPLIT>
__global__ void __launch_bounds__(256)
flash_bwd_prep(const float* __restrict__ out, const float* __restrict__ dout,
               bf16* __restrict__ do_hi, bf16* __restrict__ do_lo, float* __restrict__ delta,
               int rows, int dh, int row_blocks, const float* __restrict__ q,
               const float* __restrict__ k, const float* __restrict__ v,
               bf16* __restrict__ q_hi, bf16* __restrict__ q_lo, bf16* __restrict__ k_hi,
               bf16* __restrict__ k_lo, bf16* __restrict__ v_hi, bf16* __restrict__ v_lo,
               size_t nq, size_t nkv) {
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    const int row = blockIdx.x * PREP_ROWS + threadIdx.x / 4;
    const size_t at = static_cast<size_t>(row) * dh;
    float part = 0.f;
    for (int c = 8 * (threadIdx.x & 3); row < rows && c < dh; c += 32) {
      float x[8], o[8];
      load8(dout + at + c, x);
      load8(out + at + c, o);
#pragma unroll
      for (int e = 0; e < 8; ++e) part = fmaf(x[e], o[e], part);
      uint4 hi, lo;
      convert8(x, hi, lo);
      *reinterpret_cast<uint4*>(do_hi + at + c) = hi;
      *reinterpret_cast<uint4*>(do_lo + at + c) = lo;
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (row < rows && (threadIdx.x & 3) == 0) delta[row] = part;
    return;
  }
  if constexpr (SPLIT) {
    size_t i = (static_cast<size_t>(blockIdx.x - row_blocks) * 256 + threadIdx.x) * 8;
    const float* src = q;
    bf16 *hi = q_hi, *lo = q_lo;
    if (i >= nq) {
      i -= nq;
      src = k, hi = k_hi, lo = k_lo;
      if (i >= nkv) {
        i -= nkv;
        src = v, hi = v_hi, lo = v_lo;
        if (i >= nkv) return;
      }
    }
    float x[8];
    load8(src + i, x);
    uint4 h, l;
    convert8(x, h, l);
    *reinterpret_cast<uint4*>(hi + i) = h;
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

// dk/dv [i] = the sum over p of part [p][i], p in order (launch 3)
__global__ void __launch_bounds__(256)
flash_bwd_sum(const float* __restrict__ part_k, const float* __restrict__ part_v,
              float* __restrict__ dk, float* __restrict__ dv, size_t n, int parts) {
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  float a = 0.f, b = 0.f;
  for (int p = 0; p < parts; ++p) {
    a += part_k[p * n + i];
    b += part_v[p * n + i];
  }
  dk[i] = a;
  dv[i] = b;
}

inline int head_dim_instance(int dh) {
  if (dh <= 0 || dh % 8 || dh > 256) return 0;
  return dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
}

// the scratch, carved in the wrapper's order (bwd_scratch_bytes): 256-byte
// aligned pieces
struct Carve {
  uint8_t* at;
  template <typename T>
  T* take(size_t count) {
    T* p = reinterpret_cast<T*>(at);
    at += (count * sizeof(T) + 255) / 256 * 256;
    return p;
  }
};

// The device's side stream for launch 2, made at its first use
// (non-blocking, so it orders against the caller's stream through the two
// events alone, the legacy default stream included)
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t ready = nullptr;  // launch 0 is done: launch 2 may start
  cudaEvent_t done = nullptr;   // launches 2 and 3 are done: the caller's stream goes on
};

// held by a launch from its side stream's first use to its last event, so
// two host threads' launches never interleave their events
inline std::mutex& side_lock() {
  static std::mutex lock;
  return lock;
}

inline cudaError_t side_of(Side** out) {
  static Side sides[uzq::MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= uzq::MAX_DEVICES) return cudaErrorInvalidDevice;
  Side& side = sides[dev];
  if (side.stream == nullptr) {
    cudaStream_t st = nullptr;
    if ((e = cudaEventCreateWithFlags(&side.ready, cudaEventDisableTiming)) != cudaSuccess ||
        (e = cudaEventCreateWithFlags(&side.done, cudaEventDisableTiming)) != cudaSuccess ||
        (e = cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking)) != cudaSuccess)
      return e;
    side.stream = st;
  }
  *out = &side;
  return cudaSuccess;
}

template <bool SPLIT, int DH>
int launch(const void* q, const void* k, const void* v, const int* qpos, const float* out,
           const float* dout, const float* lse, float* dq, float* dk, float* dv,
           uint8_t* scratch, int S, int H, int G, int C, int dh, float scale, int window,
           int parts, cudaStream_t stream) {
  using P = Plan<SPLIT, DH>;
  static int dq_limit[uzq::MAX_DEVICES] = {};
  static int kv_limit[uzq::MAX_DEVICES] = {};
  cudaError_t e = uzq::allow_smem(flash_bwd_dq<SPLIT, DH>, P::DQ_BYTES, dq_limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = uzq::allow_smem(flash_bwd_dkdv<SPLIT, DH>, P::KV_BYTES, kv_limit);
  if (e != cudaSuccess) return static_cast<int>(e);

  std::lock_guard<std::mutex> hold(side_lock());
  Side* side = nullptr;
  if ((e = side_of(&side)) != cudaSuccess) return static_cast<int>(e);

  const size_t nq = static_cast<size_t>(S) * H * dh;
  const size_t nkv = static_cast<size_t>(C) * G * dh;
  Carve cut{scratch};
  float* delta = cut.take<float>(static_cast<size_t>(S) * H);
  bf16* do_hi = cut.take<bf16>(nq);
  bf16* do_lo = cut.take<bf16>(nq);
  const bf16 *qh = static_cast<const bf16*>(q), *kh = static_cast<const bf16*>(k),
             *vh = static_cast<const bf16*>(v);
  const bf16 *ql = nullptr, *kl = nullptr, *vl = nullptr;
  bf16 *sq = nullptr, *sql = nullptr, *sk = nullptr, *skl = nullptr, *sv = nullptr,
       *svl = nullptr;
  unsigned split_blocks = 0;
  if constexpr (SPLIT) {
    sq = cut.take<bf16>(nq);
    sql = cut.take<bf16>(nq);
    sk = cut.take<bf16>(nkv);
    skl = cut.take<bf16>(nkv);
    sv = cut.take<bf16>(nkv);
    svl = cut.take<bf16>(nkv);
    split_blocks = static_cast<unsigned>(((nq + 2 * nkv) / 8 + 255) / 256);
    qh = sq, ql = sql, kh = sk, kl = skl, vh = sv, vl = svl;
  }
  const int row_blocks = (S * H + PREP_ROWS - 1) / PREP_ROWS;
  flash_bwd_prep<SPLIT><<<row_blocks + split_blocks, 256, 0, stream>>>(
      out, dout, do_hi, do_lo, delta, S * H, dh, row_blocks, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v), sq, sql, sk, skl, sv, svl,
      nq, nkv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // dK/dV (and the parts' sum) on the side stream, beside dQ on the caller's
  const int R = S * (H / G);
  constexpr int NSL_Q = DH / P::OC_Q, NSL_KV = DH / P::OC_KV;
  float* part_k = parts > 1 ? cut.take<float>(parts * nkv) : dk;
  float* part_v = parts > 1 ? cut.take<float>(parts * nkv) : dv;
  if ((e = cudaEventRecord(side->ready, stream)) != cudaSuccess ||
      (e = cudaStreamWaitEvent(side->stream, side->ready, 0)) != cudaSuccess)
    return static_cast<int>(e);
  flash_bwd_dkdv<SPLIT, DH>
      <<<dim3((C + BM - 1) / BM * NSL_KV, G, parts), THREADS, P::KV_BYTES, side->stream>>>(
          qh, ql, kh, kl, vh, vl, do_hi, do_lo, lse, delta, qpos, part_k, part_v, S, H, G, C,
          dh, scale, window, parts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (parts > 1) {
    flash_bwd_sum<<<static_cast<unsigned>((nkv + 255) / 256), 256, 0, side->stream>>>(
        part_k, part_v, dk, dv, nkv, parts);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_bwd_dq<SPLIT, DH>
      <<<dim3((R + BM - 1) / BM * NSL_Q, G), THREADS, P::DQ_BYTES, stream>>>(
          qh, ql, kh, kl, vh, vl, out, dout, lse, qpos, dq, S, H, G, C, dh, scale, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaEventRecord(side->done, side->stream)) != cudaSuccess ||
      (e = cudaStreamWaitEvent(stream, side->done, 0)) != cudaSuccess)
    return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool SPLIT, int DH>
int plan_of(int* out) {
  using P = Plan<SPLIT, DH>;
  out[0] = P::BN;
  out[1] = DH / P::OC_KV;
  out[2] = P::KV_PER_SM;
  out[3] = P::DQ_BYTES;
  out[4] = P::KV_BYTES;
  return 0;
}

template <bool SPLIT>
int plan_at(int dh, int* out) {
  switch (head_dim_instance(dh)) {
    case 32:
      return plan_of<SPLIT, 32>(out);
    case 64:
      return plan_of<SPLIT, 64>(out);
    case 128:
      return plan_of<SPLIT, 128>(out);
    case 256:
      return plan_of<SPLIT, 256>(out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool SPLIT>
int dispatch(const void* q, const void* k, const void* v, const int* qpos, const float* out,
             const float* dout, const float* lse, float* dq, float* dk, float* dv,
             uint8_t* scratch, int S, int H, int G, int C, int dh, float scale, int window,
             int parts, cudaStream_t s) {
  switch (head_dim_instance(dh)) {
    case 32:
      return launch<SPLIT, 32>(q, k, v, qpos, out, dout, lse, dq, dk, dv, scratch, S, H, G,
                               C, dh, scale, window, parts, s);
    case 64:
      return launch<SPLIT, 64>(q, k, v, qpos, out, dout, lse, dq, dk, dv, scratch, S, H, G,
                               C, dh, scale, window, parts, s);
    case 128:
      return launch<SPLIT, 128>(q, k, v, qpos, out, dout, lse, dq, dk, dv, scratch, S, H, G,
                                C, dh, scale, window, parts, s);
    case 256:
      return launch<SPLIT, 256>(q, k, v, qpos, out, dout, lse, dq, dk, dv, scratch, S, H, G,
                                C, dh, scale, window, parts, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. The caller guarantees: q [S,H,dh]
// and k/v [C,G,dh] contiguous and 16-byte aligned, of one dtype (bf16 when
// is_bf16, else f32); out (K3's output) and dout f32 [S,H,dh]; lse (K3's
// log-sum-exp of each row's scaled scores) f32 [S,H]; dq f32 [S,H,dh],
// dk/dv f32 [C,G,dh]; scratch of the wrapper's bwd_scratch_bytes, 256-byte
// aligned; dh a positive multiple of 8 up to 256; H % G == 0; q_positions
// int32 on the device; window <= 0 means none; parts >= 1. Launches D and
// dO's pairs (for f32 inputs with q, k and v's), then dQ on `stream` beside
// dK/dV (and with parts > 1 the parts' sum) on the device's side stream,
// which `stream` waits for; returns cudaGetLastError() after them.
extern "C" int uz_flash_attention_bwd(const void* q, const void* k, const void* v, int is_bf16,
                                      const void* q_positions, const void* out,
                                      const void* dout, const void* lse, void* dq, void* dk,
                                      void* dv, void* scratch, int S, int H, int G, int C,
                                      int dh, float scale, int window, int parts,
                                      void* stream) {
  const int* qpos = static_cast<const int*>(q_positions);
  const float* o = static_cast<const float*>(out);
  const float* d_o = static_cast<const float*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* gq = static_cast<float*>(dq);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    return dispatch<false>(q, k, v, qpos, o, d_o, l, gq, gk, gv, sc, S, H, G, C, dh, scale,
                           window, parts, s);
  }
  return dispatch<true>(q, k, v, qpos, o, d_o, l, gq, gk, gv, sc, S, H, G, C, dh, scale,
                        window, parts, s);
}

// The launch shapes of the instantiation that takes dh (f32 inputs unless
// is_bf16), for the wrapper's bwd_plan to be held against: out[0] the rows
// of a streamed tile, out[1] the dK/dV column slices, out[2] the dK/dV
// blocks that share an SM, out[3] and out[4] the shared-memory bytes of a
// dQ block and of a dK/dV block. Host only; launches nothing.
extern "C" int uz_flash_attention_bwd_plan(int dh, int is_bf16, int* out) {
  return is_bf16 ? plan_at<false>(dh, out) : plan_at<true>(dh, out);
}
