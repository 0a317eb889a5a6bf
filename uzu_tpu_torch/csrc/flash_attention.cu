// Causal GQA flash attention over a contiguous KV cache (K3), and the same
// over an INT8 cache (K4), on Hopper's warpgroup tensor cores.
//
// K3 replaces the TPU kernel uzu_tpu/ops/pallas/flash_attention.py::_kernel_plain
// (launched by _flash_p), K4 its ::_kernel_quant. q is [S, H, DH], the
// cache k/v is [C, G, DH] (slot j holds token position j): bf16 or f32 for
// K3, int8 codes with one f32 scale per (slot, group) in k_scales/v_scales
// [C, G] for K4. Query row s sits at position pos0 + s, with pos0 =
// q_positions[0] read on the device (so a chunked prefill needs no host
// sync). Head h belongs to KV group h / rep (h = g*rep + r, rep = H / G).
// Per row: scores = (q . k) * scale, optional tanh soft cap, causal mask
// kpos <= qpos, optional sliding window kpos > qpos - window, online
// softmax across KV tiles, per-head sinks folded in once after the last
// tile as one extra logit. Output is f32 [S, H, DH].
//
// What bounds it on the H100. At prefill widths (S*rep of 64..2048 rows
// per group over 256..4096 keys) the work is ~4*DH FLOP per (query row,
// visible key) on ~2*DH bytes per key read once: far above the card's
// ~295 FLOP/byte, so the table shape (S=256, C=1024) is bound by
// operations, and those belong on the tensor cores (989 TFLOP/s in bf16;
// the CUDA cores give ~67). A small chunk over a long cache (S=16 at
// C=4096: 64 rows per group) is bound by bytes, and there the grid is the
// problem: one block per (group, 64-row tile) is 8 blocks on 132 SMs.
//
// Design:
// - One block is one warpgroup (128 threads) and owns 64 query rows of one
//   KV group, rows ordered (s, r) so the rep heads of a group share every
//   K/V tile; each row has its own q address (rep need not divide 64).
// - Q's 64 x DH tile is staged once in shared memory as bf16; K/V tiles of
//   64 slots go through a ring of 2-4 stages (as many as keep two blocks on
//   an SM) filled with cp.async (16 bytes a thread), up to 3 tiles ahead of
//   the one that computes. bf16 tiles are wgmma operands where they land,
//   in the 128-byte-swizzled layout its descriptors read; int8 and f32
//   tiles are converted into such operand tiles once they have landed.
// - S = Q K^T is wgmma m64n64k16 with both operands in shared memory and
//   f32 accumulators in registers. Scale, soft cap, mask and the online
//   max/sum run on the accumulator fragment; a row's four threads combine
//   by __shfl_xor_sync. P is rounded to bf16 in registers and is wgmma's
//   register A operand for O += P V (m64n64k16 per 64 columns of DH, V read
//   transposed from shared memory); O stays in registers.
// - DH is 32, 64, 128 or 256. At DH 32 (the hybrids' attention layers) a
//   row is 64 bytes: the operand tiles take the 64-byte swizzle (8-row
//   groups of 512 bytes), S = Q K^T is two k16 steps and O += P V is
//   m64n32k16. From DH 64 a row is DH/64 128-byte atoms (four at DH 256).
//   At DH 256 (Gemma) O is 128 f32 registers a thread beside S's 32, and
//   one bf16 tile is 32 KB: bf16 and int8 caches take a 2-stage ring (one
//   block an SM), and f32 K/V (hi + lo operand tiles, 128 KB) take none:
//   each tile is converted straight from device memory.
// - Past DH 256 (any dh that is a multiple of 8: 512 is Gemma-4's global
//   layers' width) O no longer fits a warpgroup's registers, and a Q tile
//   and a K tile of 512 columns with a V tile pass the shared memory. So a
//   block owns one 256-column slice of O (grid.x is row tiles x
//   ceil(dh / 256) slices; the split plan counts those blocks) and keeps
//   the DH 256 operand layout: per KV tile, S = Q K^T is summed over dh in
//   256-column pieces, each piece of Q and K converted into the operand
//   tiles straight from device memory (bf16 copied, f32 split into hi +
//   lo, int8 codes built as K4 builds them), then the slice's V columns
//   are staged the same way and P V runs as at DH 256. Every slice repeats
//   S (2x the score work at dh 512); there is no ring, so each piece's
//   loads wait for the last piece's products. Simple and right first; this
//   case is compiled apart (WIDE), so DH <= 256 keeps its code.
// - A head dim dh between two instantiations runs in the next one up (24
//   in 32, 200 in 256): the columns past dh of Q, K and V are zero-filled
//   as they load (cp.async's src-size 0, or a zero store), so Q K^T is
//   unchanged, and O's columns past dh are never stored. Every address,
//   the output and the split scratch keep the true dh. An int8 row whose
//   dh is not a multiple of 16 is only 8-byte aligned, and goes by 8-byte
//   copies.
// - KV tiles wholly above the causal diagonal or outside the window are
//   never loaded; per-element masks run only on the diagonal, window-edge
//   and ragged-C tiles. The loop is bound by instruction issue on the CUDA
//   cores, so the score pass is compiled once per case (soft cap or not,
//   mask or not) and picked per tile by uniform branches; with the tests
//   inside the unrolled pass, every tile ran slower on the H100, most of
//   all the soft-cap and window-edge ones.
// - Split KV: when (row tiles x G) is below the SM count, the wrapper cuts
//   the tiles [0, C) into `splits` equal ranges of whole tiles (a plan from
//   S, H, G, C and the SM count only, never from q_positions). Each block
//   (grid.z = range) intersects its range with its own visible keys and
//   writes unnormalized (m, l, acc) to f32 scratch; flash_combine
//   (split_combine.cuh, shared with K5/K6) merges the ranges in a fixed
//   order (no atomics: greedy output repeats), folds the sinks once and
//   normalizes. With one range the main kernel finishes the
//   rows itself and nothing else launches.
//
// Rounding: bf16 q, k and v enter the products as they are, and p is
// rounded to bf16 before P V, as the TPU kernel's _accumulate does; sums
// are f32. That costs each row 2^-9 of its own output, but a row at a
// position below BK sees only the first KV tile's few keys, and its output
// is many times the RMS of a chunk from position 0: at DH 128 the rounding
// reads 2.1-2.4e-2 of that RMS there (S=512 from 0, H 32, G 8), past the
// 2e-2 the port holds its kernels to (a CPU model of the rounding reads
// 1.8e-2 at DH 64, 1.5e-2 at 256, 0.9e-2 at 32). So at DH 128, in the
// first KV tile, such rows take p as a bf16 pair hi + lo (p - hi), one more
// P V product, which the other rows of the block feed zeros; every row from
// position BK on is bitwise as before, blocks with no such row skip the
// product, and the other head dims keep the TPU kernel's rounding bit for
// bit (random-weight greedy streams break near-ties on it). f32 q, k and v are
// carried as bf16 pairs hi + lo (x - hi), three products for S (hi.hi +
// hi.lo + lo.hi) and two for P V: rounding them to bf16 alone, as the TPU
// kernel does, leaves the result 2-5e-2 of RMS off the f32 plain version.
// K4 keeps the cache one byte per value: codes go into the ring as int8
// (half of K3's copy bytes) and become operand tiles in shared memory
// exactly, K's as bf16 and V's as fp16 (every int8 value fits both
// significands; the conversion builds the floats with byte permutes, not
// int-to-float instructions). The scales are folded outside the products:
// score[:, c] = (q . code_k[c]) * k_scale[c] * scale, and P V runs in fp16
// on p[:, c] * v_scale[c] / u, where u is the tile's largest v_scale (so
// the operand lies in [0, 1]) and O, kept in units of u, is rescaled by
// u_old / u_new with the softmax's own per-tile rescale. So K4 rounds no K
// or V value (the TPU kernel rounds codes * scale to bf16), only bf16 q as
// given and p * v_scale / u to fp16; the result is algebraically the plain
// version's codes * scale. bf16 is not enough there: K3's largest p of a
// row is 1 and exact in bf16, but p * v_scale is not, and that term's
// error reached 3.3e-2 of RMS at the main path's first chunk (S=256 from
// position 0), past the port's 2e-2.
//
// Not carried over from the TPU kernel: the lane-replicated stat scratch,
// the iota-matmul sink expansion and the tile-divisibility constraints.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "split_combine.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block: wgmma's M
constexpr int BK = 64;        // KV slots per ring stage
constexpr int THREADS = 128;  // one warpgroup
constexpr int SW_ROW = 128;           // bytes of one swizzled row (64 bf16)
constexpr int SW_ATOM = BQ * SW_ROW;  // one 64-row block of 64 columns
constexpr int SW64_ROW = 64;          // DH 32: one row is 64 bytes (32 bf16)
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (8 bf16 along DH) of row r in a 64-row
// bf16 tile. DH 64 and 128: the 128-byte-swizzled layout [DH/64][64 rows]
// [128 bytes], the chunk index XOR (row % 8) inside each 128-byte row.
// DH 32: rows of 64 bytes in the 64-byte-swizzled layout [64 rows][64
// bytes], the chunk index XOR ((row / 2) % 4), which is what the hardware
// does to address bits 4-5 with bits 7-8 in a 512-byte atom of 8 rows.
// The same bytes are K-major for Q and K (S = Q K^T) and MN-major for V
// (O += P V).
template <int DH>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  if constexpr (DH == 32) {
    return r * SW64_ROW + (((c & 3) ^ ((r >> 1) & 3)) << 4);
  } else {
    return (c >> 3) * SW_ATOM + r * SW_ROW + (((c & 7) ^ (r & 7)) << 4);
  }
}

// wgmma shared-memory descriptor; swizzle mode 1 is 128 bytes, 2 is 64.
template <int DH>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t mode = DH == 32 ? 2ull : 1ull;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  // src-size 0 fills the 16 bytes with zeros (slots past C)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 8 : 0));
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

// keep the compiler from moving accesses of wgmma's registers across the
// asynchronous issue and the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define UZ_D32                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define UZ_R32                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define UZ_D16                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])

#define UZ_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d[64x64] (+)= A[64x16] B[16x64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " UZ_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : UZ_D32
      : "l"(da), "l"(db), "r"(acc));
}

// d[64x64] += A[64x16] (registers, bf16x2) B[16x64]; B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " UZ_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : UZ_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the same with fp16 A (registers, f16x2) and B
__device__ __forceinline__ void wgmma_rs_f16(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " UZ_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : UZ_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// DH 32: d[64x32] += A[64x16] (registers) B[16x32], bf16 and fp16
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " UZ_R16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : UZ_D16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_f16(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 " UZ_R16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : UZ_D16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 8 consecutive bf16 values (16-byte aligned)
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// f32 values as bf16 hi and lo = bf16(x - hi)
__device__ __forceinline__ void load8_split(const float* p, uint4& hi, uint4& lo) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_bf16x2(x[2 * i], x[2 * i + 1], h[i], l[i]);
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// 8 int8 codes as 8 bf16, exact and without int-to-float instructions:
// each byte, offset to unsigned, goes into the mantissa of 2^23 and the
// offset comes off in f32; the integer's f32 has a zero low half, so its
// high half is its bf16.
__device__ __forceinline__ uint4 codes8_bf16(const int8_t* p) {
  const int2 u = *reinterpret_cast<const int2*>(p);
  const uint32_t w[2] = {static_cast<uint32_t>(u.x) ^ 0x80808080u,
                         static_cast<uint32_t>(u.y) ^ 0x80808080u};
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      f[b] = __float_as_uint(__uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 | b)) -
                             8388736.f);  // 2^23 + 128
    }
    out[2 * i] = __byte_perm(f[0], f[1], 0x7632);
    out[2 * i + 1] = __byte_perm(f[2], f[3], 0x7632);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// 8 int8 codes as 8 fp16, exact: 1024 + (code + 128) built in the
// mantissa, 1152 taken off in fp16
__device__ __forceinline__ uint4 codes8_f16(const int8_t* p) {
  const int2 u = *reinterpret_cast<const int2*>(p);
  const uint32_t w[2] = {static_cast<uint32_t>(u.x) ^ 0x80808080u,
                         static_cast<uint32_t>(u.y) ^ 0x80808080u};
  const __half2 off = __half2half2(__ushort_as_half(0x6480));  // 1152
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const uint32_t bits = __byte_perm(w[i], 0x64646464u, b ? 0x4342 : 0x4140);
      const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&bits), off);
      out[2 * i + b] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

__device__ __forceinline__ uint32_t pack_f16x2(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One tile's scores in place, and each of this thread's two rows' max over
// them: K4's k_scale, the soft cap (log2 units after it) where CAP, and
// where MASK the mask to the row's visible keys [lo, hi] (-inf outside).
// The caller picks the case per tile with uniform branches, so each
// unrolled pass carries no instruction of the others.
template <bool QUANT, bool CAP, bool MASK>
__device__ __forceinline__ void score_pass(float (&sc)[32], const float2 (&ks2)[8], int c0,
                                           int col_t, int lo0, int hi0, int lo1, int hi1,
                                           float cap_in, float cap_out, float& mx0,
                                           float& mx1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e];
      if constexpr (QUANT) x *= (e & 1) ? ks2[j].y : ks2[j].x;
      if constexpr (CAP) x = cap_out * tanh_approx(x * cap_in);
      if constexpr (MASK) {
        const int kp = c0 + 8 * j + col_t + (e & 1);
        const bool ok = e < 2 ? (kp >= lo0 && kp <= hi0) : (kp >= lo1 && kp <= hi1);
        x = ok ? x : -CUDART_INF_F;
      }
      sc[4 * j + e] = x;
      if (e < 2) {
        mx0 = fmaxf(mx0, x);
      } else {
        mx1 = fmaxf(mx1, x);
      }
    }
  }
}

template <typename TQ, typename TKV, int DH, bool WIDE>
struct Smem {
  // WIDE: bf16 K/V are staged into the operand tiles too (no ring)
  static constexpr bool CONVERT = !std::is_same<TKV, __nv_bfloat16>::value || WIDE;
  static constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  static constexpr bool QLO = std::is_same<TQ, float>::value;   // Q as hi + lo
  static constexpr bool KVLO = std::is_same<TKV, float>::value;  // K, V as hi + lo
  // f32 K/V at DH 256: no ring (one raw stage would be 128 KB); each tile
  // is converted into its operand tiles straight from device memory
  static constexpr bool DIRECT = (KVLO && DH > 128) || WIDE;
  static constexpr int TILE = BQ * DH * 2;  // one bf16 operand tile
  static constexpr int RAW = DIRECT ? 0 : BK * DH * static_cast<int>(sizeof(TKV));  // ring tile
  static constexpr int RING = (QLO ? 2 : 1) * TILE;                     // after Q (hi, lo)
  // ring depth: the most stages, up to 4, that keep two blocks on an SM
  // (228 KB, 1 KB reserved per block, 1 KB of alignment slack)
  static constexpr int FIXED = RING + (CONVERT ? (KVLO ? 4 : 2) * TILE : 0);
  static constexpr int PER_STAGE = 2 * RAW + (QUANT ? 2 * BK * 4 : 0);
  static constexpr int STAGES = DIRECT                            ? 1
                                : FIXED + 4 * PER_STAGE <= 114688 ? 4
                                : FIXED + 3 * PER_STAGE <= 114688 ? 3
                                                                  : 2;
  static constexpr int OPS = RING + STAGES * 2 * RAW;  // converted K, V (f32: and lo halves)
  static constexpr int SCALES = OPS + (CONVERT ? (KVLO ? 4 : 2) * TILE : 0);  // [STAGES][k, v][BK]
  static constexpr int BYTES = SCALES + (QUANT ? STAGES * 2 * BK * 4 : 0);
  static constexpr int LAUNCH_BYTES = BYTES + 1024;  // room to align the base to 1024
  static_assert(LAUNCH_BYTES <= 232448, "flash_fwd's layout passes 227 KB of shared memory");
};

// The instantiation a head dim runs in: the next of 32, 64, 128, 256 up;
// past 256 the WIDE case of the DH 256 layout, in 256-column slices (0:
// none, dh must be a positive multiple of 8).
constexpr int SLICE = 256;
inline int head_dim_instance(int dh) {
  if (dh <= 0 || dh % 8) return 0;
  return dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
}
__host__ __device__ inline int column_slices(int dh) {
  return dh > SLICE ? (dh + SLICE - 1) / SLICE : 1;
}

// TQ: the query type; TKV: the cache type (TQ, or int8_t with per-(slot,
// group) scales k_sc/v_sc). DH: the instantiation; dh <= DH: the tensors'
// head dim, or WIDE: dh > DH = 256, and the block owns O's columns [cs *
// DH, cs * DH + DH) of cs = blockIdx.x % column_slices(dh). part: split
// scratch (acc [splits, S, H, dh], then m and l [splits, S, H]), read when
// splits > 1.
template <typename TQ, typename TKV, int DH, bool WIDE>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
          const float* __restrict__ k_sc, const float* __restrict__ v_sc,
          const int* __restrict__ q_positions, const float* __restrict__ sinks,
          float* __restrict__ out, float* __restrict__ part, float* __restrict__ lse, int S, int H,
          int G, int C, int dh, float scale, float soft_cap, int window, int splits,
          int tiles_per_split) {
  using L = Smem<TQ, TKV, DH, WIDE>;
  static_assert(!WIDE || DH == SLICE, "the wide case keeps the DH 256 layout");
  constexpr int CH = DH / 8;                               // bf16 chunks per row
  constexpr int CPR = DH * static_cast<int>(sizeof(TKV)) / 16;  // cp.async per ring row
  constexpr int ON = DH < 64 ? DH : 64;                    // columns of one O block
  constexpr int NH = DH / ON;                              // O blocks (wgmma's N = ON)
  constexpr int OR = ON / 2;                               // accumulators per block
  constexpr int ROWB = DH == 32 ? SW64_ROW : SW_ROW;       // bytes of a swizzled row
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;
  uint8_t* ring = base + L::RING;
  float* sScale = reinterpret_cast<float*>(base + L::SCALES);

  const int rep = H / G;
  const int R = S * rep;
  const int g = blockIdx.y;
  const int z = blockIdx.z;
  const int ncs = WIDE ? column_slices(dh) : 1;
  const int cs = WIDE ? static_cast<int>(blockIdx.x) % ncs : 0;  // O's column slice
  const int row0 = (WIDE ? static_cast<int>(blockIdx.x) / ncs : blockIdx.x) * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pos0 = q_positions[0];

  // the KV tiles this block's rows can see, cut to its split range
  const int row_last = min(row0 + BQ, R) - 1;
  const int q_lo = pos0 + row0 / rep;
  const int q_hi = pos0 + row_last / rep;
  const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kv_end = min(C, q_hi + 1);
  const int ntiles = (C + BK - 1) / BK;
  const int t_begin = max(kv_begin / BK, z * tiles_per_split);
  const int t_end = min((kv_end + BK - 1) / BK, min(ntiles, (z + 1) * tiles_per_split));
  const size_t kv_stride = static_cast<size_t>(G) * dh;  // elements between slots
  const int row_bytes = dh * static_cast<int>(sizeof(TKV));  // of one slot's K or V row

  constexpr int STAGES = L::STAGES;
  auto load_tile = [&](int t, int stage) {
    const int c0 = t * BK;
    uint8_t* rk = ring + stage * 2 * L::RAW;
    const uint32_t dk = smem_u32(rk);
    const uint32_t dv = dk + L::RAW;
    const uint8_t* kb = reinterpret_cast<const uint8_t*>(k);
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(v);
    const size_t gro = static_cast<size_t>(g) * row_bytes;
    if constexpr (L::DIRECT) {
      // no ring: the conversion below reads the tile from device memory
    } else if (L::QUANT && (dh & 15)) {
      // int8 rows of a dh that is not a multiple of 16: 8-byte copies
      for (int i = tid; i < BK * CPR * 2; i += THREADS) {
        const int r = i / (2 * CPR);
        const int c = i % (2 * CPR);
        const bool ok = c0 + r < C && c * 8 < row_bytes;
        const size_t off = ok ? static_cast<size_t>(c0 + r) * kv_stride + gro + c * 8 : 0;
        cp_async8(dk + i * 8, kb + off, ok);
        cp_async8(dv + i * 8, vb + off, ok);
      }
    } else {
      for (int i = tid; i < BK * CPR; i += THREADS) {
        const int r = i / CPR;
        const int c = i % CPR;
        const bool ok = c0 + r < C && c * 16 < row_bytes;
        const size_t off =
            ok ? static_cast<size_t>(c0 + r) * kv_stride * sizeof(TKV) + gro + c * 16 : 0;
        const uint32_t dst = L::CONVERT ? static_cast<uint32_t>(i * 16) : swz<DH>(r, c);
        cp_async16(dk + dst, kb + off, ok);
        cp_async16(dv + dst, vb + off, ok);
      }
    }
    if constexpr (L::QUANT) {
      const int r = tid & (BK - 1);
      const bool ok = c0 + r < C;
      const float* src = (tid < BK ? k_sc : v_sc) +
                         (ok ? static_cast<size_t>(c0 + r) * G + g : 0);
      cp_async4(smem_u32(sScale + (stage * 2 + (tid < BK ? 0 : 1)) * BK + r), src, ok);
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (t_begin + i < t_end) load_tile(t_begin + i, i);
    cp_async_commit();
  }

  // Q tile [64, DH] as bf16, zero rows past R and columns past dh; from
  // column col0 on (WIDE: one 256-column piece of dh)
  auto stage_q = [&](int col0) {
    for (int i = tid; i < BQ * CH; i += THREADS) {
      const int r = i / CH;
      const int c = i % CH;
      const int row = row0 + r;
      uint4 hi = make_uint4(0u, 0u, 0u, 0u);
      uint4 lo = hi;
      if (row < R && col0 + c * 8 < dh) {
        const int s = row / rep;
        const int h = g * rep + row % rep;
        const TQ* src = q + (static_cast<size_t>(s) * H + h) * dh + col0 + c * 8;
        if constexpr (L::QLO) {
          load8_split(src, hi, lo);
        } else {
          hi = load8_bf16(src);
        }
      }
      *reinterpret_cast<uint4*>(sQ + swz<DH>(r, c)) = hi;
      if constexpr (L::QLO) *reinterpret_cast<uint4*>(sQ + L::TILE + swz<DH>(r, c)) = lo;
    }
  };
  if constexpr (!WIDE) stage_q(0);

  // this thread's two rows of every accumulator fragment: lr0 and lr0 + 8
  const int lr0 = 16 * warp + (lane >> 2);
  const int qp0 = pos0 + (row0 + lr0) / rep;
  const int qp1 = pos0 + (row0 + lr0 + 8) / rep;
  // each row's visible keys [lo, hi]: causal, window, below C
  const int lo0 = window > 0 ? qp0 - window + 1 : 0;
  const int lo1 = window > 0 ? qp1 - window + 1 : 0;
  const int hi0 = min(qp0, C - 1);
  const int hi1 = min(qp1, C - 1);
  // at DH 128 rows at positions below BK see the first KV tile alone and
  // take p as a bf16 pair there (see Rounding above); uniform over the block
  const bool short_rows = DH == 128 && q_lo < BK;
  const bool short0 = qp0 < BK;
  const bool short1 = qp1 < BK;
  const int col_t = 2 * (lane & 3);
  const float sl2 = scale * LOG2E;
  const float cap_in = soft_cap > 0.f ? scale / soft_cap : 0.f;
  const float cap_out = soft_cap * LOG2E;
  const uint32_t q_base = smem_u32(sQ);

  float o[NH][OR];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int i = 0; i < OR; ++i) o[n][i] = 0.f;
  float o_unit = 1.f;        // K4: O is held in units of the last tile's u
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max, log2 units
  float l0 = 0.f, l1 = 0.f;  // this thread's part of the running sum

  for (int t = t_begin; t < t_end; ++t) {
    // refill the stage the previous tile used, STAGES - 1 tiles ahead
    const int stage = (t - t_begin) % STAGES;
    if (t + STAGES - 1 < t_end) load_tile(t + STAGES - 1, (stage + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    float sc[32];
    uint32_t v_base;
    if constexpr (WIDE) {
      // S over dh in 256-column pieces of Q and K, each converted into the
      // operand tiles from device memory; V's slice cs with the first
      uint8_t* sK = base + L::OPS;
      uint8_t* sV = sK + L::TILE;
      // 8 values of slot `slot`, columns [col, col + 8) of k or v, as
      // operand chunks (hi, and f32's lo); zero past C and past dh
      auto kv8 = [&](const TKV* src, bool is_v, int slot, int col, uint4& hi, uint4& lo) {
        hi = lo = make_uint4(0u, 0u, 0u, 0u);
        if (slot < C && col < dh) {
          const size_t off = static_cast<size_t>(slot) * kv_stride +
                             static_cast<size_t>(g) * dh + col;
          if constexpr (L::KVLO) {
            load8_split(reinterpret_cast<const float*>(src) + off, hi, lo);
          } else if constexpr (L::QUANT) {
            const int8_t* codes = reinterpret_cast<const int8_t*>(src) + off;
            hi = is_v ? codes8_f16(codes) : codes8_bf16(codes);
          } else {
            hi = load8_bf16(reinterpret_cast<const __nv_bfloat16*>(src) + off);
          }
        }
      };
      for (int p = 0; p < ncs; ++p) {
        __syncthreads();  // the last piece's products have read Q and K (p = 0: the scales landed)
        stage_q(p * DH);
        for (int i = tid; i < BK * CH; i += THREADS) {
          const int r = i / CH;
          const int c = i % CH;
          const uint32_t at = swz<DH>(r, c);
          uint4 hi, lo;
          kv8(k, false, t * BK + r, p * DH + c * 8, hi, lo);
          *reinterpret_cast<uint4*>(sK + at) = hi;
          if constexpr (L::KVLO) *reinterpret_cast<uint4*>(sK + 2 * L::TILE + at) = lo;
          if (p == 0) {
            kv8(v, true, t * BK + r, cs * DH + c * 8, hi, lo);
            *reinterpret_cast<uint4*>(sV + at) = hi;
            if constexpr (L::KVLO) *reinterpret_cast<uint4*>(sV + 2 * L::TILE + at) = lo;
          }
        }
        fence_async_smem();
        __syncthreads();
        const uint32_t k_base = smem_u32(sK);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const uint32_t off = (kk >> 2) * SW_ATOM + (kk & 3) * 32;
          const uint64_t qd = sw_desc<DH>(q_base + off, 16, 8 * ROWB);
          const uint64_t kd = sw_desc<DH>(k_base + off, 16, 8 * ROWB);
          wgmma_ss(sc, qd, kd, p > 0 || kk > 0);
          if constexpr (L::KVLO) {
            wgmma_ss(sc, qd, sw_desc<DH>(k_base + 2 * L::TILE + off, 16, 8 * ROWB), 1);
          }
          if constexpr (L::QLO) {
            wgmma_ss(sc, sw_desc<DH>(q_base + L::TILE + off, 16, 8 * ROWB), kd, 1);
          }
        }
        wg_commit();
        wg_wait0();
        fence_regs(sc);
      }
      v_base = smem_u32(sV);
    } else {
      uint8_t* rk = ring + stage * 2 * L::RAW;
      uint32_t k_base = smem_u32(rk);
      v_base = k_base + L::RAW;
      if constexpr (L::CONVERT) {
        __syncthreads();  // every thread's copies of this stage have landed
        using TR = typename std::conditional<L::QUANT, int8_t, float>::type;
        const TR* raw_k = reinterpret_cast<const TR*>(rk);
        const TR* raw_v = reinterpret_cast<const TR*>(rk + L::RAW);
        uint8_t* sK = base + L::OPS;
        uint8_t* sV = sK + L::TILE;
        for (int i = tid; i < BK * CH; i += THREADS) {
          const int r = i / CH;
          const int c = i % CH;
          const uint32_t at = swz<DH>(r, c);
          if constexpr (L::DIRECT) {
            // f32 K/V from device memory, zero past C and past dh
            const int slot = t * BK + r;
            uint4 hi = make_uint4(0u, 0u, 0u, 0u), lo = hi, vh = hi, vl = hi;
            if (slot < C && c * 8 < dh) {
              const size_t off = static_cast<size_t>(slot) * kv_stride +
                                 static_cast<size_t>(g) * dh + c * 8;
              load8_split(reinterpret_cast<const float*>(k) + off, hi, lo);
              load8_split(reinterpret_cast<const float*>(v) + off, vh, vl);
            }
            *reinterpret_cast<uint4*>(sK + at) = hi;
            *reinterpret_cast<uint4*>(sK + 2 * L::TILE + at) = lo;
            *reinterpret_cast<uint4*>(sV + at) = vh;
            *reinterpret_cast<uint4*>(sV + 2 * L::TILE + at) = vl;
          } else if constexpr (L::KVLO) {
            uint4 hi, lo;
            load8_split(raw_k + r * DH + c * 8, hi, lo);
            *reinterpret_cast<uint4*>(sK + at) = hi;
            *reinterpret_cast<uint4*>(sK + 2 * L::TILE + at) = lo;
            load8_split(raw_v + r * DH + c * 8, hi, lo);
            *reinterpret_cast<uint4*>(sV + at) = hi;
            *reinterpret_cast<uint4*>(sV + 2 * L::TILE + at) = lo;
          } else {
            *reinterpret_cast<uint4*>(sK + at) = codes8_bf16(raw_k + r * DH + c * 8);
            *reinterpret_cast<uint4*>(sV + at) = codes8_f16(raw_v + r * DH + c * 8);
          }
        }
        k_base = smem_u32(sK);
        v_base = smem_u32(sV);
      }
      fence_async_smem();
      __syncthreads();

      // S = Q K^T over DH in steps of 16 (32 bytes inside a swizzled row);
      // a group of 8 rows is 8 * ROWB bytes
      wg_fence();
  #pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk >> 2) * SW_ATOM + (kk & 3) * 32;
        const uint64_t qd = sw_desc<DH>(q_base + off, 16, 8 * ROWB);
        const uint64_t kd = sw_desc<DH>(k_base + off, 16, 8 * ROWB);
        wgmma_ss(sc, qd, kd, kk > 0);
        if constexpr (L::KVLO) {
          wgmma_ss(sc, qd, sw_desc<DH>(k_base + 2 * L::TILE + off, 16, 8 * ROWB), 1);
        }
        if constexpr (L::QLO) {
          wgmma_ss(sc, sw_desc<DH>(q_base + L::TILE + off, 16, 8 * ROWB), kd, 1);
        }
      }
      wg_commit();
      wg_wait0();
      fence_regs(sc);
    }

    const int c0 = t * BK;
    const bool full = c0 + BK - 1 <= q_lo && c0 + BK <= C && (window <= 0 || c0 > q_hi - window);
    const float* ksc = sScale + stage * 2 * BK;
    const float* vsc = ksc + BK;
    // this thread's 16 columns' scales, two adjacent columns a load
    float2 ks2[8], vs2[8];
    if constexpr (L::QUANT) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ks2[j] = *reinterpret_cast<const float2*>(ksc + 8 * j + col_t);
        vs2[j] = *reinterpret_cast<const float2*>(vsc + 8 * j + col_t);
      }
    }
    // K4: P V runs in fp16 on p * v_scale / u, u the tile's largest
    // v_scale (so the operand stays in [0, 1]); O is kept in units of u
    float inv_u = 1.f, u_ratio = 1.f;
    if constexpr (L::QUANT) {
      float u = fmaxf(vsc[lane], vsc[lane + 32]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) u = fmaxf(u, __shfl_xor_sync(0xffffffffu, u, off));
      u = fmaxf(u, 1e-30f);
      inv_u = 1.f / u;
      u_ratio = o_unit * inv_u;
      o_unit = u;
    }
    // scores stay raw (K4: times k_scale) and go to log2 units inside the
    // exponent's FMA; masked scores are -inf, and a row that has seen no
    // key yet exponentiates against 0 instead of its -inf max
    const float fac = soft_cap > 0.f ? 1.f : sl2;
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
    if (soft_cap > 0.f) {
      if (full) {
        score_pass<L::QUANT, true, false>(sc, ks2, c0, col_t, lo0, hi0, lo1, hi1, cap_in,
                                          cap_out, mx0, mx1);
      } else {
        score_pass<L::QUANT, true, true>(sc, ks2, c0, col_t, lo0, hi0, lo1, hi1, cap_in,
                                         cap_out, mx0, mx1);
      }
    } else if (full) {
      score_pass<L::QUANT, false, false>(sc, ks2, c0, col_t, lo0, hi0, lo1, hi1, cap_in,
                                         cap_out, mx0, mx1);
    } else {
      score_pass<L::QUANT, false, true>(sc, ks2, c0, col_t, lo0, hi0, lo1, hi1, cap_in,
                                        cap_out, mx0, mx1);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0 * fac);
    const float mn1 = fmaxf(m1, mx1 * fac);
    const float mu0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float mu1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float a0 = ex2(m0 - mu0);
    const float a1 = ex2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;

    // p in f32 for the sums; p in bf16 for P V (K4: p * v_scale / u in
    // fp16), and in the first tile p - bf16(p) for the short rows (pl, zero
    // for the other rows)
    const bool pair = !L::QUANT && short_rows && c0 == 0;
    uint32_t pa[4][4], pl[4][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = ex2(fmaf(sc[4 * j + e], fac, e < 2 ? -mu0 : -mu1));
      ps0 += p[0] + p[1];
      ps1 += p[2] + p[3];
      // A fragment of k-step j/2: rows lr0 / lr0+8, key columns 2t.. and 8+2t..
      const int kk = j >> 1;
      const int ai = (j & 1) * 2;
      if constexpr (L::QUANT) {
        const float va = vs2[j].x * inv_u;
        const float vb = vs2[j].y * inv_u;
        pa[kk][ai] = pack_f16x2(p[0] * va, p[1] * vb);
        pa[kk][ai + 1] = pack_f16x2(p[2] * va, p[3] * vb);
      } else if (pair) {
        split_bf16x2(p[0], p[1], pa[kk][ai], pl[kk][ai]);
        split_bf16x2(p[2], p[3], pa[kk][ai + 1], pl[kk][ai + 1]);
        if (!short0) pl[kk][ai] = 0u;
        if (!short1) pl[kk][ai + 1] = 0u;
      } else {
        pa[kk][ai] = pack_bf16x2(p[0], p[1]);
        pa[kk][ai + 1] = pack_bf16x2(p[2], p[3]);
      }
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    const float oa0 = a0 * u_ratio;
    const float oa1 = a1 * u_ratio;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
#pragma unroll
      for (int j = 0; j < OR / 4; ++j) {
        o[n][4 * j] *= oa0;
        o[n][4 * j + 1] *= oa0;
        o[n][4 * j + 2] *= oa1;
        o[n][4 * j + 3] *= oa1;
      }
    }

    // O += P V: 16 keys a step, V's rows are K-groups of 8 (8 * ROWB bytes)
#pragma unroll
    for (int n = 0; n < NH; ++n) fence_regs(o[n]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const uint32_t at = v_base + n * SW_ATOM + kk * 16 * ROWB;
        const uint64_t vd = sw_desc<DH>(at, SW_ATOM, 8 * ROWB);
        if constexpr (L::QUANT) {
          wgmma_rs_f16(o[n], pa[kk], vd);
        } else {
          wgmma_rs(o[n], pa[kk], vd);
          if (pair) wgmma_rs(o[n], pl[kk], vd);
        }
        if constexpr (L::KVLO) {
          wgmma_rs(o[n], pa[kk], sw_desc<DH>(at + 2 * L::TILE, SW_ATOM, 8 * ROWB));
        }
      }
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int n = 0; n < NH; ++n) fence_regs(o[n]);
    __syncthreads();  // this stage (and the bf16 K/V tiles) may be refilled
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  const size_t SH = static_cast<size_t>(S) * H;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + lr0 + 8 * half;
    if (row >= R) continue;
    const int s = row / rep;
    const int h = g * rep + row % rep;
    const float m = half ? m1 : m0;
    float l = half ? l1 : l0;
    float mul = o_unit;
    float* dst;
    if (splits == 1) {
      // the row's log-sum-exp of its scaled scores (m is in log2 units), before the sinks
      if (lse != nullptr && (lane & 3) == 0 && cs == 0) lse[s * H + h] = m * LN2 + logf(l);
      if (sinks != nullptr) {
        const float sk = sinks[h] * LOG2E;
        const float m2 = fmaxf(m, sk);
        const float corr = exp2f(m - m2);
        mul *= corr;
        l = l * corr + exp2f(sk - m2);
      }
      mul /= fmaxf(l, 1e-30f);
      dst = out + (static_cast<size_t>(s) * H + h) * dh;
    } else {
      const size_t pr = static_cast<size_t>(z) * SH + static_cast<size_t>(s) * H + h;
      if ((lane & 3) == 0 && cs == 0) {
        float* pm = part + static_cast<size_t>(splits) * SH * dh;
        pm[pr] = m > 0.5f * NEG ? m * LN2 : NEG;  // natural-log units
        pm[static_cast<size_t>(splits) * SH + pr] = l;
      }
      dst = part + pr * dh;
    }
#pragma unroll
    for (int n = 0; n < NH; ++n) {
#pragma unroll
      for (int j = 0; j < OR / 4; ++j) {
        const int col = cs * DH + n * ON + 8 * j + col_t;  // col + 1: below dh with col
        if (col >= dh) continue;
        const float2 val = make_float2(o[n][4 * j + 2 * half] * mul,
                                       o[n][4 * j + 2 * half + 1] * mul);
        *reinterpret_cast<float2*>(dst + col) = val;
      }
    }
  }
}

template <typename TQ, typename TKV, int DH, bool WIDE = false>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* qpos, const float* sinks, float* out, float* part, float* lse, int S,
           int H, int G, int C, int dh, float scale, float soft_cap, int window, int splits,
           int tiles_per_split, cudaStream_t stream) {
  constexpr int smem = Smem<TQ, TKV, DH, WIDE>::LAUNCH_BYTES;
  // the shared-memory attribute is per device: set it once on each
  constexpr int MAX_DEVICES = 64;
  static bool attr[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES || !attr[dev]) {
    e = cudaFuncSetAttribute(flash_fwd<TQ, TKV, DH, WIDE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) attr[dev] = true;
  }
  const int R = S * (H / G);
  const int ncs = WIDE ? column_slices(dh) : 1;
  const dim3 grid((R + BQ - 1) / BQ * ncs, G, splits);
  flash_fwd<TQ, TKV, DH, WIDE><<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks,
      vs, qpos, sinks, out, part, lse, S, H, G, C, dh, scale, soft_cap, window, splits,
      tiles_per_split);
  if (splits > 1) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int rows = S * H;
    uz_split::flash_combine<DH, WIDE><<<dim3((rows + 7) / 8, ncs), 256, 0, stream>>>(
        part, sinks, out, S, H, dh, splits, lse);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int dispatch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
             const int* qpos, const float* sk, float* o, float* part, float* lse, int S, int H,
             int G, int C, int dh, float scale, float soft_cap, int window, int splits, int tps,
             cudaStream_t s) {
  switch (head_dim_instance(dh)) {
    case 32:
      return launch<TQ, TKV, 32>(q, k, v, ks, vs, qpos, sk, o, part, lse, S, H, G, C, dh,
                                 scale, soft_cap, window, splits, tps, s);
    case 64:
      return launch<TQ, TKV, 64>(q, k, v, ks, vs, qpos, sk, o, part, lse, S, H, G, C, dh,
                                 scale, soft_cap, window, splits, tps, s);
    case 128:
      return launch<TQ, TKV, 128>(q, k, v, ks, vs, qpos, sk, o, part, lse, S, H, G, C, dh,
                                  scale, soft_cap, window, splits, tps, s);
    case 256:
      if (dh > SLICE) {
        return launch<TQ, TKV, 256, true>(q, k, v, ks, vs, qpos, sk, o, part, lse, S, H, G, C,
                                          dh, scale, soft_cap, window, splits, tps, s);
      }
      return launch<TQ, TKV, 256>(q, k, v, ks, vs, qpos, sk, o, part, lse, S, H, G, C, dh,
                                  scale, soft_cap, window, splits, tps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. The caller guarantees: q [S,H,dh]
// and k/v [C,G,dh] contiguous, 16-byte aligned, dh a positive multiple
// of 8 (up to 256 run in the next instantiation up, past it in 256-column
// slices: splits counts blocks of every slice); H % G == 0; q_positions
// int32 on the device; sinks f32 [H] or nullptr; soft_cap <= 0 and
// window <= 0 mean none; splits >= 1 ranges of tiles_per_split 64-slot
// tiles covering [0, C), and for splits > 1 an f32 scratch of
// splits * S * H * (dh + 2) values. K3: q, k, v of one dtype (bf16 or
// f32), and lse f32 [S,H] or nullptr: where given, each row's log-sum-exp
// of its scaled scores (natural log, sinks left out) is written there; the
// output is the same bits either way. K4: k/v int8 codes with f32 scales
// [C,G]; q bf16 or f32. Each returns cudaGetLastError() after its launches.
extern "C" int uz_flash_attention(const void* q, const void* k, const void* v, int is_bf16,
                                  const void* q_positions, const void* sinks, void* out, int S,
                                  int H, int G, int C, int dh, float scale, float soft_cap,
                                  int window, int splits, int tiles_per_split, void* scratch,
                                  void* lse, void* stream) {
  const int* qpos = static_cast<const int*>(q_positions);
  const float* sk = static_cast<const float*>(sinks);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(scratch);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16, __nv_bfloat16>(q, k, v, nullptr, nullptr, qpos, sk, o, part,
                                                  l, S, H, G, C, dh, scale, soft_cap, window,
                                                  splits, tiles_per_split, s);
  }
  return dispatch<float, float>(q, k, v, nullptr, nullptr, qpos, sk, o, part, l, S, H, G, C,
                                dh, scale, soft_cap, window, splits, tiles_per_split, s);
}

extern "C" int uz_flash_attention_i8(const void* q, const void* k_codes, const void* k_scales,
                                     const void* v_codes, const void* v_scales, int is_bf16,
                                     const void* q_positions, const void* sinks, void* out,
                                     int S, int H, int G, int C, int dh, float scale,
                                     float soft_cap, int window, int splits,
                                     int tiles_per_split, void* scratch, void* stream) {
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* qpos = static_cast<const int*>(q_positions);
  const float* sk = static_cast<const float*>(sinks);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16, int8_t>(q, k_codes, v_codes, ks, vs, qpos, sk, o, part,
                                           nullptr, S, H, G, C, dh, scale, soft_cap, window,
                                           splits, tiles_per_split, s);
  }
  return dispatch<float, int8_t>(q, k_codes, v_codes, ks, vs, qpos, sk, o, part, nullptr, S, H,
                                 G, C, dh, scale, soft_cap, window, splits, tiles_per_split, s);
}
