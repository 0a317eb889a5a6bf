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
// are f32. f32 q, k and v are carried as bf16 pairs hi + lo (x - hi), three
// products for S (hi.hi + hi.lo + lo.hi) and two for P V: rounding them to
// bf16 alone, as the TPU kernel does, leaves the result 2-5e-2 of RMS off
// the f32 plain version, past the 2e-2 the port holds its kernels to.
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
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (8 bf16 along DH) of row r in a 64-row
// bf16 tile in the 128-byte-swizzled layout: [DH/64][64 rows][128 bytes],
// the chunk index XOR (row % 8) inside each 128-byte row. The same bytes
// are K-major for Q and K (S = Q K^T) and MN-major for V (O += P V).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * SW_ATOM + r * SW_ROW + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  // src-size 0 fills the 16 bytes with zeros (slots past C)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
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
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

template <typename TQ, typename TKV, int DH>
struct Smem {
  static constexpr bool CONVERT = !std::is_same<TKV, __nv_bfloat16>::value;
  static constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  static constexpr bool QLO = std::is_same<TQ, float>::value;   // Q as hi + lo
  static constexpr bool KVLO = std::is_same<TKV, float>::value;  // K, V as hi + lo
  static constexpr int TILE = BQ * DH * 2;  // one bf16 operand tile
  static constexpr int RAW = BK * DH * static_cast<int>(sizeof(TKV));  // one ring tile
  static constexpr int RING = (QLO ? 2 : 1) * TILE;                     // after Q (hi, lo)
  // ring depth: the most stages, up to 4, that keep two blocks on an SM
  // (228 KB, 1 KB reserved per block, 1 KB of alignment slack)
  static constexpr int FIXED = RING + (CONVERT ? (KVLO ? 4 : 2) * TILE : 0);
  static constexpr int PER_STAGE = 2 * RAW + (QUANT ? 2 * BK * 4 : 0);
  static constexpr int STAGES = FIXED + 4 * PER_STAGE <= 114688   ? 4
                                : FIXED + 3 * PER_STAGE <= 114688 ? 3
                                                                  : 2;
  static constexpr int OPS = RING + STAGES * 2 * RAW;  // converted K, V (f32: and lo halves)
  static constexpr int SCALES = OPS + (CONVERT ? (KVLO ? 4 : 2) * TILE : 0);  // [STAGES][k, v][BK]
  static constexpr int BYTES = SCALES + (QUANT ? STAGES * 2 * BK * 4 : 0);
  static constexpr int LAUNCH_BYTES = BYTES + 1024;  // room to align the base to 1024
};

// TQ: the query type; TKV: the cache type (TQ, or int8_t with per-(slot,
// group) scales k_sc/v_sc). part: split scratch (acc [splits, S, H, DH],
// then m and l [splits, S, H]), read when splits > 1.
template <typename TQ, typename TKV, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
          const float* __restrict__ k_sc, const float* __restrict__ v_sc,
          const int* __restrict__ q_positions, const float* __restrict__ sinks,
          float* __restrict__ out, float* __restrict__ part, int S, int H, int G, int C,
          float scale, float soft_cap, int window, int splits, int tiles_per_split) {
  using L = Smem<TQ, TKV, DH>;
  constexpr int CH = DH / 8;                               // bf16 chunks per row
  constexpr int CPR = DH * static_cast<int>(sizeof(TKV)) / 16;  // cp.async per ring row
  constexpr int NH = DH / 64;                              // 64-column blocks of O
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;
  uint8_t* ring = base + L::RING;
  float* sScale = reinterpret_cast<float*>(base + L::SCALES);

  const int rep = H / G;
  const int R = S * rep;
  const int g = blockIdx.y;
  const int z = blockIdx.z;
  const int row0 = blockIdx.x * BQ;
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
  const size_t kv_stride = static_cast<size_t>(G) * DH;  // elements between slots

  constexpr int STAGES = L::STAGES;
  auto load_tile = [&](int t, int stage) {
    const int c0 = t * BK;
    uint8_t* rk = ring + stage * 2 * L::RAW;
    const uint32_t dk = smem_u32(rk);
    const uint32_t dv = dk + L::RAW;
    for (int i = tid; i < BK * CPR; i += THREADS) {
      const int r = i / CPR;
      const int c = i % CPR;
      const bool ok = c0 + r < C;
      const size_t off = ok ? ((static_cast<size_t>(c0 + r) * kv_stride +
                                static_cast<size_t>(g) * DH) * sizeof(TKV) + c * 16)
                            : 0;
      const uint32_t dst = L::CONVERT ? static_cast<uint32_t>(i * 16) : swz(r, c);
      cp_async16(dk + dst, reinterpret_cast<const uint8_t*>(k) + off, ok);
      cp_async16(dv + dst, reinterpret_cast<const uint8_t*>(v) + off, ok);
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

  // Q tile [64, DH] as bf16, zero rows past R
  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH;
    const int c = i % CH;
    const int row = row0 + r;
    uint4 hi = make_uint4(0u, 0u, 0u, 0u);
    uint4 lo = hi;
    if (row < R) {
      const int s = row / rep;
      const int h = g * rep + row % rep;
      const TQ* src = q + (static_cast<size_t>(s) * H + h) * DH + c * 8;
      if constexpr (L::QLO) {
        load8_split(src, hi, lo);
      } else {
        hi = load8_bf16(src);
      }
    }
    *reinterpret_cast<uint4*>(sQ + swz(r, c)) = hi;
    if constexpr (L::QLO) *reinterpret_cast<uint4*>(sQ + L::TILE + swz(r, c)) = lo;
  }

  // this thread's two rows of every accumulator fragment: lr0 and lr0 + 8
  const int lr0 = 16 * warp + (lane >> 2);
  const int qp0 = pos0 + (row0 + lr0) / rep;
  const int qp1 = pos0 + (row0 + lr0 + 8) / rep;
  // each row's visible keys [lo, hi]: causal, window, below C
  const int lo0 = window > 0 ? qp0 - window + 1 : 0;
  const int lo1 = window > 0 ? qp1 - window + 1 : 0;
  const int hi0 = min(qp0, C - 1);
  const int hi1 = min(qp1, C - 1);
  const int col_t = 2 * (lane & 3);
  const float sl2 = scale * LOG2E;
  const float cap_in = soft_cap > 0.f ? scale / soft_cap : 0.f;
  const float cap_out = soft_cap * LOG2E;
  const uint32_t q_base = smem_u32(sQ);

  float o[NH][32];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  float o_unit = 1.f;        // K4: O is held in units of the last tile's u
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max, log2 units
  float l0 = 0.f, l1 = 0.f;  // this thread's part of the running sum

  for (int t = t_begin; t < t_end; ++t) {
    // refill the stage the previous tile used, STAGES - 1 tiles ahead
    const int stage = (t - t_begin) % STAGES;
    if (t + STAGES - 1 < t_end) load_tile(t + STAGES - 1, (stage + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    uint8_t* rk = ring + stage * 2 * L::RAW;
    uint32_t k_base = smem_u32(rk);
    uint32_t v_base = k_base + L::RAW;
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
        const uint32_t at = swz(r, c);
        if constexpr (L::KVLO) {
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

    // S = Q K^T over DH in steps of 16 (32 bytes inside a swizzled row)
    float sc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk >> 2) * SW_ATOM + (kk & 3) * 32;
      const uint64_t qd = sw128_desc(q_base + off, 16, 1024);
      const uint64_t kd = sw128_desc(k_base + off, 16, 1024);
      wgmma_ss(sc, qd, kd, kk > 0);
      if constexpr (L::KVLO) wgmma_ss(sc, qd, sw128_desc(k_base + 2 * L::TILE + off, 16, 1024), 1);
      if constexpr (L::QLO) wgmma_ss(sc, sw128_desc(q_base + L::TILE + off, 16, 1024), kd, 1);
    }
    wg_commit();
    wg_wait0();
    fence_regs(sc);

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

    // p in f32 for the sums; p in bf16 for P V (K4: p * v_scale / u in fp16)
    uint32_t pa[4][4];
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
      for (int j = 0; j < 8; ++j) {
        o[n][4 * j] *= oa0;
        o[n][4 * j + 1] *= oa0;
        o[n][4 * j + 2] *= oa1;
        o[n][4 * j + 3] *= oa1;
      }
    }

    // O += P V: 16 keys a step, V's rows are K-groups of 8 (1024 bytes)
#pragma unroll
    for (int n = 0; n < NH; ++n) fence_regs(o[n]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const uint32_t at = v_base + n * SW_ATOM + kk * 16 * SW_ROW;
        const uint64_t vd = sw128_desc(at, SW_ATOM, 1024);
        if constexpr (L::QUANT) {
          wgmma_rs_f16(o[n], pa[kk], vd);
        } else {
          wgmma_rs(o[n], pa[kk], vd);
        }
        if constexpr (L::KVLO) wgmma_rs(o[n], pa[kk], sw128_desc(at + 2 * L::TILE, SW_ATOM, 1024));
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
      if (sinks != nullptr) {
        const float sk = sinks[h] * LOG2E;
        const float m2 = fmaxf(m, sk);
        const float corr = exp2f(m - m2);
        mul *= corr;
        l = l * corr + exp2f(sk - m2);
      }
      mul /= fmaxf(l, 1e-30f);
      dst = out + (static_cast<size_t>(s) * H + h) * DH;
    } else {
      const size_t pr = static_cast<size_t>(z) * SH + static_cast<size_t>(s) * H + h;
      if ((lane & 3) == 0) {
        float* pm = part + static_cast<size_t>(splits) * SH * DH;
        pm[pr] = m > 0.5f * NEG ? m * LN2 : NEG;  // natural-log units
        pm[static_cast<size_t>(splits) * SH + pr] = l;
      }
      dst = part + pr * DH;
    }
#pragma unroll
    for (int n = 0; n < NH; ++n) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 val = make_float2(o[n][4 * j + 2 * half] * mul,
                                       o[n][4 * j + 2 * half + 1] * mul);
        *reinterpret_cast<float2*>(dst + n * 64 + 8 * j + col_t) = val;
      }
    }
  }
}

template <typename TQ, typename TKV, int DH>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* qpos, const float* sinks, float* out, float* part, int S, int H, int G,
           int C, float scale, float soft_cap, int window, int splits, int tiles_per_split,
           cudaStream_t stream) {
  constexpr int smem = Smem<TQ, TKV, DH>::LAUNCH_BYTES;
  // the shared-memory attribute is per device: set it once on each
  constexpr int MAX_DEVICES = 64;
  static bool attr[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES || !attr[dev]) {
    e = cudaFuncSetAttribute(flash_fwd<TQ, TKV, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) attr[dev] = true;
  }
  const int R = S * (H / G);
  const dim3 grid((R + BQ - 1) / BQ, G, splits);
  flash_fwd<TQ, TKV, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks,
      vs, qpos, sinks, out, part, S, H, G, C, scale, soft_cap, window, splits,
      tiles_per_split);
  if (splits > 1) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int rows = S * H;
    uz_split::flash_combine<DH><<<(rows + 7) / 8, 256, 0, stream>>>(part, sinks, out, S, H,
                                                                   splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int dispatch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
             const int* qpos, const float* sk, float* o, float* part, int S, int H, int G,
             int C, int DH, float scale, float soft_cap, int window, int splits, int tps,
             cudaStream_t s) {
  if (DH == 64) {
    return launch<TQ, TKV, 64>(q, k, v, ks, vs, qpos, sk, o, part, S, H, G, C, scale,
                               soft_cap, window, splits, tps, s);
  }
  if (DH == 128) {
    return launch<TQ, TKV, 128>(q, k, v, ks, vs, qpos, sk, o, part, S, H, G, C, scale,
                                soft_cap, window, splits, tps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points, bound with ctypes. The caller guarantees: q [S,H,DH]
// and k/v [C,G,DH] contiguous, 16-byte aligned; H % G == 0; q_positions
// int32 on the device; sinks f32 [H] or nullptr; soft_cap <= 0 and
// window <= 0 mean none; splits >= 1 ranges of tiles_per_split 64-slot
// tiles covering [0, C), and for splits > 1 an f32 scratch of
// splits * S * H * (DH + 2) values. K3: q, k, v of one dtype (bf16 or
// f32). K4: k/v int8 codes with f32 scales [C,G]; q bf16 or f32. Each
// returns cudaGetLastError() after its launches.
extern "C" int uz_flash_attention(const void* q, const void* k, const void* v, int is_bf16,
                                  const void* q_positions, const void* sinks, void* out, int S,
                                  int H, int G, int C, int DH, float scale, float soft_cap,
                                  int window, int splits, int tiles_per_split, void* scratch,
                                  void* stream) {
  const int* qpos = static_cast<const int*>(q_positions);
  const float* sk = static_cast<const float*>(sinks);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16, __nv_bfloat16>(q, k, v, nullptr, nullptr, qpos, sk, o, part,
                                                  S, H, G, C, DH, scale, soft_cap, window,
                                                  splits, tiles_per_split, s);
  }
  return dispatch<float, float>(q, k, v, nullptr, nullptr, qpos, sk, o, part, S, H, G, C, DH,
                                scale, soft_cap, window, splits, tiles_per_split, s);
}

extern "C" int uz_flash_attention_i8(const void* q, const void* k_codes, const void* k_scales,
                                     const void* v_codes, const void* v_scales, int is_bf16,
                                     const void* q_positions, const void* sinks, void* out,
                                     int S, int H, int G, int C, int DH, float scale,
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
    return dispatch<__nv_bfloat16, int8_t>(q, k_codes, v_codes, ks, vs, qpos, sk, o, part, S,
                                           H, G, C, DH, scale, soft_cap, window, splits,
                                           tiles_per_split, s);
  }
  return dispatch<float, int8_t>(q, k_codes, v_codes, ks, vs, qpos, sk, o, part, S, H, G, C,
                                 DH, scale, soft_cap, window, splits, tiles_per_split, s);
}
