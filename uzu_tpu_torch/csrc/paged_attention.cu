// Paged decode attention over shared page pools (K5), and the same over
// INT8 pools (K6), on Hopper's tensor cores with split KV.
//
// K5 replaces the TPU kernel uzu_tpu/ops/pallas/paged_attention.py::_kernel
// (launched by _paged_p), K6 replaces ::_kernel_i8 (launched by
// _paged_p_i8); both fold tiles with ::_flash_update. One query token per
// slot: q is [B, H, DH]; the pools are [G, P, page, DH] (bf16 or f32 for
// K5; int8 codes for K6, with one f32 scale per (group, page, offset) in
// k_scales/v_scales [G, P, page]); logical page j of slot b is physical
// page table[b, j] (table [B, MAXP] int32); slot b sees tokens [0,
// lengths[b]). Head h belongs to KV group h / rep (rep = H / G). Per head:
// scores = (q . k) * scale (K6: (q . code_k) * k_scale[token] * scale),
// optional tanh soft cap, then the mask: tokens at or past length, and
// before length - window, are dropped; softmax over the live tokens, with
// per-head sinks folded in once as one extra logit. Output is f32 [B, H,
// DH].
//
// What bounds it on the H100. Each live K/V row is read once and meets rep
// query heads: ~4*DH FLOP per (head, token) over rep = 4 or 8 heads, ~2-4
// FLOP per byte of a bf16 pool against the card's ~295, so the work is
// bound by the bytes of the live pages (B=8 x 1024 tokens of the flagship:
// 16.8 MB bf16, 8.9 MB int8 with its scales; 5.0 / 2.7 us at 3.35 TB/s).
// What matters is keeping enough bytes in flight on enough SMs.
//
// Design:
// - Split KV, from shapes only. The grid is (B, G, splits): where B * G
//   blocks would not fill the SMs, the wrapper deals the 64-token tiles of
//   the table's width [0, MAXP * page) to `splits` blocks, split z taking
//   tiles z, z + splits, ... (a plan from B, G, the width and the SM count,
//   never from lengths: no host sync, and a captured step keeps its
//   launch). The live tokens are a prefix of the width, or a window ending
//   at the length, so interleaved tiles share them evenly whatever the
//   lengths, where equal ranges left every range past a short slot idle
//   (1024 live tokens in a 4096-token table ran on a quarter of the
//   blocks). A block intersects its tiles with its slot's live
//   tokens [max(0, length - window), min(length, width)); one left with
//   none writes m = -1e30, l = 0, acc = 0 and returns. With more than one
//   split, the blocks write unnormalized (m, l, acc) to f32 scratch and
//   flash_combine (split_combine.cuh, shared with K3/K4) merges them in a
//   fixed order, folds the sinks once and normalizes; it is launched as a
//   programmatic dependent, so its launch overlaps this kernel. With one
//   split the block does that itself and nothing else launches. No
//   atomics: greedy output repeats from run to run.
// - A cp.async ring in the pools' own types. K and V tiles of 64 tokens go
//   into shared memory as stored (bf16, f32, or int8 codes plus their f32
//   scales), 16 bytes a thread, through 2-4 stages (as many as keep two
//   blocks on an SM), up to 3 tiles ahead of the one that computes; the
//   copies ask the L2 to evict their lines first and to fetch 256 bytes at
//   a time (K/V rows are read once per step). Each
//   row's address comes from the table, ((g * P + table[b, pos / page]) *
//   page + pos % page) * DH, so a tile may cross pages of any size; rows
//   outside the live range are zero-filled (cp.async's src-size 0) and
//   masked. The page numbers of a tile's rows are read one tile ahead of
//   its copy, so the table's latency overlaps compute instead of stalling
//   the ring. Chunks are
//   XOR-swizzled per row so that the fragment reads below hit distinct
//   banks.
// - Both products on the tensor cores, mma.sync m16n8k16. The group's rep
//   heads are the 16 rows of M (12 of 16 rows are padding at rep 4, 8 at
//   rep 8; at ~2 FLOP per byte that costs nothing measurable), each of the
//   4 warps takes 16 tokens of every tile, and two n8 score tiles are the
//   register A operand of P V as they stand, so P never touches shared
//   memory. The contraction index of Q K^T is permuted so that each thread
//   reads its K fragment as contiguous 16-byte chunks of one token row, and
//   the output columns of P V are permuted so that each thread reads V's
//   transposed fragment as contiguous chunks of four token rows and pairs
//   them with byte permutes (no ldmatrix, which has no 8-bit transpose).
//   Each warp carries its own (m, l, acc) across tiles; the block merges
//   its warps' states once, in a fixed order, at the end of its tiles: no
//   softmax barrier per tile. wgmma needs 64 rows of M and does not fit a
//   4-16-row query.
// - The score pass is compiled once per case (soft cap or not, mask or
//   not) and picked per 16 tokens with uniform branches.
// - DH is 64, 128 or 256. At DH 256 (Gemma) a warp's O is 128 f32
//   registers a thread, so Q's fragments go to shared memory (written once
//   by warp 0) instead of registers, and K and V fragments are read one
//   16-byte chunk at a time and used at once. The ring is 2 stages of bf16
//   (one block an SM), 3 of int8, and 1 of f32 pools (a 128 KB stage: the
//   copy of the next tile then waits for the current one's compute).
// - Past DH 256 (any dh that is a multiple of 8; 512 is Gemma-4's global
//   layers' width) a warp's O would be 256 registers a thread and a K/V
//   stage 128-256 KB. So a block owns one 256-column slice of O (grid.y
//   is G x ceil(dh / 256) slices; the split plan counts those blocks) and
//   keeps the DH 256 layout (WIDE): per tile, S = Q K^T is summed over dh
//   in 256-column pieces, each piece's K columns copied into one ring
//   stage and its Q fragments written to shared memory by warp 0; the
//   slice's V columns (and K6's scales) come with the first piece, and
//   P V runs as at DH 256. No ring: each piece's copy waits for the last
//   piece's products, and every slice repeats S. Simple and right first;
//   compiled apart, so DH <= 256 keeps its code.
// - A head dim dh between two instantiations runs in the next one up (24
//   and 32 in 64, 200 in 256): Q's and the ring's columns past dh are
//   zero-filled as they load, so Q K^T is unchanged, and O's columns past
//   dh are never stored. Page rows, the output and the split scratch keep
//   the true dh. An int8 row whose dh is not a multiple of 16 is only
//   8-byte aligned, and goes by 8-byte copies.
//
// Rounding, as K3/K4 settle it (flash_attention.cu): bf16 q and k enter
// Q K^T as they are and p is rounded to bf16 before P V, as the TPU kernel
// does (paged_attention.py:69); sums are f32. f32 q and pools are carried
// as bf16 pairs hi + lo (three products for Q K^T, two for P V). K6 keeps
// the pools one byte per value: the codes become exact operands in
// registers, K's as bf16 and V's as fp16, built with byte permutes; scores
// are (q . code_k) * k_scale * scale, and P V runs in fp16 on p * v_scale /
// u, u the largest v_scale of the warp's 16 tokens (the operand lies in [0,
// 1]), with O kept in units of u and rescaled by u_old / u_new with the
// softmax's own rescale (bf16 p * v_scale missed the 2e-2 limit in K4).
//
// Not carried over from the TPU kernels: the 8-sublane query padding, the
// lane-replicated running stats, the DMA clamping of dead grid steps, the
// 8-row scale windows of K6, and the page % 32 rule for int8 pools (all
// Mosaic tiling constraints).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "split_combine.cuh"

namespace {

constexpr int BT = 64;        // tokens per ring stage
constexpr int WARPS = 4;      // each takes 16 tokens of a tile
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_REP = 16;   // query heads per KV group: the rows of M
constexpr float NEG = uz_split::NEG;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An L2 policy that evicts first the lines loaded under it: K/V rows are
// read once per step, and should not push other data out of the L2.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok,
                                           uint64_t pol) {
  // src-size 0 fills the 16 bytes with zeros (rows outside the live range);
  // the L2 fetches the 256 bytes around each access
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint.L2::256B [%0], [%1], 16, %2, %3;\n" ::"r"(dst),
      "l"(src), "r"(ok ? 16 : 0), "l"(pol));
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f16x2(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as a bf16x2 pair hi and the rest lo = bf16x2(x - hi)
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(a - back.x, b - back.y);
}

// 4 int8 codes (one word) as 4 bf16 (two words), exact and without
// int-to-float instructions: each byte, offset to unsigned, goes into the
// mantissa of 2^23 and the offset comes off in f32; the integer's f32 has
// a zero low half, so its high half is its bf16.
__device__ __forceinline__ void codes4_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  w ^= 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    f[b] = __float_as_uint(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | b)) -
                           8388736.f);  // 2^23 + 128
  }
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

// Two codes, each already offset to unsigned (x ^ 0x80), in bytes 0 and 1
// (sel 0x4140) or 2 and 3 (sel 0x4342) of x, as an exact fp16 pair: 1024 +
// (code + 128) built in the mantissa, 1152 taken off in fp16.
__device__ __forceinline__ uint32_t codes2_f16(uint32_t x, uint32_t sel) {
  const uint32_t bits = __byte_perm(x, 0x64646464u, sel);
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&bits),
                            __half2half2(__ushort_as_half(0x6480)));  // 1152
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D (16x8, f32) += A (16x16, row) B (16x8, col), bf16 or fp16 operands
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename TQ, typename TKV, int DH, bool WIDE>
struct Layout {
  static constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  static constexpr bool KVLO = std::is_same<TKV, float>::value;  // K, V as hi + lo
  static constexpr bool QLO = std::is_same<TQ, float>::value;    // Q as hi + lo
  static constexpr int RB = DH * static_cast<int>(sizeof(TKV));  // bytes of a K or V row
  static constexpr int NC = RB / 16;  // 16-byte chunks per row
  static constexpr int KB = RB / 4;   // K bytes of a token row one thread reads
  static constexpr int VB = RB / 8;   // V bytes of a token row one thread reads
  static constexpr int TILE = BT * RB;
  static constexpr int STAGE = 2 * TILE + (QUANT ? 2 * BT * 4 : 0);  // K, V, [k, v scales]
  // DH 256: Q's A fragments [hi, lo][DH / 16 k-steps][32 lanes] in shared
  // memory, after the ring (O's registers leave no room for them)
  static constexpr bool QS = DH > 128;
  static constexpr int QBYTES = QS ? (QLO ? 2 : 1) * (DH / 16) * 32 * 16 : 0;
  // the most stages, up to 4, that keep two blocks on an SM; else 2, or 1
  // where two do not fit (f32 pools at DH 256)
  static constexpr int STAGES = WIDE                              ? 1
                                : 4 * STAGE <= 114688              ? 4
                                : 3 * STAGE <= 114688              ? 3
                                : 2 * STAGE + QBYTES <= 232448     ? 2
                                                                   : 1;
  static constexpr int RING = STAGES * STAGE;
  // the warps' final states: O [WARPS][16][DH], m and l [WARPS][16], u [WARPS]
  static constexpr int MERGE = (WARPS * 16 * (DH + 2) + WARPS) * 4;
  static constexpr int BYTES = RING + QBYTES > MERGE ? RING + QBYTES : MERGE;
  static_assert(BYTES <= 232448, "paged_decode's layout passes 227 KB of shared memory");
};

// The instantiation a head dim runs in: the next of 64, 128, 256 up; past
// 256 the WIDE case of the DH 256 layout, in 256-column slices (0: none,
// dh must be a positive multiple of 8).
constexpr int SLICE = 256;
inline int head_dim_instance(int dh) {
  if (dh <= 0 || dh % 8) return 0;
  return dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
}
__host__ __device__ inline int column_slices(int dh) {
  return dh > SLICE ? (dh + SLICE - 1) / SLICE : 1;
}

// Where 16-byte chunk c of token row r of a K tile lies in its row. A
// thread reads chunks tig * KB/16 + i of row 8n + gid; the XOR puts the 8
// threads of one 128-bit access phase (gid 2k, 2k+1 x tig 0-3) on 8
// distinct bank groups.
template <int NC>
__device__ __forceinline__ int kswz(int r, int c) {
  return c ^ ((r & 7) & (NC - 1)) ^ ((((c >> 3) & 3) << 1) & (NC - 1));
}

// The same for a V tile, read as chunks gid * CPV + i of rows 2 tig (+1,
// +8, +9), CPV = chunks a thread reads per row.
template <int NC, int CPV>
__device__ __forceinline__ int vswz(int r, int c) {
  const int t = (r >> 1) & 3;
  const int x = CPV <= 1 ? t << 1 : CPV == 2 ? (t & 1) | ((t >> 1) << 2) : t;
  return c ^ (x & (NC - 1));
}

// One warp's 16 scores of a tile in place (sc[n][e]: row gid (e < 2) or
// gid + 8, token tok + 8n + (e & 1), tok = the warp's first token + 2 tig),
// and each of this thread's two rows' max over them: K6's k_scale, the
// soft cap (log2 units after it) where CAP, and where MASK the mask to the
// live tokens [lo, hi) (-inf outside).
template <bool QUANT, bool CAP, bool MASK>
__device__ __forceinline__ void score_pass(float (&sc)[2][4], const float2 (&ks2)[2], int tok,
                                           int lo, int hi, float cap_in, float cap_out,
                                           float& mx0, float& mx1) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[n][e];
      if constexpr (QUANT) x *= (e & 1) ? ks2[n].y : ks2[n].x;
      if constexpr (CAP) x = cap_out * tanh_approx(x * cap_in);
      if constexpr (MASK) {
        const int kp = tok + 8 * n + (e & 1);
        x = (kp >= lo && kp < hi) ? x : -CUDART_INF_F;
      }
      sc[n][e] = x;
      if (e < 2) {
        mx0 = fmaxf(mx0, x);
      } else {
        mx1 = fmaxf(mx1, x);
      }
    }
  }
}

// TQ: the query type; TKV: the pool type (TQ, or int8_t with scales ks/vs).
// DH: the instantiation; dh <= DH: the tensors' head dim (EXACT: dh ==
// DH, compiled in, so the head-dim tests of the loads fold away: 2-5%
// of the kernel's time at DH 64 and 128 on the H100), or WIDE: dh > DH =
// 256, and block (b, g * column_slices(dh) + cs, z) owns O's columns [cs
// * DH, cs * DH + DH). Block (b, g, z):
// slot b, KV group g, split z of `splits`: the tiles z, z + splits, z + 2
// splits, ... of the table's width. part: split scratch (acc [splits, B,
// H, dh], then m and l [splits, B, H]), written when splits > 1.
template <typename TQ, typename TKV, int DH, bool EXACT, bool WIDE>
__global__ void __launch_bounds__(THREADS)
paged_decode(const TQ* __restrict__ q, const TKV* __restrict__ kp, const TKV* __restrict__ vp,
             const float* __restrict__ ks, const float* __restrict__ vs,
             const int* __restrict__ table, const int* __restrict__ lengths,
             const float* __restrict__ sinks, float* __restrict__ out, float* __restrict__ part,
             int H, int G, int P, int page, int maxp, int dh, float scale, float soft_cap,
             int window, int splits) {
  using L = Layout<TQ, TKV, DH, WIDE>;
  static_assert(!WIDE || (DH == SLICE && !EXACT), "the wide case keeps the DH 256 layout");
  if constexpr (EXACT) dh = DH;
  constexpr int KS = DH / 16;       // k-steps of Q K^T
  constexpr int NT = DH / 8;        // n8 tiles of O
  constexpr int KW = L::KB / 16;    // 16-byte K chunks a thread reads per token
  constexpr int CPV = L::VB / 16;   // 16-byte V chunks a thread reads per row (0: 8 bytes)
  constexpr int VW = L::VB / 4;     // words of one V row a thread holds
  extern __shared__ __align__(16) uint8_t smem[];

  const int b = blockIdx.x;
  const int ncs = WIDE ? column_slices(dh) : 1;
  const int g = WIDE ? static_cast<int>(blockIdx.y) / ncs : blockIdx.y;
  const int cs = WIDE ? static_cast<int>(blockIdx.y) % ncs : 0;  // O's column slice
  const int z = blockIdx.z;
  const int B = gridDim.x;
  const int rep = H / G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const size_t BH = static_cast<size_t>(B) * H;
  // the combine may be scheduled now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  // this block's tiles, cut to the slot's live tokens
  const int width = maxp * page;
  const int length = lengths[b];
  const int lo = window > 0 ? max(0, length - window) : 0;
  const int hi = min(length, width);
  const int ntiles = (width + BT - 1) / BT;
  // split z takes every splits-th tile from tile z on: whatever prefix of
  // the table is live, the splits share it evenly
  const int t_live = lo / BT;
  const int t_begin = t_live + ((z - t_live) % splits + splits) % splits;
  const int t_end = min((hi + BT - 1) / BT, ntiles);

  if (t_begin >= t_end || lo >= hi) {
    for (int i = tid; i < rep * DH; i += THREADS) {
      const int d = cs * DH + i % DH;
      if (d >= dh) continue;
      const size_t row = static_cast<size_t>(b) * H + g * rep + i / DH;
      if (splits == 1) {
        out[row * dh + d] = 0.f;
      } else {
        part[(z * BH + row) * dh + d] = 0.f;
        if (d == 0) {
          float* pm = part + splits * BH * dh;
          pm[z * BH + row] = NEG;
          pm[splits * BH + z * BH + row] = 0.f;
        }
      }
    }
    return;
  }

  const int* trow = table + static_cast<size_t>(b) * maxp;
  const size_t group_page = static_cast<size_t>(g) * P;
  const uint8_t* kbytes = reinterpret_cast<const uint8_t*>(kp);
  const uint8_t* vbytes = reinterpret_cast<const uint8_t*>(vp);

  // Q as m16n8k16 A fragments, rows gid and gid + 8 (zero past rep, and
  // past dh); the contraction index is permuted: k-step kk, slots 2 tig
  // (+1) and 8 + 2 tig (+1) read q[col0 + tig * DH/4 + 4 kk + (0..3)], as
  // K's fragments below. DH 256: warp 0 stores them to shared memory.
  // col0: 0, or WIDE's piece of dh.
  uint32_t qa[KS][4], ql[KS][4];
  uint4* const qsm = reinterpret_cast<uint4*>(smem + L::RING);  // L::QS: [hi, lo][KS][32]
  auto build_q = [&](int col0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = gid + 8 * half;
      uint32_t w[2 * KS], wl[2 * KS];
#pragma unroll
      for (int i = 0; i < 2 * KS; ++i) w[i] = wl[i] = 0u;
      if (r < rep) {
        const int d0 = col0 + tig * (DH / 4);
        const TQ* src = q + (static_cast<size_t>(b) * H + g * rep + r) * dh + d0;
        if constexpr (L::QLO) {
#pragma unroll
          for (int i = 0; i < DH / 16; ++i) {
            if (d0 + 4 * i >= dh) break;
            const float4 f = reinterpret_cast<const float4*>(src)[i];
            split_bf16x2(f.x, f.y, w[2 * i], wl[2 * i]);
            split_bf16x2(f.z, f.w, w[2 * i + 1], wl[2 * i + 1]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < DH / 32; ++i) {
            if (d0 + 8 * i >= dh) break;
            const uint4 u = reinterpret_cast<const uint4*>(src)[i];
            w[4 * i] = u.x;
            w[4 * i + 1] = u.y;
            w[4 * i + 2] = u.z;
            w[4 * i + 3] = u.w;
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qa[kk][half] = w[2 * kk];
        qa[kk][2 + half] = w[2 * kk + 1];
        ql[kk][half] = wl[2 * kk];
        ql[kk][2 + half] = wl[2 * kk + 1];
      }
    }
    if constexpr (L::QS) {
      if (warp == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          qsm[kk * 32 + lane] = make_uint4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
          if constexpr (L::QLO) {
            qsm[(KS + kk) * 32 + lane] = make_uint4(ql[kk][0], ql[kk][1], ql[kk][2], ql[kk][3]);
          }
        }
      }
    }
  };
  if constexpr (!WIDE) build_q(0);

  // thread tid copies token row tid / 2 of every tile: chunks 2j + (tid &
  // 1), so a pair of threads reads 32 contiguous bytes, and for K6 the
  // row's k (even tid) or v (odd) scale. Its row's page number is read
  // from the table one tile ahead of the copy, so the table's latency
  // overlaps a tile's compute instead of stalling the ring.
  static_assert(THREADS == 2 * BT, "two threads copy each token row");
  constexpr int STAGES = L::STAGES;
  uint8_t* const ring = smem;
  const uint64_t pol = evict_first_policy();
  const int lr = tid >> 1;
  const int lh = tid & 1;
  auto page_of = [&](int t) {  // -1 where the row is not live
    const int pos = t * BT + lr;
    return (pos >= lo && pos < hi) ? __ldg(trow + pos / page) : -1;
  };
  const int row_bytes = dh * static_cast<int>(sizeof(TKV));  // of one token's K or V row
  // WIDE: K's columns from kcol on, V's from vcol on (and K6's scales)
  // where with_v
  auto load_tile = [&](int t, int stage, int pg, int kcol = 0, int vcol = 0,
                       bool with_v = true) {
    const uint32_t dk = smem_u32(ring + stage * L::STAGE);
    const uint32_t dv = dk + L::TILE;
    const bool ok = pg >= 0;
    const size_t row = ok ? (group_page + pg) * page + (t * BT + lr) % page : 0;
    constexpr int ES = static_cast<int>(sizeof(TKV));
    const uint8_t* ksrc = kbytes + row * row_bytes + kcol * ES;
    const uint8_t* vsrc = vbytes + row * row_bytes + vcol * ES;
    const int kbytes_left = row_bytes - kcol * ES;
    const int vbytes_left = row_bytes - vcol * ES;
    if (L::QUANT && (dh & 15)) {
      // int8 rows of a dh that is not a multiple of 16: 8-byte copies
#pragma unroll
      for (int j = 0; j < L::NC / 2; ++j) {
        const int c = 2 * j + lh;
        const uint32_t kd = dk + lr * L::RB + kswz<L::NC>(lr, c) * 16;
        const uint32_t vd = dv + lr * L::RB + vswz<L::NC, CPV>(lr, c) * 16;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = ok && c * 16 + 8 * e < kbytes_left;
          cp_async8(kd + 8 * e, ksrc + (in ? c * 16 + 8 * e : 0), in);
          const bool vin = ok && c * 16 + 8 * e < vbytes_left;
          if (with_v) cp_async8(vd + 8 * e, vsrc + (vin ? c * 16 + 8 * e : 0), vin);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < L::NC / 2; ++j) {
        const int c = 2 * j + lh;
        const bool in = ok && c * 16 < kbytes_left;
        cp_async16(dk + lr * L::RB + kswz<L::NC>(lr, c) * 16, ksrc + (in ? c * 16 : 0), in,
                   pol);
        const bool vin = ok && c * 16 < vbytes_left;
        if (with_v) {
          cp_async16(dv + lr * L::RB + vswz<L::NC, CPV>(lr, c) * 16,
                     vsrc + (vin ? c * 16 : 0), vin, pol);
        }
      }
    }
    if constexpr (L::QUANT) {
      // [k scales][v scales] of the tile's 64 tokens
      if (with_v) cp_async4(dk + 2 * L::TILE + (lh * BT + lr) * 4, (lh ? vs : ks) + row, ok);
    }
  };

  const int n = (t_end - t_begin + splits - 1) / splits;  // this block's tiles
  int pg[STAGES];
#pragma unroll
  for (int i = 0; i < STAGES; ++i) pg[i] = i < n ? page_of(t_begin + i * splits) : -1;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) load_tile(t_begin + i * splits, i, pg[i]);
    cp_async_commit();
  }
  int pg_next = pg[STAGES - 1];

  const float sl2 = scale * LOG2E;
  const float fac = soft_cap > 0.f ? 1.f : sl2;
  const float cap_in = soft_cap > 0.f ? scale / soft_cap : 0.f;
  const float cap_out = soft_cap * LOG2E;

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float o_unit = 1.f;  // K6: O is held in units of the last u
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max of rows gid, gid + 8 (log2)
  float l0 = 0.f, l1 = 0.f;  // this thread's part of the running sums

  // S += Q K^T of this warp's 16 tokens of the K tile at sk: two n8
  // tiles of tokens; thread (gid, tig) reads token row 8 nt + gid, its
  // quarter tig of the row as 16-byte chunks (WK fragment words each:
  // k-steps c * WK/2 ...); all of them before the products up to DH 128,
  // one at a time, used as it arrives, at DH 256
  constexpr int WK = L::QUANT ? 8 : L::KVLO ? 2 : 4;
  auto qk = [&](const uint8_t* sk, float (&sc)[2][4]) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int r = 16 * warp + 8 * nt + gid;
      auto kchunk = [&](int c) {
        return *reinterpret_cast<const uint4*>(sk + r * L::RB + kswz<L::NC>(r, tig * KW + c) * 16);
      };
      uint4 kraw[L::QS ? 1 : KW];
      if constexpr (!L::QS) {
#pragma unroll
        for (int c = 0; c < KW; ++c) kraw[c] = kchunk(c);
      }
#pragma unroll
      for (int c = 0; c < KW; ++c) {
        const uint4 u = L::QS ? kchunk(c) : kraw[L::QS ? 0 : c];
        const uint32_t x[4] = {u.x, u.y, u.z, u.w};
        uint32_t kw[WK], kl[WK];
        if constexpr (L::QUANT) {
#pragma unroll
          for (int e = 0; e < 4; ++e) codes4_bf16(x[e], kw[2 * e], kw[2 * e + 1]);
        } else if constexpr (L::KVLO) {
          split_bf16x2(__uint_as_float(x[0]), __uint_as_float(x[1]), kw[0], kl[0]);
          split_bf16x2(__uint_as_float(x[2]), __uint_as_float(x[3]), kw[1], kl[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) kw[e] = x[e];
        }
#pragma unroll
        for (int i = 0; i < WK / 2; ++i) {
          const int kk = c * (WK / 2) + i;
          uint32_t a[4], al[4];
          if constexpr (L::QS) {
            const uint4 qv = qsm[kk * 32 + lane];
            a[0] = qv.x, a[1] = qv.y, a[2] = qv.z, a[3] = qv.w;
            if constexpr (L::QLO) {
              const uint4 lv = qsm[(KS + kk) * 32 + lane];
              al[0] = lv.x, al[1] = lv.y, al[2] = lv.z, al[3] = lv.w;
            }
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = qa[kk][e], al[e] = ql[kk][e];
          }
          mma_bf16(sc[nt], a, kw[2 * i], kw[2 * i + 1]);
          if constexpr (L::KVLO) mma_bf16(sc[nt], a, kl[2 * i], kl[2 * i + 1]);
          if constexpr (L::QLO) mma_bf16(sc[nt], al, kw[2 * i], kw[2 * i + 1]);
        }
      }
    }
  };

  for (int i = 0; i < n; ++i) {
    const int t = t_begin + i * splits;
    const int tok0 = t * BT + 16 * warp;
    const bool live = tok0 + 16 > lo && tok0 < hi;  // some of this warp's tokens are live
    float sc[2][4] = {};
    const uint8_t* st = smem;
    if constexpr (WIDE) {
      // S over dh in 256-column pieces: each piece's K columns into the
      // one stage and its Q fragments into shared memory (warp 0), summed
      // on the accumulators; V's slice cs and K6's scales with the first
      const int pg_t = page_of(t);
      for (int p = 0; p < ncs; ++p) {
        __syncthreads();  // every warp is done with the last piece (and tile)
        build_q(p * DH);
        load_tile(t, 0, pg_t, p * DH, cs * DH, p == 0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (live) qk(st, sc);
      }
    } else {
      if constexpr (STAGES > 1) cp_async_wait<STAGES - 2>();
      __syncthreads();  // tile i has landed; every warp is done with tile i - 1
      if (i + STAGES - 1 < n) {
        load_tile(t + (STAGES - 1) * splits, (i + STAGES - 1) % STAGES, pg_next);
      }
      cp_async_commit();
      if (i + STAGES < n) pg_next = page_of(t + STAGES * splits);  // the next tile's refill
      if constexpr (STAGES == 1) {  // one stage: tile i was copied just now
        cp_async_wait<0>();
        __syncthreads();
      }
      st = smem + (i % STAGES) * L::STAGE;
      if (live) qk(st, sc);
    }
    if (!live) continue;  // none of this warp's tokens is live
    const bool full = tok0 >= lo && tok0 + 16 <= hi;
    const uint8_t* sv = st + L::TILE;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L::TILE) + 16 * warp;
    const float* vsc = ksc + BT;

    float2 ks2[2], vs2[2];
    float inv_u = 1.f, u_ratio = 1.f;
    if constexpr (L::QUANT) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        ks2[nt] = *reinterpret_cast<const float2*>(ksc + 8 * nt + 2 * tig);
        vs2[nt] = *reinterpret_cast<const float2*>(vsc + 8 * nt + 2 * tig);
      }
      // P V runs in fp16 on p * v_scale / u, u the largest v_scale of the
      // warp's 16 tokens; O is kept in units of u
      float u = vsc[lane & 15];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) u = fmaxf(u, __shfl_xor_sync(0xffffffffu, u, off));
      u = fmaxf(u, 1e-30f);
      inv_u = 1.f / u;
      u_ratio = o_unit * inv_u;
      o_unit = u;
    }

    // scores stay raw (K6: times k_scale) and go to log2 units inside the
    // exponent's FMA; masked scores are -inf, and a row that has seen no
    // live token yet exponentiates against 0 instead of its -inf max
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
    const int tok = tok0 + 2 * tig;
    if (soft_cap > 0.f) {
      if (full) {
        score_pass<L::QUANT, true, false>(sc, ks2, tok, lo, hi, cap_in, cap_out, mx0, mx1);
      } else {
        score_pass<L::QUANT, true, true>(sc, ks2, tok, lo, hi, cap_in, cap_out, mx0, mx1);
      }
    } else if (full) {
      score_pass<L::QUANT, false, false>(sc, ks2, tok, lo, hi, cap_in, cap_out, mx0, mx1);
    } else {
      score_pass<L::QUANT, false, true>(sc, ks2, tok, lo, hi, cap_in, cap_out, mx0, mx1);
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

    // p in f32 for the sums; the two score tiles become P's A fragment
    // (rows gid / gid + 8, tokens 2 tig (+1) and 8 + 2 tig (+1)): bf16 p,
    // or K6's fp16 p * v_scale / u
    uint32_t pa[4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = ex2(fmaf(sc[nt][e], fac, e < 2 ? -mu0 : -mu1));
      ps0 += p[0] + p[1];
      ps1 += p[2] + p[3];
      if constexpr (L::QUANT) {
        const float va = vs2[nt].x * inv_u;
        const float vb = vs2[nt].y * inv_u;
        pa[2 * nt] = pack_f16x2(p[0] * va, p[1] * vb);
        pa[2 * nt + 1] = pack_f16x2(p[2] * va, p[3] * vb);
      } else {
        pa[2 * nt] = pack_bf16x2(p[0], p[1]);
        pa[2 * nt + 1] = pack_bf16x2(p[2], p[3]);
      }
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    const float oa0 = a0 * u_ratio;
    const float oa1 = a1 * u_ratio;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= oa0;
      o[j][1] *= oa0;
      o[j][2] *= oa1;
      o[j][3] *= oa1;
    }

    // O += P V: V's B fragment of n8 tile j holds tokens 2 tig (+1) and
    // 8 + 2 tig (+1) at output column gid, which is dim gid * DH/8 + j; so
    // a thread reads the contiguous eighth gid of its four token rows, in
    // VR reads of VPR words a row: all of them before the products up to
    // DH 128, one read of each row at a time at DH 256
    constexpr int VR = CPV == 0 ? 1 : CPV;   // reads a thread makes per row
    constexpr int VPR = CPV == 0 ? 2 : 4;    // words per read
    static_assert(VR * VPR == VW, "V's reads cover the thread's words");
    auto vread = [&](int rr, int c, uint32_t* dst) {
      const int r = 16 * warp + 2 * tig + (rr & 1) + 8 * (rr >> 1);
      const uint8_t* row = sv + r * L::RB;
      if constexpr (CPV == 0) {
        const uint2 u = *reinterpret_cast<const uint2*>(
            row + vswz<L::NC, 1>(r, gid >> 1) * 16 + (gid & 1) * 8);
        dst[0] = u.x;
        dst[1] = u.y;
      } else {
        const uint4 u = *reinterpret_cast<const uint4*>(
            row + vswz<L::NC, CPV>(r, gid * CPV + c) * 16);
        dst[0] = u.x;
        dst[1] = u.y;
        dst[2] = u.z;
        dst[3] = u.w;
      }
    };
    uint32_t vall[4][L::QS ? 1 : VW];
    if constexpr (!L::QS) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int c = 0; c < VR; ++c) vread(rr, c, &vall[rr][c * VPR]);
    }
#pragma unroll
    for (int c = 0; c < VR; ++c) {
      uint32_t vw[4][VPR];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        if constexpr (L::QS) {
          vread(rr, c, vw[rr]);
        } else {
#pragma unroll
          for (int w = 0; w < VPR; ++w) vw[rr][w] = vall[rr][c * VPR + w];
        }
      }
#pragma unroll
      for (int w = 0; w < VPR; ++w) {
        const int k = c * VPR + w;  // word k of the thread's eighth of a row
        if constexpr (L::QUANT) {
          // codes: word k holds dims 4k..4k+3 of the thread's eighth
          uint32_t xl[2], xh[2];
#pragma unroll
          for (int pr = 0; pr < 2; ++pr) {
            const uint32_t a = vw[2 * pr][w] ^ 0x80808080u;
            const uint32_t b2 = vw[2 * pr + 1][w] ^ 0x80808080u;
            xl[pr] = __byte_perm(a, b2, 0x5140);  // a0 c0 a1 c1
            xh[pr] = __byte_perm(a, b2, 0x7362);  // a2 c2 a3 c3
          }
          mma_f16(o[4 * k], pa, codes2_f16(xl[0], 0x4140), codes2_f16(xl[1], 0x4140));
          mma_f16(o[4 * k + 1], pa, codes2_f16(xl[0], 0x4342), codes2_f16(xl[1], 0x4342));
          mma_f16(o[4 * k + 2], pa, codes2_f16(xh[0], 0x4140), codes2_f16(xh[1], 0x4140));
          mma_f16(o[4 * k + 3], pa, codes2_f16(xh[0], 0x4342), codes2_f16(xh[1], 0x4342));
        } else if constexpr (L::KVLO) {
          // f32: word k is dim k of the eighth, O's n8 tile k
          uint32_t h0, l0w, h1, l1w;
          split_bf16x2(__uint_as_float(vw[0][w]), __uint_as_float(vw[1][w]), h0, l0w);
          split_bf16x2(__uint_as_float(vw[2][w]), __uint_as_float(vw[3][w]), h1, l1w);
          mma_bf16(o[k], pa, h0, h1);
          mma_bf16(o[k], pa, l0w, l1w);
        } else {
          // bf16: word k holds dims 2k, 2k + 1, O's n8 tiles 2k and 2k + 1
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const uint32_t sel = hf ? 0x7632 : 0x5410;
            mma_bf16(o[2 * k + hf], pa, __byte_perm(vw[0][w], vw[1][w], sel),
                     __byte_perm(vw[2][w], vw[3][w], sel));
          }
        }
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // the warps' states into shared memory (the ring is done), then merged
  // in warp order
  cp_async_wait<0>();
  __syncthreads();
  float* so = reinterpret_cast<float*>(smem);
  float* sm = so + WARPS * 16 * DH;
  float* sl = sm + WARPS * 16;
  float* su = sl + WARPS * 16;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gid + 8 * (e >> 1);
      const int d = (2 * tig + (e & 1)) * (DH / 8) + j;
      so[(warp * 16 + r) * DH + d] = o[j][e];
    }
  }
  if (tig == 0) {
    sm[warp * 16 + gid] = m0;
    sm[warp * 16 + gid + 8] = m1;
    sl[warp * 16 + gid] = l0;
    sl[warp * 16 + gid + 8] = l1;
  }
  if (lane == 0) su[warp] = o_unit;
  __syncthreads();

  for (int i = tid; i < rep * DH; i += THREADS) {
    const int r = i / DH;  // DH, not dh: a shift, not a division
    const int d = i % DH;
    if (cs * DH + d >= dh) continue;
    float M = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm[w * 16 + r]);
    float l = 0.f, acc = 0.f;
    if (M != -CUDART_INF_F) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float c = ex2(sm[w * 16 + r] - M);
        l += sl[w * 16 + r] * c;
        acc += so[(w * 16 + r) * DH + d] * (c * su[w]);
      }
    }
    const int col = cs * DH + d;
    const size_t row = static_cast<size_t>(b) * H + g * rep + r;
    if (splits == 1) {
      if (sinks != nullptr) {
        const float skl = sinks[g * rep + r] * LOG2E;
        const float m2 = fmaxf(M, skl);
        const float corr = exp2f(M - m2);
        acc *= corr;
        l = l * corr + exp2f(skl - m2);
      }
      out[row * dh + col] = acc / fmaxf(l, 1e-30f);
    } else {
      part[(z * BH + row) * dh + col] = acc;
      if (col == 0) {
        float* pm = part + splits * BH * dh;
        pm[z * BH + row] = M != -CUDART_INF_F ? M * LN2 : NEG;  // natural-log units
        pm[splits * BH + z * BH + row] = l;
      }
    }
  }
}

template <typename TQ, typename TKV, int DH, bool EXACT, bool WIDE = false>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* table, const int* lengths, const float* sinks, float* out, float* part,
           int B, int H, int G, int P, int page, int maxp, int dh, float scale,
           float soft_cap, int window, int splits, cudaStream_t stream) {
  constexpr int smem = Layout<TQ, TKV, DH, WIDE>::BYTES;
  // the shared-memory attribute is per device: set it once on each
  constexpr int MAX_DEVICES = 64;
  static bool attr[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES || !attr[dev]) {
    e = cudaFuncSetAttribute(paged_decode<TQ, TKV, DH, EXACT, WIDE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) attr[dev] = true;
  }
  const int ncs = WIDE ? column_slices(dh) : 1;
  const dim3 grid(B, G * ncs, splits);
  paged_decode<TQ, TKV, DH, EXACT, WIDE><<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks,
      vs, table, lengths, sinks, out, part, H, G, P, page, maxp, dh, scale, soft_cap, window,
      splits);
  if (splits > 1) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    // launched as a programmatic dependent: its blocks are scheduled while
    // this grid runs, and wait in the kernel for its results
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((B * H + 7) / 8, ncs);
    cfg.blockDim = dim3(256);
    cfg.stream = stream;
    cudaLaunchAttribute attr_pdl[1];
    attr_pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr_pdl[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr_pdl;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, uz_split::flash_combine<DH, WIDE>,
                           static_cast<const float*>(part),
                           sinks, out, B, H, dh, splits, static_cast<float*>(nullptr));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int DH>
int launch_dh(const void* q, const void* k, const void* v, const float* ks, const float* vs,
              const int* t, const int* len, const float* sk, float* o, float* part, int B,
              int H, int G, int P, int page, int maxp, int dh, float scale, float soft_cap,
              int window, int splits, cudaStream_t s) {
  if constexpr (DH == SLICE) {
    if (dh > SLICE) {
      return launch<TQ, TKV, DH, false, true>(q, k, v, ks, vs, t, len, sk, o, part, B, H, G, P,
                                              page, maxp, dh, scale, soft_cap, window, splits,
                                              s);
    }
  }
  if (dh == DH) {
    return launch<TQ, TKV, DH, true>(q, k, v, ks, vs, t, len, sk, o, part, B, H, G, P, page,
                                     maxp, dh, scale, soft_cap, window, splits, s);
  }
  return launch<TQ, TKV, DH, false>(q, k, v, ks, vs, t, len, sk, o, part, B, H, G, P, page,
                                    maxp, dh, scale, soft_cap, window, splits, s);
}

template <typename TQ, typename TKV>
int dispatch(int dh, const void* q, const void* k, const void* v, const float* ks,
             const float* vs, const int* t, const int* len, const float* sk, float* o,
             float* part, int B, int H, int G, int P, int page, int maxp, float scale,
             float soft_cap, int window, int splits, cudaStream_t s) {
  switch (head_dim_instance(dh)) {
    case 64:
      return launch_dh<TQ, TKV, 64>(q, k, v, ks, vs, t, len, sk, o, part, B, H, G, P, page,
                                    maxp, dh, scale, soft_cap, window, splits, s);
    case 128:
      return launch_dh<TQ, TKV, 128>(q, k, v, ks, vs, t, len, sk, o, part, B, H, G, P, page,
                                     maxp, dh, scale, soft_cap, window, splits, s);
    case 256:
      return launch_dh<TQ, TKV, 256>(q, k, v, ks, vs, t, len, sk, o, part, B, H, G, P, page,
                                     maxp, dh, scale, soft_cap, window, splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. kv_kind: 0 = K/V of q's dtype
// (bf16 or f32, K5), 1 = int8 codes with f32 k_scales/v_scales [G, P,
// page] (K6). The caller guarantees: q [B,H,dh], pools [G,P,page,dh] and
// scales contiguous and 16-byte aligned, dh a positive multiple of 8
// (past 256 in 256-column slices: splits counts blocks of every slice);
// 1 <= H / G <= 16 and H % G == 0;
// table [B,maxp] and lengths [B] int32 on the device, every table entry a
// valid physical page; sinks f32 [H] or nullptr; soft_cap <= 0 and
// window <= 0 mean none; splits >= 1 (split z takes the 64-token tiles z,
// z + splits, ... of [0, maxp * page)), and for splits > 1 an f32 scratch of
// splits * B * H * (dh + 2) values. Returns cudaGetLastError() after its
// launches.
extern "C" int uz_paged_attention(const void* q, const void* k, const void* v,
                                  const void* k_scales, const void* v_scales, int kv_kind,
                                  int q_is_bf16, const void* table, const void* lengths,
                                  const void* sinks, void* out, int B, int H, int G, int P,
                                  int page, int maxp, int dh, float scale, float soft_cap,
                                  int window, int splits, void* scratch,
                                  void* stream) {
  if (G <= 0 || H % G != 0 || H / G > MAX_REP || H / G < 1 || splits < 1 ||
      (splits > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* t = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
  const float* sk = static_cast<const float*>(sinks);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool i8 = kv_kind == 1;
  if (q_is_bf16 && i8) {
    return dispatch<__nv_bfloat16, int8_t>(dh, q, k, v, ks, vs, t, len, sk, o, part, B, H, G,
                                           P, page, maxp, scale, soft_cap, window, splits, s);
  }
  if (q_is_bf16) {
    return dispatch<__nv_bfloat16, __nv_bfloat16>(dh, q, k, v, ks, vs, t, len, sk, o, part, B,
                                                  H, G, P, page, maxp, scale, soft_cap,
                                                  window, splits, s);
  }
  if (i8) {
    return dispatch<float, int8_t>(dh, q, k, v, ks, vs, t, len, sk, o, part, B, H, G, P, page,
                                   maxp, scale, soft_cap, window, splits, s);
  }
  return dispatch<float, float>(dh, q, k, v, ks, vs, t, len, sk, o, part, B, H, G, P, page,
                                maxp, scale, soft_cap, window, splits, s);
}
