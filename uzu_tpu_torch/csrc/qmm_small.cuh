// Dequantization into bf16 tensor-core operands, and the small-M
// "swapped" tensor-core product built on it. Shared by K1/K2
// (quant_matmul.cu: qmm_small, and qmm_tile's W tile), K7/K8 (moe_gemv.cu:
// moe_small on each routed pair's expert plane) and K9 (grouped_matmul.cu:
// grouped_small on each routed expert's plane, and grouped_tile's W tile).
//
// The small-M product (qmm_small's design; see quant_matmul.cu for what
// bounds it). A warp owns 16 weight rows: the dequantized rows are the A
// operand of mma.sync m16n8k16, built in registers straight from 16-byte
// code loads (no shared memory for W), and the rows of x are the n8
// operand, so M <= 8 costs one mma per 16x16 weights and M <= 32 four.
// Each lane's 16 code bytes of a row are its four k-steps' (INT8) or eight
// k-steps' (INT4) share: the contraction index is permuted so that the INT4
// pairs that one shift-and-mask gives, (n_i, n_i+4) of a 32-bit word, are
// the fragment's pairs, and x's fragment is permuted to match with byte
// permutes (tests/test_torch_qmm_plan.py holds the permutation). A block is
// SM_WARPS warps: SM_WARPS/kw row tiles, each walked by kw warps over
// interleaved chunks of K (kw comes from N and K only), summed in shared
// memory in warp order. So each column of the product is summed in an
// order that depends on neither M nor the other rows: row i of an M-row
// product is bitwise the one-row product of row i.

#pragma once

#include "hopper.cuh"
#include "quant_tiles.cuh"

namespace uzq {

// ---------------------------------------------------------------------------
// A group's (scale, qbias) as the operands each path takes.

template <typename ST>
struct Group;

template <>
struct Group<__nv_bfloat16> {  // bf16 scales: one bf16x2 FMA per pair of INT4 weights
  __nv_bfloat162 s2, b2;
  float s, b;  // the same values in f32, for INT8
  // sv, and bv where stored, else qbias = coeff * sv (coeff a power of two:
  // exact in bf16)
  __device__ __forceinline__ void set(__nv_bfloat16 sv, __nv_bfloat16 bv, bool stored,
                                      float coeff) {
    s = __bfloat162float(sv);
    const __nv_bfloat16 bq = stored ? bv : __float2bfloat16_rn(coeff * s);
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
__device__ __forceinline__ void int4_pairs(uint32_t w, const Group<__nv_bfloat16>& g,
                                           uint32_t (&p)[4]) {
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

// One word of 8 INT4 codes dequantized as 8 bf16 in k order: one 16-byte
// chunk of a W tile.
template <typename ST>
__device__ __forceinline__ uint4 int4_k_order(uint32_t w, const Group<ST>& g) {
  uint32_t p[4];  // (n_i, n_i+4)
  int4_pairs(w, g, p);
  return make_uint4(__byte_perm(p[0], p[1], 0x5410), __byte_perm(p[2], p[3], 0x5410),
                    __byte_perm(p[0], p[1], 0x7632), __byte_perm(p[2], p[3], 0x7632));
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

// ---------------------------------------------------------------------------
// The small-M product.

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

// 8 values of x at p as 8 bf16 (f32 x rounded to nearest even)
__device__ __forceinline__ uint4 load_x8(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint4 load_x8(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  return make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                    pack_bf16x2(b.z, b.w));
}

// x[m, kb .. kb + 8 XV) of the rows m = 8 t + gid as bf16, zeros past M and K
template <int NT, int XV, typename XT>
__device__ __forceinline__ void load_x(const XT* __restrict__ x, int M, int K, int gid, int kb,
                                       uint4 (&xv)[NT][XV]) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int m = t * 8 + gid;
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int k = kb + 8 * v;
      xv[t][v] = m < M && k < K ? load_x8(x + static_cast<size_t>(m) * K + k)
                                : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Where small_rows reads x. XRows: the rows [M, K] in global memory (bf16
// or f32), each chunk's fragments loaded a chunk ahead into registers and
// put in the permuted k order by byte permutes. XStaged: bf16 rows that
// stage_x put in shared memory in that order already, `ld` 16-byte units a
// row (0: every row of the n8 operand reads row 0); each fragment is
// loaded as it is used, so x holds no registers across the chunk.
template <typename XT>
struct XRows {
  static constexpr bool kStaged = false;
  const XT* x;
};

struct XStaged {
  static constexpr bool kStaged = true;
  const uint4* s;
  int ld;
};

// 16-byte units a staged row takes: K rounded up to a whole INT4 chunk, and
// one unit of padding so the rows of a fragment load fall in other banks.
__host__ __device__ __forceinline__ int staged_ld(int K) {
  return (K + SmallGeo<4>::CK - 1) / SmallGeo<4>::CK * (SmallGeo<4>::CK / 8) + 1;
}

// Rows [M, K] of x into shared memory as bf16, each 8 k in the order that
// a BITS-bit code word's fragments take them: INT4's pairs (k0, k4), (k1,
// k5), (k2, k6), (k3, k7); INT8's k order itself (a word's four codes are
// one k-step's (k0, k1), (k2, k3)). Zeros from K to the row's last whole
// INT4 chunk.
template <int BITS = 4, typename XT>
__device__ __forceinline__ void stage_x(uint4* __restrict__ s, int ld,
                                        const XT* __restrict__ x, int M, int K) {
  static_assert(BITS == 4 || BITS == 8, "INT4 or INT8 fragment order");
  const int units = ld - 1;
  for (int i = threadIdx.x; i < M * units; i += blockDim.x) {
    const int r = i / units;
    const int k = 8 * (i - r * units);
    const uint4 v = k < K ? load_x8(x + static_cast<size_t>(r) * K + k)
                          : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (BITS == 4) {
      s[r * ld + k / 8] = make_uint4(__byte_perm(v.x, v.z, 0x5410),
                                     __byte_perm(v.x, v.z, 0x7632),
                                     __byte_perm(v.y, v.w, 0x5410),
                                     __byte_perm(v.y, v.w, 0x7632));
    } else {
      s[r * ld + k / 8] = v;
    }
  }
}

// Row block `rb`'s share of out[M, N] = x[M, K] * W[N, K]^T (M <= 8 NT):
// warp w takes row tile w / kw of the block's SM_WARPS / kw (16-row tiles
// rb * SM_WARPS / kw, ...) and K share kq = w % kw (chunks kq, kq + kw, ...
// of CK each). x is an XRows or an XStaged (staged by stage_x<BITS>);
// codes / scales / qbias are W's [N, ...] rows; qbias nullptr for a
// coefficient tensor. GC: the group size G where the caller fixes it at
// compile time (0: G as passed).
template <int BITS, typename ST, int NT, int GC = 0, typename XS>
__device__ __forceinline__ void small_rows(const XS xs, const uint8_t* __restrict__ codes,
                                           const ST* __restrict__ scales,
                                           const ST* __restrict__ qbias, float coeff,
                                           float* __restrict__ out, int M, int N, int K, int G,
                                           int SK, int vec16, int kw, int rb) {
  using Geo = SmallGeo<BITS>;
  __shared__ float red[SM_WARPS][4 * NT][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int kq = warp % kw;
  const int n0 = (rb * (SM_WARPS / kw) + warp / kw) * 16;
  const int rows[2] = {n0 + gid, n0 + gid + 8};
  const bool rok[2] = {rows[0] < N, rows[1] < N};
  const int row_bytes = K * BITS / 8;
  const int nchunks = (K + Geo::CK - 1) / Geo::CK;
  const int gsize = GC > 0 ? GC : G;
  const int glast = (K - 1) / gsize;
  const bool one_group = gsize % Geo::SPAN == 0;  // a lane's span of a chunk is one group
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
            raw_group<ST>(scales, qbias, rows[r], rok[r], SK, kb, gsize, glast, sr[u][r],
                          br[u][r]);
          }
        }
      }
      uint4 xn[NT][Geo::XV];
      if constexpr (!XS::kStaged) {
        load_x<NT, Geo::XV>(xs.x, M, K, gid, c0 * Geo::CK + tig * Geo::SPAN, xn);
      }
#pragma unroll
      for (int u = 0; u < SM_UNROLL; ++u) {
        const int c = c0 + u * kw;
        if (c >= nchunks) break;
        const int kb = c * Geo::CK + tig * Geo::SPAN;  // this lane's first k
        uint4 xv[NT][Geo::XV];
        if constexpr (!XS::kStaged) {
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int v = 0; v < Geo::XV; ++v) xv[t][v] = xn[t][v];
          if (u + 1 < SM_UNROLL && c + kw < nchunks) {
            load_x<NT, Geo::XV>(xs.x, M, K, gid, kb + kw * Geo::CK, xn);
          }
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
              raw_group<ST>(scales, qbias, rows[r], rok[r], SK, kb + q * Geo::VPW, gsize,
                            glast, sv, bv);
              g[r].set(sv, bv, stored, coeff);
            }
          }
          if constexpr (BITS == 4) {
            // two k-steps: step h takes the pairs (n_2h, n_2h+4), (n_2h+1, n_2h+5)
            uint32_t p0[4], p1[4];
            int4_pairs(w0[q], g[0], p0);
            int4_pairs(w1[q], g[1], p1);
            uint4 xq[NT];  // staged x: the word's fragments, already permuted
            if constexpr (XS::kStaged) {
#pragma unroll
              for (int t = 0; t < NT; ++t) xq[t] = xs.s[(t * 8 + gid) * xs.ld + kb / 8 + q];
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t a[4] = {p0[2 * h], p1[2 * h], p0[2 * h + 1], p1[2 * h + 1]};
#pragma unroll
              for (int t = 0; t < NT; ++t) {
                // x[8q .. 8q+7] of row t*8+gid: (x_2h, x_2h+4) and (x_2h+1, x_2h+5)
                uint32_t b[2];
                if constexpr (XS::kStaged) {
                  b[0] = h ? xq[t].z : xq[t].x;
                  b[1] = h ? xq[t].w : xq[t].y;
                } else {
                  const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv[t][q]);
                  b[0] = __byte_perm(xw[h], xw[h + 2], 0x5410);
                  b[1] = __byte_perm(xw[h], xw[h + 2], 0x7632);
                }
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
              // x[4q .. 4q+3] of row t*8+gid: words 2 (q & 1) and 2 (q & 1) + 1
              // of the 8 k at 8 (q >> 1)
              if constexpr (XS::kStaged) {
                const uint4 x8 = xs.s[(t * 8 + gid) * xs.ld + kb / 8 + (q >> 1)];
                const uint32_t* xw = reinterpret_cast<const uint32_t*>(&x8);
                const uint32_t b[2] = {xw[2 * (q & 1)], xw[2 * (q & 1) + 1]};
                mma_16816(acc[t], a, b);
              } else {
                const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv[t][q >> 1]);
                const uint32_t b[2] = {xw[2 * (q & 1)], xw[2 * (q & 1) + 1]};
                mma_16816(acc[t], a, b);
              }
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

}  // namespace uzq
