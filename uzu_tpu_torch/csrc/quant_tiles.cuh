// Device building blocks shared by the quantized matmul kernels: the
// warp-per-row dequant GEMV (K1/K2's f32 route in quant_matmul.cu, K7/K8
// in moe_gemv.cu) and the 64x64 mma.sync tensor-core tile (K10's mma route
// in grouped_matmul.cu); the bf16 packing and mma.sync that qmm_small.cuh
// builds on.
//
// Codes are u8 packed little-endian along K (4-bit: low nibble = even k),
// read as 32-bit words; one word holds 8 INT4 or 4 INT8 values of one
// group (the group size is a multiple of 8). A weight is dequantized in
// f32 as scale * code + qbias, with qbias either stored per group or
// coeff * scale for a symmetric tensor (brow == nullptr).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace uzq {

constexpr int GEMV_WARPS = 4;  // warps (= output rows) per gemv block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Load NV consecutive values of x (16-byte aligned for NV*sizeof(T) >= 16).
template <typename T, int NV>
struct LoadX;

template <>
struct LoadX<float, 8> {
  static __device__ __forceinline__ void run(const float* p, float* o) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

template <>
struct LoadX<float, 4> {
  static __device__ __forceinline__ void run(const float* p, float* o) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  }
};

template <>
struct LoadX<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <>
struct LoadX<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float* o) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

// Dequantize one 32-bit word of codes (8 INT4 or 4 INT8 values, in k order)
// whose first value sits at k0.
template <int BITS, typename ST>
__device__ __forceinline__ void dequant_word(uint32_t w, int k0, int G,
                                             const ST* __restrict__ srow,
                                             const ST* __restrict__ brow,
                                             float coeff, float* wf) {
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const int gi = k0 / G;
  const float s = to_f32(srow[gi]);
  const float b = brow != nullptr ? to_f32(brow[gi]) : coeff * s;
#pragma unroll
  for (int i = 0; i < VPW; ++i) {
    wf[i] = fmaf(static_cast<float>((w >> (BITS * i)) & MASK), s, b);
  }
}

// One lane's share of a warp's dot products between the quantized weight
// row `crow` (scales `srow`, stored qbias `brow` or nullptr) and MT rows of
// x (row m at xb + m*K; rows at or past mrows are skipped): lanes walk the
// row's codes in 16-byte loads when vec16 (the row starts 16-byte
// aligned), else word by word, and FMA in f32 into acc[m]. The caller sums
// acc over the warp.
template <int BITS, typename XT, typename ST, int MT>
__device__ __forceinline__ void gemv_row(const XT* __restrict__ xb,
                                         const uint32_t* __restrict__ crow,
                                         const ST* __restrict__ srow,
                                         const ST* __restrict__ brow, float coeff,
                                         int K, int G, int mrows, int vec16, int lane,
                                         float* acc) {
  constexpr int VPW = 32 / BITS;
  const int words = K / VPW;
  auto consume = [&](uint32_t w, int k0) {
    float wf[VPW];
    dequant_word<BITS, ST>(w, k0, G, srow, brow, coeff, wf);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < mrows) {
        float xv[VPW];
        LoadX<XT, VPW>::run(xb + static_cast<size_t>(m) * K + k0, xv);
#pragma unroll
        for (int i = 0; i < VPW; ++i) acc[m] = fmaf(wf[i], xv[i], acc[m]);
      }
    }
  };

  int done = 0;
  if (vec16) {  // 4 words per lane-step
    const int nvec = words / 4;
    const uint4* c4 = reinterpret_cast<const uint4*>(crow);
    for (int v = lane; v < nvec; v += 32) {
      const uint4 u = __ldg(c4 + v);
      const int k0 = v * 4 * VPW;
      consume(u.x, k0);
      consume(u.y, k0 + VPW);
      consume(u.z, k0 + 2 * VPW);
      consume(u.w, k0 + 3 * VPW);
    }
    done = nvec * 4;
  }
  for (int wi = done + lane; wi < words; wi += 32) {
    consume(__ldg(crow + wi), wi * VPW);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// 64x64 output tile per 4-warp block on the tensor cores. Each K chunk of
// 64 stages x and the W rows through shared memory as bf16; each warp
// runs mma.sync m16n8k16 (bf16 in, f32 accumulate) over a 32x32 sub-tile.
// Rows are padded by 8 elements so the fragment loads of a warp hit 32
// distinct banks. Ragged M, N and K are masked while staging (zeros) and
// at the store.

constexpr int MM_M = 64;
constexpr int MM_N = 64;
constexpr int MM_K = 64;
constexpr int MM_LD = MM_K + 8;
constexpr int MM_THREADS = 128;

typedef __nv_bfloat16 Tile[MM_M][MM_LD];

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  uint4 p;
  p.x = pack_bf16x2(v[0], v[1]);
  p.y = pack_bf16x2(v[2], v[3]);
  p.z = pack_bf16x2(v[4], v[5]);
  p.w = pack_bf16x2(v[6], v[7]);
  *reinterpret_cast<uint4*>(dst) = p;
}

// D = A (16x16 bf16, row) * B (16x8 bf16, col) + D, f32 accumulators.
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows [row0, row0 + 64) x columns [k0, k0 + 64) of a dense row-major
// [rows, K] matrix (K % 8 == 0, 16-byte aligned) into `tile` as bf16.
template <typename T>
__device__ __forceinline__ void stage_dense(Tile& tile, const T* __restrict__ a, int row0,
                                            int rows, int K, int k0, int tid) {
  for (int i = tid; i < MM_M * MM_K / 8; i += MM_THREADS) {
    const int r = i / (MM_K / 8);
    const int c = (i % (MM_K / 8)) * 8;
    const int row = row0 + r;
    const int k = k0 + c;
    float v[8];
    if (row < rows && k < K) {
      LoadX<T, 8>::run(a + static_cast<size_t>(row) * K + k, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
    store8(&tile[r][c], v);
  }
}

// Thread-fragment coordinates of the 64x64 tile: warp w owns the 32x32
// sub-tile at (wm, wn); lane = 4 * gid + tig.
struct TileCoord {
  int wm, wn, gid, tig;
  __device__ __forceinline__ explicit TileCoord(int tid)
      : wm(((tid >> 5) >> 1) * 32), wn(((tid >> 5) & 1) * 32),
        gid((tid & 31) >> 2), tig(tid & 3) {}
};

__device__ __forceinline__ void zero_acc(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc += xs (64 x 64 chunk) * ws^T (64 x 64 chunk) for this warp's sub-tile.
__device__ __forceinline__ void mma_chunk(const Tile& xs, const Tile& ws, const TileCoord& t,
                                          float (&acc)[2][4][4]) {
#pragma unroll
  for (int kk = 0; kk < MM_K; kk += 16) {
    uint32_t a[2][4];
    uint32_t b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r0 = t.wm + mt * 16 + t.gid;
      a[mt][0] = ld_u32(&xs[r0][kk + t.tig * 2]);
      a[mt][1] = ld_u32(&xs[r0 + 8][kk + t.tig * 2]);
      a[mt][2] = ld_u32(&xs[r0][kk + 8 + t.tig * 2]);
      a[mt][3] = ld_u32(&xs[r0 + 8][kk + 8 + t.tig * 2]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c0 = t.wn + nt * 8 + t.gid;
      b[nt][0] = ld_u32(&ws[c0][kk + t.tig * 2]);
      b[nt][1] = ld_u32(&ws[c0][kk + 8 + t.tig * 2]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_16816(acc[mt][nt], a[mt], b[nt]);
  }
}

// Write this warp's sub-tile of the f32 [M, N] output at (m_base, n_base).
__device__ __forceinline__ void store_tile(float* __restrict__ out, const float (&acc)[2][4][4],
                                           const TileCoord& t, int m_base, int n_base,
                                           int M, int N) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n_base + t.wn + nt * 8 + t.tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m_base + t.wm + mt * 16 + t.gid + h * 8;
        if (row >= M) continue;
        float* orow = out + static_cast<size_t>(row) * N;
        if (col < N) orow[col] = acc[mt][nt][2 * h];
        if (col + 1 < N) orow[col + 1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
}

}  // namespace uzq
