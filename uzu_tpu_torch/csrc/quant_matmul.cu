// Fused dequant matmul over INT4 / INT8 grouped-quantized weights (K1, K2).
//
//   out[m, n] = sum_k x[m, k] * (scale[n, k/g] * code[n, k] + qbias[n, k/g])
//
// Replaces the TPU kernels uzu_tpu/ops/pallas/quant_matmul.py::_int4_kernel
// and ::_int8_kernel (launched by _quant_matmul_p). Codes are u8 [N, K*bits/8],
// packed little-endian along K (4-bit: low nibble = even k); scales and the
// optional stored qbias are [N, ceil(K/g)] bf16 or f32; a symmetric tensor
// passes qbias = nullptr and qbias = coeff * scale is derived in registers.
// x is bf16 or f32 [M, K]; out is f32 [M, N]. Every weight is dequantized
// in f32; the decode kernel multiplies and accumulates in f32, the prefill
// kernel rounds x and the dequantized weight to bf16 for the tensor cores
// (as the TPU kernel does at prefill M) and accumulates in f32. Each output
// is summed in a fixed order (no split-K, no atomics), so the result is the
// same from run to run.
//
// What bounds it on Hopper. At decode M (1..a few rows) the work is ~2*M
// FLOP per weight against 0.5 (INT4) or 1 (INT8) byte of codes, far below
// the ~295 FLOP/byte where the H100's tensor cores rather than its HBM are
// the limit: the kernel is bound by streaming the codes and scales once.
// Design for that (qmm_gemv): one warp per output row n; lanes walk the
// row's codes in 16-byte loads (128 codes per lane-step at INT4, so each
// warp-step reads 512 contiguous bytes), unpack the nibbles in registers,
// index scales[n, k/g] directly, and FMA against x for up to MT rows of x
// at once; a warp shuffle reduction finishes the row. x stays in L1/L2: it
// is at most a few KB per row and every warp of the grid reads it.
// At prefill M (> GEMV_MAX_M rows) each weight is used M times and the
// FLOPs dominate. qmm_mma tiles the output 64x64 per block, dequantizes
// each 64-wide K chunk of W once into shared memory (bf16) where all 64
// rows of x reuse it, and multiplies on the tensor cores with mma.sync
// (wgmma, TMA and a multi-stage pipeline are later work). Ragged N, ragged
// M and a K that is not a multiple of the chunk are masked in-kernel.
//
// Not carried over from the TPU kernel: the even/odd deinterleave of x,
// the 0/1 expansion-matrix dot for the group scales, M padding to 8, and
// the Mosaic tile policy / VMEM budget.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GEMV_WARPS = 4;    // warps (= output rows) per gemv block
constexpr int GEMV_MAX_M = 32;   // above this many rows the tiled kernel runs

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
// whose first value sits at k0. The group size is a multiple of 8, so the
// whole word shares one group.
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

// Decode-M kernel: one warp per output row, MT rows of x per pass.
template <int BITS, typename XT, typename ST, int MT>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qmm_gemv(const XT* __restrict__ x, const uint32_t* __restrict__ codes,
         const ST* __restrict__ scales, const ST* __restrict__ qbias,
         float coeff, float* __restrict__ out, int M, int N, int K, int G,
         int vec16) {
  constexpr int VPW = 32 / BITS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + warp;
  if (n >= N) return;
  const int m0 = blockIdx.y * MT;
  const int mrows = min(MT, M - m0);
  const int words = K / VPW;
  const int kg = (K + G - 1) / G;
  const uint32_t* crow = codes + static_cast<size_t>(n) * words;
  const ST* srow = scales + static_cast<size_t>(n) * kg;
  const ST* brow = qbias != nullptr ? qbias + static_cast<size_t>(n) * kg : nullptr;
  const XT* xb = x + static_cast<size_t>(m0) * K;

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

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
  if (vec16) {  // row start 16-byte aligned: 4 words per lane-step
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

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float v = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    acc[m] = v;
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < mrows) out[static_cast<size_t>(m0 + m) * N + n] = acc[m];
    }
  }
}

// Prefill-M kernel: a 64x64 output tile per 4-warp block on the tensor
// cores. Each K chunk of 64 stages x (rounded to bf16) and the W rows
// (dequantized in f32, then rounded to bf16) through shared memory; each
// warp runs mma.sync m16n8k16 (bf16 in, f32 accumulate) over a 32x32
// sub-tile. Rows are padded by 8 elements so the fragment loads of a warp
// hit 32 distinct banks.
constexpr int MM_M = 64;
constexpr int MM_N = 64;
constexpr int MM_K = 64;
constexpr int MM_LD = MM_K + 8;
constexpr int MM_THREADS = 128;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A (16x16 bf16, row) * B (16x8 bf16, col) + D, f32 accumulators.
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BITS, typename XT, typename ST>
__global__ void __launch_bounds__(MM_THREADS)
qmm_mma(const XT* __restrict__ x, const uint32_t* __restrict__ codes,
        const ST* __restrict__ scales, const ST* __restrict__ qbias,
        float coeff, float* __restrict__ out, int M, int N, int K, int G) {
  constexpr int VPW = 32 / BITS;
  constexpr int WPR = MM_K / VPW;  // code words per W row per chunk
  __shared__ __align__(16) __nv_bfloat16 xs[MM_M][MM_LD];
  __shared__ __align__(16) __nv_bfloat16 ws[MM_N][MM_LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in group
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int m_base = blockIdx.y * MM_M;
  const int n_base = blockIdx.x * MM_N;
  const int words = K / VPW;
  const int kg = (K + G - 1) / G;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += MM_K) {
    // x tile: 64 rows x 64 k, 8 values (one 16-byte smem store) per step
    for (int i = tid; i < MM_M * MM_K / 8; i += MM_THREADS) {
      const int r = i / (MM_K / 8);
      const int c = (i % (MM_K / 8)) * 8;
      const int m = m_base + r;
      const int k = k0 + c;
      float v[8];
      if (m < M && k < K) {
        LoadX<XT, 8>::run(x + static_cast<size_t>(m) * K + k, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
      uint4 p;
      p.x = pack_bf16x2(v[0], v[1]);
      p.y = pack_bf16x2(v[2], v[3]);
      p.z = pack_bf16x2(v[4], v[5]);
      p.w = pack_bf16x2(v[6], v[7]);
      *reinterpret_cast<uint4*>(&xs[r][c]) = p;
    }
    // W tile: 64 rows x WPR words, dequantized in f32, stored as bf16
    for (int i = tid; i < MM_N * WPR; i += MM_THREADS) {
      const int r = i / WPR;
      const int wc = i % WPR;
      const int n = n_base + r;
      const int kw = k0 / VPW + wc;
      float wf[VPW];
      if (n < N && kw < words) {
        const ST* srow = scales + static_cast<size_t>(n) * kg;
        const ST* brow = qbias != nullptr ? qbias + static_cast<size_t>(n) * kg : nullptr;
        dequant_word<BITS, ST>(__ldg(codes + static_cast<size_t>(n) * words + kw),
                               kw * VPW, G, srow, brow, coeff, wf);
      } else {
#pragma unroll
        for (int j = 0; j < VPW; ++j) wf[j] = 0.f;
      }
      if constexpr (VPW == 8) {
        uint4 p;
        p.x = pack_bf16x2(wf[0], wf[1]);
        p.y = pack_bf16x2(wf[2], wf[3]);
        p.z = pack_bf16x2(wf[4], wf[5]);
        p.w = pack_bf16x2(wf[6], wf[7]);
        *reinterpret_cast<uint4*>(&ws[r][wc * 8]) = p;
      } else {
        uint2 p;
        p.x = pack_bf16x2(wf[0], wf[1]);
        p.y = pack_bf16x2(wf[2], wf[3]);
        *reinterpret_cast<uint2*>(&ws[r][wc * 4]) = p;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MM_K; kk += 16) {
      uint32_t a[2][4];
      uint32_t b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r0 = wm + mt * 16 + gid;
        a[mt][0] = ld_u32(&xs[r0][kk + tig * 2]);
        a[mt][1] = ld_u32(&xs[r0 + 8][kk + tig * 2]);
        a[mt][2] = ld_u32(&xs[r0][kk + 8 + tig * 2]);
        a[mt][3] = ld_u32(&xs[r0 + 8][kk + 8 + tig * 2]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c0 = wn + nt * 8 + gid;
        b[nt][0] = ld_u32(&ws[c0][kk + tig * 2]);
        b[nt][1] = ld_u32(&ws[c0][kk + 8 + tig * 2]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_16816(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n_base + wn + nt * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m_base + wm + mt * 16 + gid + h * 8;
        if (row >= M) continue;
        float* orow = out + static_cast<size_t>(row) * N;
        if (col < N) orow[col] = acc[mt][nt][2 * h];
        if (col + 1 < N) orow[col + 1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
}

template <int BITS, typename XT, typename ST, int MT>
void launch_gemv(const void* x, const void* codes, const void* scales,
                 const void* qbias, float coeff, void* out, int M, int N,
                 int K, int G, int vec16, cudaStream_t stream) {
  const dim3 grid((N + GEMV_WARPS - 1) / GEMV_WARPS, (M + MT - 1) / MT);
  qmm_gemv<BITS, XT, ST, MT><<<grid, GEMV_WARPS * 32, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint32_t*>(codes),
      static_cast<const ST*>(scales), static_cast<const ST*>(qbias), coeff,
      static_cast<float*>(out), M, N, K, G, vec16);
}

template <int BITS, typename XT, typename ST>
void launch(const void* x, const void* codes, const void* scales,
            const void* qbias, float coeff, void* out, int M, int N, int K,
            int G, int vec16, cudaStream_t stream) {
  if (M > GEMV_MAX_M) {
    const dim3 grid((N + MM_N - 1) / MM_N, (M + MM_M - 1) / MM_M);
    qmm_mma<BITS, XT, ST><<<grid, MM_THREADS, 0, stream>>>(
        static_cast<const XT*>(x), static_cast<const uint32_t*>(codes),
        static_cast<const ST*>(scales), static_cast<const ST*>(qbias), coeff,
        static_cast<float*>(out), M, N, K, G);
  } else if (M == 1) {
    launch_gemv<BITS, XT, ST, 1>(x, codes, scales, qbias, coeff, out, M, N, K, G, vec16, stream);
  } else if (M == 2) {
    launch_gemv<BITS, XT, ST, 2>(x, codes, scales, qbias, coeff, out, M, N, K, G, vec16, stream);
  } else if (M <= 4) {
    launch_gemv<BITS, XT, ST, 4>(x, codes, scales, qbias, coeff, out, M, N, K, G, vec16, stream);
  } else {
    launch_gemv<BITS, XT, ST, 8>(x, codes, scales, qbias, coeff, out, M, N, K, G, vec16, stream);
  }
}

template <int BITS>
void launch_bits(const void* x, int x_bf16, const void* codes,
                 const void* scales, const void* qbias, int s_bf16,
                 float coeff, void* out, int M, int N, int K, int G,
                 int vec16, cudaStream_t stream) {
  if (x_bf16 && s_bf16) {
    launch<BITS, __nv_bfloat16, __nv_bfloat16>(x, codes, scales, qbias, coeff, out, M, N, K, G, vec16, stream);
  } else if (x_bf16) {
    launch<BITS, __nv_bfloat16, float>(x, codes, scales, qbias, coeff, out, M, N, K, G, vec16, stream);
  } else if (s_bf16) {
    launch<BITS, float, __nv_bfloat16>(x, codes, scales, qbias, coeff, out, M, N, K, G, vec16, stream);
  } else {
    launch<BITS, float, float>(x, codes, scales, qbias, coeff, out, M, N, K, G, vec16, stream);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. The caller guarantees: K % 8 == 0,
// G % 8 == 0, x/codes/scales/qbias/out contiguous and 16-byte aligned,
// qbias == nullptr for coefficient tensors. vec16: the codes row stride is a
// multiple of 16 bytes. Returns cudaGetLastError() after the launch.
extern "C" int uz_quant_matmul(const void* x, int x_bf16, const void* codes,
                               const void* scales, const void* qbias,
                               int s_bf16, float coeff, void* out, int M,
                               int N, int K, int G, int bits, int vec16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4) {
    launch_bits<4>(x, x_bf16, codes, scales, qbias, s_bf16, coeff, out, M, N, K, G, vec16, s);
  } else if (bits == 8) {
    launch_bits<8>(x, x_bf16, codes, scales, qbias, s_bf16, coeff, out, M, N, K, G, vec16, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
