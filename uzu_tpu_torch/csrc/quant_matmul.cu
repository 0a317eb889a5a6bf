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
// registers.
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

#include "quant_tiles.cuh"

namespace {

using namespace uzq;

constexpr int GEMV_MAX_M = 32;   // above this many rows the tiled kernel runs

// Decode-M kernel: one warp per output row, MT rows of x per pass.
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

// Prefill-M kernel: one 64x64 output tile per block (quant_tiles.cuh).
template <int BITS, typename XT, typename ST>
__global__ void __launch_bounds__(MM_THREADS)
qmm_mma(const XT* __restrict__ x, const uint32_t* __restrict__ codes,
        const ST* __restrict__ scales, const ST* __restrict__ qbias,
        float coeff, float* __restrict__ out, int M, int N, int K, int G, int SK) {
  __shared__ __align__(16) Tile xs;
  __shared__ __align__(16) Tile ws;
  const int tid = threadIdx.x;
  const TileCoord t(tid);
  const int m_base = blockIdx.y * MM_M;
  const int n_base = blockIdx.x * MM_N;
  float acc[2][4][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < K; k0 += MM_K) {
    stage_dense<XT>(xs, x, m_base, M, K, k0, tid);
    stage_quant<BITS, ST>(ws, codes, scales, qbias, coeff, n_base, N, K, G, SK, k0, tid);
    __syncthreads();
    mma_chunk(xs, ws, t, acc);
    __syncthreads();
  }
  store_tile(out, acc, t, m_base, n_base, M, N);
}

template <int BITS, typename XT, typename ST, int MT>
void launch_gemv(const void* x, const void* codes, const void* scales,
                 const void* qbias, float coeff, void* out, int M, int N,
                 int K, int G, int SK, int vec16, cudaStream_t stream) {
  const dim3 grid((N + GEMV_WARPS - 1) / GEMV_WARPS, (M + MT - 1) / MT);
  qmm_gemv<BITS, XT, ST, MT><<<grid, GEMV_WARPS * 32, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint32_t*>(codes),
      static_cast<const ST*>(scales), static_cast<const ST*>(qbias), coeff,
      static_cast<float*>(out), M, N, K, G, SK, vec16);
}

template <int BITS, typename XT, typename ST>
void launch(const void* x, const void* codes, const void* scales,
            const void* qbias, float coeff, void* out, int M, int N, int K,
            int G, int SK, int vec16, cudaStream_t stream) {
  if (M > GEMV_MAX_M) {
    const dim3 grid((N + MM_N - 1) / MM_N, (M + MM_M - 1) / MM_M);
    qmm_mma<BITS, XT, ST><<<grid, MM_THREADS, 0, stream>>>(
        static_cast<const XT*>(x), static_cast<const uint32_t*>(codes),
        static_cast<const ST*>(scales), static_cast<const ST*>(qbias), coeff,
        static_cast<float*>(out), M, N, K, G, SK);
  } else if (M == 1) {
    launch_gemv<BITS, XT, ST, 1>(x, codes, scales, qbias, coeff, out, M, N, K, G, SK, vec16, stream);
  } else if (M == 2) {
    launch_gemv<BITS, XT, ST, 2>(x, codes, scales, qbias, coeff, out, M, N, K, G, SK, vec16, stream);
  } else if (M <= 4) {
    launch_gemv<BITS, XT, ST, 4>(x, codes, scales, qbias, coeff, out, M, N, K, G, SK, vec16, stream);
  } else {
    launch_gemv<BITS, XT, ST, 8>(x, codes, scales, qbias, coeff, out, M, N, K, G, SK, vec16, stream);
  }
}

template <int BITS>
void launch_bits(const void* x, int x_bf16, const void* codes,
                 const void* scales, const void* qbias, int s_bf16,
                 float coeff, void* out, int M, int N, int K, int G,
                 int SK, int vec16, cudaStream_t stream) {
  if (x_bf16 && s_bf16) {
    launch<BITS, __nv_bfloat16, __nv_bfloat16>(x, codes, scales, qbias, coeff, out, M, N, K, G, SK, vec16, stream);
  } else if (x_bf16) {
    launch<BITS, __nv_bfloat16, float>(x, codes, scales, qbias, coeff, out, M, N, K, G, SK, vec16, stream);
  } else if (s_bf16) {
    launch<BITS, float, __nv_bfloat16>(x, codes, scales, qbias, coeff, out, M, N, K, G, SK, vec16, stream);
  } else {
    launch<BITS, float, float>(x, codes, scales, qbias, coeff, out, M, N, K, G, SK, vec16, stream);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. The caller guarantees: K % 8 == 0,
// G % 8 == 0, SK >= ceil(K/G), x/codes/scales/qbias/out contiguous and
// 16-byte aligned, qbias == nullptr for coefficient tensors. vec16: the codes
// row stride is a multiple of 16 bytes. Returns cudaGetLastError() after the
// launch.
extern "C" int uz_quant_matmul(const void* x, int x_bf16, const void* codes,
                               const void* scales, const void* qbias,
                               int s_bf16, float coeff, void* out, int M,
                               int N, int K, int G, int SK, int bits,
                               int vec16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4) {
    launch_bits<4>(x, x_bf16, codes, scales, qbias, s_bf16, coeff, out, M, N, K, G, SK, vec16, s);
  } else if (bits == 8) {
    launch_bits<8>(x, x_bf16, codes, scales, qbias, s_bf16, coeff, out, M, N, K, G, SK, vec16, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
