// Expert-gather dequant GEMV over stacked INT4 / INT8 expert weights (K7, K8).
//
//   out[p, n] = sum_k x[p, k] * (scale[e, n, k/g] * code[e, n, k] + coeff * scale[e, n, k/g]),
//   e = ids[p], coeff = -2^(bits-1)
//
// Replaces the TPU kernels uzu_tpu/ops/pallas/moe_gemv.py::_int4_pair_kernel
// (K7) and ::_int8_pair_kernel (K8), both launched by _moe_gemv_p. The stack
// is symmetric: codes u8 [E, N, K*bits/8] packed like quant_matmul.cu's,
// scales [E, N, ceil(K/g)] bf16 or f32, qbias = coeff * scale. x_pairs is
// f32 [P, K], one row per routed (token, expert) pair, ids is int32 [P];
// out is f32 [P, N]. Dequantization, products and sums are f32, in a fixed
// order per output, so the result is the same from run to run. An id
// outside [0, E) is clamped into it (the ids come from the device and are
// never checked on the host).
//
// What bounds it on Hopper. Decode routes P = S * K_active pairs (4 for one
// token of gpt-oss): ~2 FLOP per weight against 0.5 (INT4) or 1 (INT8) byte
// of codes, so the kernel is bound by streaming each routed expert's codes
// and scales once. Design: K1's GEMV (quant_tiles.cuh gemv_row), one warp
// per output row n, with the pair index on grid.y selecting the expert
// plane through ids[p]: only the P routed planes are read, no expert is
// copied or dequantized into HBM, and one launch covers all P pairs.
//
// Not carried over from the TPU kernel: the 8-sublane row block per pair,
// the flattened [E*N, ...] 2D views, the even/odd deinterleave of x, the
// 0/1 expansion-matrix dot for the scales, and the Mosaic tile policy.

#include "quant_tiles.cuh"

namespace {

using namespace uzq;

template <int BITS, typename ST>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
moe_gemv(const float* __restrict__ x, const int* __restrict__ ids,
         const uint32_t* __restrict__ codes, const ST* __restrict__ scales, float coeff,
         float* __restrict__ out, int N, int K, int G, int E, int vec16) {
  constexpr int VPW = 32 / BITS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + warp;
  if (n >= N) return;
  const int p = blockIdx.y;
  const int e = min(max(ids[p], 0), E - 1);
  const int kg = (K + G - 1) / G;
  const size_t row = static_cast<size_t>(e) * N + n;
  float acc[1] = {0.f};
  gemv_row<BITS, float, ST, 1>(x + static_cast<size_t>(p) * K, codes + row * (K / VPW),
                               scales + row * kg, nullptr, coeff, K, G, 1, vec16, lane, acc);
  const float v = warp_sum(acc[0]);
  if (lane == 0) out[static_cast<size_t>(p) * N + n] = v;
}

template <int BITS, typename ST>
void launch(const void* x, const void* ids, const void* codes, const void* scales,
            float coeff, void* out, int P, int N, int K, int G, int E, int vec16,
            cudaStream_t stream) {
  const dim3 grid((N + GEMV_WARPS - 1) / GEMV_WARPS, P);
  moe_gemv<BITS, ST><<<grid, GEMV_WARPS * 32, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int*>(ids),
      static_cast<const uint32_t*>(codes), static_cast<const ST*>(scales), coeff,
      static_cast<float*>(out), N, K, G, E, vec16);
}

template <int BITS>
void launch_scales(const void* x, const void* ids, const void* codes, const void* scales,
                   int s_bf16, float coeff, void* out, int P, int N, int K, int G, int E,
                   int vec16, cudaStream_t stream) {
  if (s_bf16) {
    launch<BITS, __nv_bfloat16>(x, ids, codes, scales, coeff, out, P, N, K, G, E, vec16, stream);
  } else {
    launch<BITS, float>(x, ids, codes, scales, coeff, out, P, N, K, G, E, vec16, stream);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. The caller guarantees: K % 8 == 0,
// G % 8 == 0, 1 <= P <= 65535, every pointer contiguous and 16-byte
// aligned. vec16: one expert row of codes is a multiple of 16 bytes.
// Returns cudaGetLastError() after the launch.
extern "C" int uz_moe_gemv(const void* x, const void* ids, const void* codes,
                           const void* scales, int s_bf16, float coeff, void* out, int P,
                           int N, int K, int G, int E, int bits, int vec16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4) {
    launch_scales<4>(x, ids, codes, scales, s_bf16, coeff, out, P, N, K, G, E, vec16, s);
  } else if (bits == 8) {
    launch_scales<8>(x, ids, codes, scales, s_bf16, coeff, out, P, N, K, G, E, vec16, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
