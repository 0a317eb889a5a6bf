// Grouped (ragged) expert matmul for MoE prefill: over INT4 expert stacks
// with in-kernel dequantization (K9) and over dense bf16 / f32 stacks (K10).
//
//   out[r, n] = sum_k x[r, k] * W[tile_expert[r / 64]][n, k]   for r < 64 * used[0]
//
// Replaces the TPU kernels uzu_tpu/ops/pallas/grouped_matmul.py::_q_kernel
// (K9, launched by _grouped_matmul_q_p) and ::_kernel (K10, launched by
// grouped_matmul). x is the expert-sorted, tile-padded activation buffer
// [Tp, K] (Tp a multiple of 64, bf16 or f32) that route_layout describes:
// every 64-row m-tile belongs to one expert, tile_expert[Tp / 64] (int32)
// names it, and used[0] (int32, read on the device) counts the tiles in
// use. Tiles at or past used[0] return at once and leave their output rows
// unwritten: the caller reads back only real rows. K9's stack is symmetric
// INT4: codes u8 [E, N, K/2] packed like quant_matmul.cu's, scales
// [E, N, ceil(K/g)] bf16 or f32, w = scale * code + coeff * scale. K10's
// stack is [E, N, K] bf16 or f32. out is f32 [Tp, N]. An expert id outside
// [0, E) is clamped into it.
//
// Numerical contract (K1's tile): x and the (dequantized) weight are
// rounded to bf16 for the tensor cores, products accumulate in f32 in a
// fixed order, so the result is the same from run to run.
//
// What bounds it on Hopper. A prefill chunk of S tokens routes
// T = S * K_active rows; each used tile does 2 * 64 * N * K FLOP on one
// expert's weights, so at prefill widths the kernel is bound by the tensor
// cores, and at the paged decode step (T = 32 rows over up to 32 tiles of
// one real row each) by reading each routed expert's weights once. Design:
// K1's 64x64 mma.sync tile (quant_tiles.cuh) with the m-tile on grid.y
// selecting the expert plane through tile_expert; each 64-wide K chunk of
// the plane is dequantized once into shared memory, where all 64 rows of
// the tile reuse it; no dequantized stack is ever written to HBM (K9).
// wgmma, TMA and a multi-stage pipeline are later work.
//
// Not carried over from the TPU kernels: the scalar-prefetch grid, the
// clamped weight index of unused tail tiles (here they return before any
// load), the flattened [E*N, ...] 2D views, the even/odd deinterleave of x,
// the 0/1 expansion-matrix dot for the scales, and the Mosaic block rules.

#include "quant_tiles.cuh"

namespace {

using namespace uzq;

// Stages a 64-row chunk of expert e's INT4 plane.
template <typename ST>
struct QuantWeights {
  const uint32_t* codes;
  const ST* scales;
  float coeff;
  int G;
  __device__ __forceinline__ void stage(Tile& ws, int e, int n0, int N, int K, int k0,
                                        int tid) const {
    const size_t plane = static_cast<size_t>(e) * N;
    stage_quant<4, ST>(ws, codes + plane * (K / 8), scales + plane * ((K + G - 1) / G),
                       nullptr, coeff, n0, N, K, G, k0, tid);
  }
};

// Stages a 64-row chunk of expert e's dense plane.
template <typename WT>
struct DenseWeights {
  const WT* w;
  __device__ __forceinline__ void stage(Tile& ws, int e, int n0, int N, int K, int k0,
                                        int tid) const {
    stage_dense<WT>(ws, w + static_cast<size_t>(e) * N * K, n0, N, K, k0, tid);
  }
};

template <typename XT, typename W>
__global__ void __launch_bounds__(MM_THREADS)
grouped_mma(const XT* __restrict__ x, const int* __restrict__ tile_expert,
            const int* __restrict__ used, W w, float* __restrict__ out, int Tp, int N,
            int K, int E) {
  const int mt = blockIdx.y;
  if (mt >= used[0]) return;
  const int e = min(max(tile_expert[mt], 0), E - 1);
  __shared__ __align__(16) Tile xs;
  __shared__ __align__(16) Tile ws;
  const int tid = threadIdx.x;
  const TileCoord t(tid);
  const int m_base = mt * MM_M;
  const int n_base = blockIdx.x * MM_N;
  float acc[2][4][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < K; k0 += MM_K) {
    stage_dense<XT>(xs, x, m_base, Tp, K, k0, tid);
    w.stage(ws, e, n_base, N, K, k0, tid);
    __syncthreads();
    mma_chunk(xs, ws, t, acc);
    __syncthreads();
  }
  store_tile(out, acc, t, m_base, n_base, Tp, N);
}

template <typename XT, typename W>
void launch(const void* x, const void* tile_expert, const void* used, const W& w, void* out,
            int Tp, int N, int K, int E, cudaStream_t stream) {
  const dim3 grid((N + MM_N - 1) / MM_N, Tp / MM_M);
  grouped_mma<XT, W><<<grid, MM_THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const int*>(tile_expert),
      static_cast<const int*>(used), w, static_cast<float*>(out), Tp, N, K, E);
}

template <typename W>
void launch_x(const void* x, int x_bf16, const void* tile_expert, const void* used,
              const W& w, void* out, int Tp, int N, int K, int E, cudaStream_t stream) {
  if (x_bf16) {
    launch<__nv_bfloat16, W>(x, tile_expert, used, w, out, Tp, N, K, E, stream);
  } else {
    launch<float, W>(x, tile_expert, used, w, out, Tp, N, K, E, stream);
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. The caller guarantees: Tp % 64
// == 0, 64 <= Tp <= 64 * 65535, K % 8 == 0, G % 8 == 0, every pointer
// contiguous and 16-byte aligned. Each returns cudaGetLastError() after
// the launch.

// K9: INT4 symmetric expert stack.
extern "C" int uz_grouped_matmul_q(const void* x, int x_bf16, const void* tile_expert,
                                   const void* used, const void* codes, const void* scales,
                                   int s_bf16, float coeff, void* out, int Tp, int N, int K,
                                   int G, int E, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (s_bf16) {
    const QuantWeights<__nv_bfloat16> w{static_cast<const uint32_t*>(codes),
                                        static_cast<const __nv_bfloat16*>(scales), coeff, G};
    launch_x(x, x_bf16, tile_expert, used, w, out, Tp, N, K, E, s);
  } else {
    const QuantWeights<float> w{static_cast<const uint32_t*>(codes),
                                static_cast<const float*>(scales), coeff, G};
    launch_x(x, x_bf16, tile_expert, used, w, out, Tp, N, K, E, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// K10: dense expert stack.
extern "C" int uz_grouped_matmul(const void* x, int x_bf16, const void* tile_expert,
                                 const void* used, const void* w, int w_bf16, void* out,
                                 int Tp, int N, int K, int E, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16) {
    const DenseWeights<__nv_bfloat16> dw{static_cast<const __nv_bfloat16*>(w)};
    launch_x(x, x_bf16, tile_expert, used, dw, out, Tp, N, K, E, s);
  } else {
    const DenseWeights<float> dw{static_cast<const float*>(w)};
    launch_x(x, x_bf16, tile_expert, used, dw, out, Tp, N, K, E, s);
  }
  return static_cast<int>(cudaGetLastError());
}
