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
// out is f32 [P, N]. An id outside [0, E) is clamped into it (the ids come
// from the device and are never read on the host).
//
// Numerical contract (the TPU kernel's default, single-pass bf16 operands
// with f32 sums): x and the dequantized weight enter the tensor cores as
// bf16 (f32 x rounded to nearest even as it is staged; an INT4 weight with
// bf16 scales is one bf16x2 FMA, rounded once; INT8 weights and f32 scales
// are dequantized in f32 and rounded), products accumulate in f32 in a
// fixed order with no atomics.
//
// What bounds it on the H100. Decode routes P = S * K_active pairs (4 for
// one token of gpt-oss): ~2 FLOP per weight against 0.5 (INT4) or 1 (INT8)
// byte of codes, so the least time is streaming each routed plane's codes
// and scales once (gpt-oss's up plane: 9.3 MB in INT4, 17.6 MB in INT8);
// below ~0.010 ms the timer reads its own floor (PERF.md section 6).
//
// Design: qmm_small.cuh's swapped tensor-core product (small_rows, M = 1)
// on each pair's expert plane, as K9's small route (grouped_small) runs it
// on each tile's plane. What the first port's warp-per-row GEMV lost, and
// what this does about it:
// 1. One 16-byte code load per lane at a time, dequantized before the
//    next was issued: a warp now owns 16 weight rows and loads SM_UNROLL
//    chunks of their codes (16 bytes a lane and row each) before it uses
//    any.
// 2. Every warp re-read the pair's f32 x row (8x the INT4 code bytes of
//    its row): the block stages the pair's x once in shared memory as bf16
//    in the fragment's k order (stage_x, INT4 or INT8 order), and restages
//    only when its next item belongs to another pair.
// 3. A global scale load per 32-bit word and two f32 FMAs per weight: the
//    group's scale is loaded once per lane span of a chunk, an INT4 pair
//    of weights is one bf16x2 FMA, and the products run on mma.sync. With
//    the group size 32 compiled in, its divisions and tests fold away.
// 4. 4-warp blocks of 4 rows (5760 blocks for gpt-oss's up projection):
//    the (pair, row block) items, each SM_WARPS / kw 16-row tiles of one
//    pair, are dealt in contiguous ranges to at most two blocks an SM, the
//    SM's share split between a first-round and a second-round block
//    (2 + 1 items at gpt-oss's up projection, not 2 + 2 on some SMs).
// On the H100 it is bound by instruction issue and latency, not by HBM:
// most of its inner loop is the dequantization, and it runs little faster
// with the planes already in L2 (PERF.md section 6).
// kw comes from K and the code width (the wrapper's plan,
// ops/cuda/moe_gemv.py) and the kw warps sum in warp order, so a pair's
// row depends neither on P nor on the other pairs, and an INT4 row is
// bitwise the row K9's small route gives for the same x row and expert at
// bm 8 (the same small_rows<4, ST, 1> on the same staged bf16 x with the
// same kw).
//
// Not carried over from the TPU kernel: the 8-sublane row block per pair,
// the flattened [E*N, ...] 2D views, the even/odd deinterleave of x, the
// 0/1 expansion-matrix dot for the scales, and the Mosaic tile policy.

#include "qmm_small.cuh"

namespace {

using namespace uzq;

// The (pair, row block) items, pair-major, dealt to the blocks in
// contiguous ranges: the first `first` blocks take per_first items each,
// the others per_second (the plan's split of an SM's share between its
// two blocks). The pair's x row is staged once in dynamic shared memory
// (stage_x) for all of that pair's items, and read with a row stride of 0:
// each of the n8 operand's 8 columns holds the pair's x, and only column 0
// is stored. GC: the group size when fixed at compile time (0: G).
template <int BITS, typename ST, int GC>
__global__ void __launch_bounds__(SM_WARPS * 32)
moe_small(const float* __restrict__ x, const int* __restrict__ ids,
          const uint8_t* __restrict__ codes, const ST* __restrict__ scales, float coeff,
          float* __restrict__ out, int P, int N, int K, int G, int E, int vec16, int kw,
          int first, int per_first, int per_second) {
  extern __shared__ uint4 staged[];
  const int ld = staged_ld(K);
  const int row_blocks = ((N + 15) / 16 + SM_WARPS / kw - 1) / (SM_WARPS / kw);
  const int items = P * row_blocks;
  const int b = blockIdx.x;
  const int start = b < first ? b * per_first : first * per_first + (b - first) * per_second;
  const int last = min(items, start + (b < first ? per_first : per_second));
  const int row_bytes = K * BITS / 8;
  const int SK = (K + G - 1) / G;
  int staged_pair = -1;
  for (int item = start; item < last; ++item) {
    const int p = item / row_blocks;
    const int e = min(max(ids[p], 0), E - 1);
    if (p != staged_pair) {  // the previous item's barrier freed the stage
      stage_x<BITS>(staged, ld, x + static_cast<size_t>(p) * K, 1, K);
      __syncthreads();
      staged_pair = p;
    }
    small_rows<BITS, ST, 1, GC>(XStaged{staged, 0},
                                codes + static_cast<size_t>(e) * N * row_bytes,
                                scales + static_cast<size_t>(e) * N * SK, nullptr, coeff,
                                out + static_cast<size_t>(p) * N, 1, N, K, G, SK, vec16, kw,
                                item % row_blocks);
    __syncthreads();  // the kw reduction's and the stage's shared memory are reused next
  }
}

struct Args {
  const float* x;
  const int* ids;
  const uint8_t* codes;
  const void* scales;
  float coeff;
  float* out;
  int P, N, K, G, E, vec16, kw, blocks, first, per_first, per_second;
};

template <int BITS, typename ST, int GC>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = staged_ld(a.K) * 16;
  static int limit[MAX_DEVICES] = {};
  const cudaError_t e = allow_smem(moe_small<BITS, ST, GC>, smem, limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  moe_small<BITS, ST, GC><<<a.blocks, SM_WARPS * 32, smem, stream>>>(
      a.x, a.ids, a.codes, static_cast<const ST*>(a.scales), a.coeff, a.out, a.P, a.N, a.K,
      a.G, a.E, a.vec16, a.kw, a.first, a.per_first, a.per_second);
  return static_cast<int>(cudaGetLastError());
}

// a group size of 32 (the port's quantized experts) compiled in: its
// division and the one-group test fold away
template <int BITS, typename ST>
int launch_groups(const Args& a, cudaStream_t s) {
  return a.G == 32 ? launch<BITS, ST, 32>(a, s) : launch<BITS, ST, 0>(a, s);
}

template <int BITS>
int launch_scales(const Args& a, int s_bf16, cudaStream_t s) {
  return s_bf16 ? launch_groups<BITS, __nv_bfloat16>(a, s) : launch_groups<BITS, float>(a, s);
}

}  // namespace

// Plain C entry point, bound with ctypes. The caller guarantees: K % 8 == 0,
// G % 8 == 0, every pointer contiguous and 16-byte aligned, and a staged
// row of staged_ld(K) * 16 bytes within the card's shared memory per
// block. kw (1, 2, 4 or 8), blocks, first, per_first and per_second are
// the wrapper's plan. vec16: one expert row of codes is a multiple of 16
// bytes. Returns cudaGetLastError() after the launch.
extern "C" int uz_moe_gemv(const void* x, const void* ids, const void* codes,
                           const void* scales, int s_bf16, float coeff, void* out, int P,
                           int N, int K, int G, int E, int bits, int vec16, int kw, int blocks,
                           int first, int per_first, int per_second, void* stream) {
  if (kw < 1 || kw > SM_WARPS || SM_WARPS % kw || blocks < 1 || P < 1 || first < 0 ||
      first > blocks || per_first < 0 || per_second < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(x), static_cast<const int*>(ids),
               static_cast<const uint8_t*>(codes), scales, coeff, static_cast<float*>(out),
               P, N, K, G, E, vec16, kw, blocks, first, per_first, per_second};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4) return launch_scales<4>(a, s_bf16, s);
  if (bits == 8) return launch_scales<8>(a, s_bf16, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
