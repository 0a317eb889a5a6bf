// Paged decode attention over shared page pools (K5), and the same over
// INT8 pools (K6).
//
// K5 replaces the TPU kernel uzu_tpu/ops/pallas/paged_attention.py::_kernel
// (launched by _paged_p), K6 replaces ::_kernel_i8 (launched by
// _paged_p_i8). One query token per slot: q is [B, H, DH]; the pools are
// [G, P, page, DH] (bf16 or f32 for K5; int8 codes for K6, with one f32
// scale per (group, page, offset) in k_scales/v_scales [G, P, page]);
// logical page j of slot b is physical page table[b, j] (table [B, MAXP]
// int32); slot b sees tokens [0, lengths[b]). Head h belongs to KV group
// h / rep (rep = H / G). Per head: scores = (q . k) * scale (K6: (q . c_k)
// * k_scale[token] * scale), optional tanh soft cap, then the mask: tokens
// at or past length, and before length - window, are dropped; online
// softmax over the live tokens; K6 multiplies each probability by
// v_scale[token] before the P.V product. Per-head sinks fold in once after
// the last tile as one extra logit. Output is f32 [B, H, DH].
//
// What bounds it on Hopper. Each (slot, group) block reads its live K/V
// rows once and does ~4*DH FLOP per (head, token) over rep = 4 heads, ~2
// FLOP per byte of a bf16 pool: far under the card's ~295 FLOP/byte, so the
// kernel is bound by the bytes of the live pages (B=8 x 1024 tokens of the
// flagship: 16.8 MB bf16, 8.9 MB int8 with its scales). Design: one block
// per (slot, KV group) with one warp per query head of the group, so the
// rep heads share every K/V tile staged in shared memory; tiles of 32
// tokens, lane j owning token j's score and DH/32 output dims; the block
// walks only the live tokens [max(0, length - window), min(length,
// MAXP * page)), computing each token's physical row from the table, so no
// step is spent on dead pages whatever the table's width and any page
// size works (pages may be shorter than a tile). Physical pages that
// repeat across slots (shared prefixes) are only read. Arithmetic is f32
// FMA in a fixed order: the result is the same from run to run. Known
// weakness: B*G blocks (64 at B=8 on the flagship) with a serial token
// loop each fill half the SMs; splitting the token range across blocks
// with a combine pass is later work.
//
// Not carried over from the TPU kernels: the 8-sublane query padding, the
// lane-replicated running stats, the DMA clamping of dead grid steps, the
// 8-row scale windows of K6, and the page % 32 rule for int8 pools (all
// Mosaic tiling constraints).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;     // tokens staged per step, one per lane
constexpr int MAX_REP = 16;  // query heads per KV group (one warp each)
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Load 8 consecutive values as floats (16-byte aligned; 8-byte for int8).
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const int2 u = *reinterpret_cast<const int2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// TQ: the query type; TKV: the pool type (TQ, or int8_t with scales ks/vs,
// nullptr otherwise). Block (b, g) of 32 * rep threads.
template <typename TQ, typename TKV, int DH>
__global__ void __launch_bounds__(32 * MAX_REP)
paged_decode(const TQ* __restrict__ q, const TKV* __restrict__ kp,
             const TKV* __restrict__ vp, const float* __restrict__ ks,
             const float* __restrict__ vs, const int* __restrict__ table,
             const int* __restrict__ lengths, const float* __restrict__ sinks,
             float* __restrict__ out, int H, int G, int P, int page, int maxp,
             float scale, float soft_cap, int window) {
  constexpr int DPL = DH / 32;  // output dims per lane
  __shared__ float qs[MAX_REP][DH];
  __shared__ float kt[TILE][DH + 1];
  __shared__ float vt[TILE][DH + 1];
  __shared__ float kst[TILE];
  __shared__ float vst[TILE];

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int rep = H / G;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int w = tid / 32;
  const int lane = tid % 32;
  const int h = g * rep + w;
  const bool quant = ks != nullptr;

  const TQ* qg = q + (static_cast<size_t>(b) * H + static_cast<size_t>(g) * rep) * DH;
  for (int i = tid; i < rep * DH; i += nthreads) qs[i / DH][i % DH] = to_f32(qg[i]);

  const int length = lengths[b];
  const int end = min(length, maxp * page);
  const int begin = window > 0 ? max(0, length - window) : 0;
  const int* trow = table + static_cast<size_t>(b) * maxp;
  const size_t group_rows = static_cast<size_t>(g) * P * page;

  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m_run = NEG;
  float l_run = 0.f;
  __syncthreads();

  for (int t0 = begin; t0 < end; t0 += TILE) {
    // stage the K/V rows of tokens t0 .. t0+TILE-1 of group g as f32
    for (int i = tid; i < TILE * DH / 8; i += nthreads) {
      const int j = i / (DH / 8);
      const int d8 = (i % (DH / 8)) * 8;
      const int pos = t0 + j;
      float k8[8], v8[8];
      if (pos < end) {
        const size_t row = group_rows + static_cast<size_t>(trow[pos / page]) * page + pos % page;
        load8(kp + row * DH + d8, k8);
        load8(vp + row * DH + d8, v8);
        if (quant && d8 == 0) {
          kst[j] = ks[row];
          vst[j] = vs[row];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) k8[e] = v8[e] = 0.f;
        if (quant && d8 == 0) kst[j] = vst[j] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        kt[j][d8 + e] = k8[e];
        vt[j][d8 + e] = v8[e];
      }
    }
    __syncthreads();

    const bool valid = t0 + lane < end;
    float dot = 0.f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) dot = fmaf(qs[w][d], kt[lane][d], dot);
    float s = quant ? dot * (kst[lane] * scale) : dot * scale;
    if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
    s = valid ? s : NEG;
    const float m_new = fmaxf(m_run, warp_max(s));
    const float alpha = expf(m_run - m_new);
    float p = valid ? expf(s - m_new) : 0.f;
    l_run = l_run * alpha + warp_sum(p);
    m_run = m_new;
    if (quant) p *= vst[lane];
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll 8
    for (int j = 0; j < TILE; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = fmaf(pj, vt[j][lane + 32 * i], acc[i]);
    }
    __syncthreads();
  }

  if (sinks != nullptr) {
    const float sink = sinks[h];
    const float m2 = fmaxf(m_run, sink);
    const float corr = expf(m_run - m2);
    l_run = l_run * corr + expf(sink - m2);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;
  }
  const float inv = 1.f / fmaxf(l_run, 1e-30f);
  float* orow = out + (static_cast<size_t>(b) * H + h) * DH;
#pragma unroll
  for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = acc[i] * inv;
}

template <typename TQ, typename TKV, int DH>
void launch(const void* q, const void* k, const void* v, const float* ks,
            const float* vs, const int* table, const int* lengths,
            const float* sinks, float* out, int B, int H, int G, int P,
            int page, int maxp, float scale, float soft_cap, int window,
            cudaStream_t stream) {
  const dim3 grid(B, G);
  paged_decode<TQ, TKV, DH><<<grid, 32 * (H / G), 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, table, lengths, sinks, out, H, G, P,
      page, maxp, scale, soft_cap, window);
}

}  // namespace

// Plain C entry point, bound with ctypes. kv_kind: 0 = K/V of q's dtype
// (bf16 or f32, K5), 1 = int8 codes with f32 k_scales/v_scales [G, P,
// page] (K6). The caller guarantees: q [B,H,DH], pools [G,P,page,DH] and
// scales contiguous and 16-byte aligned; 1 <= H / G <= 16 and H % G == 0;
// table [B,maxp] and lengths [B] int32 on the device, every table entry a
// valid physical page; sinks f32 [H] or nullptr; soft_cap <= 0 and
// window <= 0 mean none. Returns cudaGetLastError() after the launch.
extern "C" int uz_paged_attention(const void* q, const void* k, const void* v,
                                  const void* k_scales, const void* v_scales,
                                  int kv_kind, int q_is_bf16, const void* table,
                                  const void* lengths, const void* sinks,
                                  void* out, int B, int H, int G, int P,
                                  int page, int maxp, int DH, float scale,
                                  float soft_cap, int window, void* stream) {
  if (G <= 0 || H % G != 0 || H / G > MAX_REP || H / G < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* t = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
  const float* sk = static_cast<const float*>(sinks);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UZ_PAGED(TQ, TKV, D) \
  launch<TQ, TKV, D>(q, k, v, ks, vs, t, len, sk, o, B, H, G, P, page, maxp, scale, soft_cap, window, s)
  const bool i8 = kv_kind == 1;
  if (DH == 64) {
    if (q_is_bf16 && i8) UZ_PAGED(__nv_bfloat16, int8_t, 64);
    else if (q_is_bf16) UZ_PAGED(__nv_bfloat16, __nv_bfloat16, 64);
    else if (i8) UZ_PAGED(float, int8_t, 64);
    else UZ_PAGED(float, float, 64);
  } else if (DH == 128) {
    if (q_is_bf16 && i8) UZ_PAGED(__nv_bfloat16, int8_t, 128);
    else if (q_is_bf16) UZ_PAGED(__nv_bfloat16, __nv_bfloat16, 128);
    else if (i8) UZ_PAGED(float, int8_t, 128);
    else UZ_PAGED(float, float, 128);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef UZ_PAGED
  return static_cast<int>(cudaGetLastError());
}
