// Causal GQA flash attention over a contiguous KV cache (K3), and the same
// over an INT8 cache (K4).
//
// K3 replaces the TPU kernel uzu_tpu/ops/pallas/flash_attention.py::_kernel_plain
// (launched by _flash_p). q is [S, H, DH], the cache k/v is [C, G, DH]
// (slot j holds token position j), both bf16 or f32; query row s sits at
// position pos0 + s, with pos0 = q_positions[0] read on the device (so a
// chunked prefill needs no host sync). Head h belongs to KV group
// h / rep (h = g*rep + r, rep = H / G). Per row: scores = (q . k) * scale,
// optional tanh soft cap, causal mask kpos <= qpos, optional sliding
// window kpos > qpos - window, online softmax across KV tiles, and
// per-head sinks folded in once after the last tile as one extra logit.
// Output is f32 [S, H, DH].
//
// What bounds it on Hopper. Each block reads its group's K/V rows once and
// does ~4*DH FLOP per (query row, visible key); at prefill widths (S*rep
// of 64..1024 rows per group) that is well above the H100's ~295
// FLOP/byte, so the kernel is bound by arithmetic, and the score matrix
// never goes to HBM. Design: one 256-thread block per (KV group, tile of
// 64 query rows ordered (s, r)), so the rep heads that share a KV group
// share every K/V tile loaded; 4 threads per query row, each owning 8
// score columns of a 32-slot KV tile and 16 (DH=64) output dims; K/V
// tiles staged through shared memory as f32; running max, sum and
// accumulator kept per row in registers. KV tiles wholly above the causal
// diagonal or wholly outside the window are never loaded. Arithmetic is
// f32 FMA on the CUDA cores (a tensor-core version is later work), in a
// fixed order: the result is the same from run to run.
//
// Not carried over from the TPU kernel: the lane-replicated stat scratch,
// the iota-matmul sink expansion, and the tile-divisibility constraints.
//
// K4 replaces flash_attention.py::_kernel_quant: the cache is int8 codes
// [C, G, DH] with one f32 scale per (slot, group) in k_scales/v_scales
// [C, G]. It is the same kernel instantiated for int8 K/V: a thread loads
// 8 codes (8 bytes) of a row, converts them and multiplies by the row's
// scale in registers while staging the tile, so the cache is read at one
// byte per value and no dequantized copy of it is ever made in HBM. The
// staged tile holds exactly codes * scale in f32, the plain version's
// dequantized value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // KV slots per tile
constexpr int TPR = 4;         // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr int CPT = BK / TPR;  // score columns per thread
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Load 8 consecutive values (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const int2 u = *reinterpret_cast<const int2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(b[i]);
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

// TQ: the query type; TKV: the cache type (TQ, or int8_t with per-(slot,
// group) scales k_sc/v_sc; nullptr otherwise).
template <typename TQ, typename TKV, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const TQ* __restrict__ q, const TKV* __restrict__ k,
          const TKV* __restrict__ v, const float* __restrict__ k_sc,
          const float* __restrict__ v_sc, const int* __restrict__ q_positions,
          const float* __restrict__ sinks, float* __restrict__ out, int S,
          int H, int G, int C, float scale, float soft_cap, int window) {
  constexpr int DPT = DH / TPR;  // output dims per thread
  __shared__ float ks[BK][DH + 1];
  __shared__ float vs[BK][DH + 1];
  __shared__ float ps[BQ][BK + 1];

  const int rep = H / G;
  const int R = S * rep;
  const int g = blockIdx.y;
  const int row0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int lr = tid / TPR;
  const int part = tid % TPR;
  const int row = row0 + lr;
  const bool row_ok = row < R;
  const int s_idx = row_ok ? row / rep : 0;
  const int h = g * rep + (row_ok ? row % rep : 0);
  const int pos0 = q_positions[0];
  const int qp = pos0 + s_idx;

  // KV slots this tile of rows can see
  const int row_last = min(row0 + BQ, R) - 1;
  const int q_lo = pos0 + row0 / rep;
  const int q_hi = pos0 + row_last / rep;
  const int kv_end = min(C, q_hi + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_lo - window + 1);
  kv_begin = (kv_begin / BK) * BK;

  const size_t kv_stride = static_cast<size_t>(G) * DH;  // between slots

  float qr[DH];
  {
    const TQ* qrow = q + (static_cast<size_t>(s_idx) * H + h) * DH;
#pragma unroll
    for (int d = 0; d < DH; d += 8) load8(qrow + d, qr + d);
  }
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m_run = NEG;
  float l_run = 0.f;

  for (int c0 = kv_begin; c0 < kv_end; c0 += BK) {
    // stage K/V tile [BK, DH] of group g as f32
    for (int i = tid; i < BK * DH / 8; i += THREADS) {
      const int c = i / (DH / 8);
      const int d8 = (i % (DH / 8)) * 8;
      float kv8[8], vv8[8];
      if (c0 + c < C) {
        const size_t off = static_cast<size_t>(c0 + c) * kv_stride + static_cast<size_t>(g) * DH + d8;
        load8(k + off, kv8);
        load8(v + off, vv8);
        if (k_sc != nullptr) {
          const size_t srow = static_cast<size_t>(c0 + c) * G + g;
          const float ka = k_sc[srow];
          const float va = v_sc[srow];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            kv8[j] *= ka;
            vv8[j] *= va;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kv8[j] = vv8[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ks[c][d8 + j] = kv8[j];
        vs[c][d8 + j] = vv8[j];
      }
    }
    __syncthreads();

    float sc[CPT];
    float tmax = NEG;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = part + TPR * j;
      const int kp = c0 + c;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], ks[c][d], dot);
      float s = dot * scale;
      if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
      bool valid = row_ok && kp < C && kp <= qp;
      if (window > 0) valid = valid && kp > qp - window;
      sc[j] = valid ? s : NEG;
      tmax = fmaxf(tmax, sc[j]);
    }
    // the 4 threads of a row are adjacent lanes
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = sc[j] > 0.5f * NEG ? expf(sc[j] - m_new) : 0.f;
      ps[lr][part + TPR * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = ps[lr][c];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vs[c][part * DPT + i], acc[i]);
    }
    __syncthreads();
  }

  if (!row_ok) return;
  if (sinks != nullptr) {
    const float sink = sinks[h];
    const float m2 = fmaxf(m_run, sink);
    const float corr = expf(m_run - m2);
    l_run = l_run * corr + expf(sink - m2);
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
  }
  const float inv = 1.f / fmaxf(l_run, 1e-30f);
  float* orow = out + (static_cast<size_t>(s_idx) * H + h) * DH + part * DPT;
#pragma unroll
  for (int i = 0; i < DPT; ++i) orow[i] = acc[i] * inv;
}

template <typename TQ, typename TKV, int DH>
void launch(const void* q, const void* k, const void* v, const float* ks,
            const float* vs, const int* qpos, const float* sinks, float* out,
            int S, int H, int G, int C, float scale, float soft_cap,
            int window, cudaStream_t stream) {
  const int R = S * (H / G);
  const dim3 grid((R + BQ - 1) / BQ, G);
  flash_fwd<TQ, TKV, DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, qpos, sinks, out, S, H, G, C, scale,
      soft_cap, window);
}

template <typename TQ, typename TKV>
int dispatch(const void* q, const void* k, const void* v, const float* ks,
             const float* vs, const int* qpos, const float* sk, float* o, int S,
             int H, int G, int C, int DH, float scale, float soft_cap, int window,
             cudaStream_t s) {
  if (DH == 64) {
    launch<TQ, TKV, 64>(q, k, v, ks, vs, qpos, sk, o, S, H, G, C, scale, soft_cap, window, s);
  } else if (DH == 128) {
    launch<TQ, TKV, 128>(q, k, v, ks, vs, qpos, sk, o, S, H, G, C, scale, soft_cap, window, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. The caller guarantees: q [S,H,DH]
// and k/v [C,G,DH] contiguous, 16-byte aligned; H % G == 0; q_positions
// int32 on the device; sinks f32 [H] or nullptr; soft_cap <= 0 and
// window <= 0 mean none. K3: q, k, v of one dtype (bf16 or f32). K4: k/v
// int8 codes with f32 scales [C,G]; q bf16 or f32. Each returns
// cudaGetLastError() after the launch.
extern "C" int uz_flash_attention(const void* q, const void* k, const void* v,
                                  int is_bf16, const void* q_positions,
                                  const void* sinks, void* out, int S, int H,
                                  int G, int C, int DH, float scale,
                                  float soft_cap, int window, void* stream) {
  const int* qpos = static_cast<const int*>(q_positions);
  const float* sk = static_cast<const float*>(sinks);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16, __nv_bfloat16>(q, k, v, nullptr, nullptr, qpos, sk, o, S,
                                                  H, G, C, DH, scale, soft_cap, window, s);
  }
  return dispatch<float, float>(q, k, v, nullptr, nullptr, qpos, sk, o, S, H, G, C, DH,
                                scale, soft_cap, window, s);
}

extern "C" int uz_flash_attention_i8(const void* q, const void* k_codes,
                                     const void* k_scales, const void* v_codes,
                                     const void* v_scales, int is_bf16,
                                     const void* q_positions, const void* sinks,
                                     void* out, int S, int H, int G, int C,
                                     int DH, float scale, float soft_cap,
                                     int window, void* stream) {
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* qpos = static_cast<const int*>(q_positions);
  const float* sk = static_cast<const float*>(sinks);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16, int8_t>(q, k_codes, v_codes, ks, vs, qpos, sk, o, S, H, G,
                                           C, DH, scale, soft_cap, window, s);
  }
  return dispatch<float, int8_t>(q, k_codes, v_codes, ks, vs, qpos, sk, o, S, H, G, C, DH,
                                 scale, soft_cap, window, s);
}
