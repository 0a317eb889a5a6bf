// Mamba-1 selective scan (S1): the recurrence of Jamba's Mamba mixers.
//
//   delta_t = softplus(dt_t + dt_bias)                       [Di]
//   h_t     = exp(delta_t A) * h_{t-1} + delta_t B_t x_t      [Di, N], A = -exp(A_log)
//   y_t     = (h_t C_t + D x_t) * silu(z_t)                   [Di]
//
// x, dt, z bf16 [Bt, S, Di] (last dim contiguous, any row and batch
// stride), B, C bf16 [Bt, S, N], A_log f32 [Di, N], dt_bias and D f32
// [Di], h0 f32 [Bt, Di, N], lengths int32 [Bt]; y bf16 [Bt, S, Di]
// contiguous, h_out f32 [Bt, Di, N]. Rows t >= lengths[b] are identity
// transitions (h unchanged; y still written from the unchanged h). N = 16.
//
// Replaces no TPU kernel: the JAX package has no Mamba-1 mixer, and its
// Mamba2 runs as plain products in XLA. Mamba-1's decay is one per channel
// and state, so the chunked matrix form that Mamba2's single decay per head
// allows does not exist; in plain ops every step materialises [Di, N] f32
// decays and inputs and runs the time loop step by step from the host.
//
// What bounds it on this card: bytes, read once. A row reads x, dt, z (bf16,
// 3 Di values), B and C, and writes y: ~41 KB a row at Jamba's Di = 5120,
// ~50 us for a 4096-row chunk at 3.35 TB/s; the state (327 KB a sequence)
// is read and written once per call. The operations (16 exp2 and ~64 FMA a
// channel a row) are well under the card's rates, but the recurrence is
// sequential in t, so each step's latency, not its arithmetic, sets the
// time: the design spreads the sequential work over as many warps as the
// channels allow.
//
// Design. Four threads own one channel, four states each (h and A in
// registers for the whole chunk), so a block of 64 threads holds 16
// channels and a 5120-channel sequence is 320 blocks. The chunk kernel
// walks S in tiles of T_TILE rows staged in shared memory with cp.async,
// two stages deep, so the next tile's x, dt, z, B and C arrive while this
// one is scanned. Each tile takes three passes, so that the sequential one
// carries nothing but h: the step sizes (softplus, delta x) of all its rows
// at once; then the recurrence, row after row, each thread writing its
// four states' share of h C to shared memory; then y = (h C + D x)
// silu(z) for all its rows at once, stored 16 channels a row together.
// exp(delta A) is one exp2 with A pre-scaled by log2(e). The decode step
// (S = 1) reads its one row straight from device memory: a block per (16
// channels, slot), its y part summed over the four threads with two
// shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_STATE = 16;
constexpr int QUARTERS = 4;                     // threads a channel
constexpr int PER_THREAD = N_STATE / QUARTERS;  // states a thread
constexpr int CH = 16;                          // channels a block
constexpr int THREADS = CH * QUARTERS;
constexpr int T_TILE = 64;  // rows a staged tile
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long x_b, x_t, dt_b, dt_t, z_b, z_t, b_b, b_t, c_b, c_t;
};

__device__ __forceinline__ float bf(const __nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float softplus(float v) {
  // the plain version's threshold (models/ssm.py `_softplus`)
  return v > 20.f ? v : log1pf(expf(v));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One tile: x, dt, z for the block's 16 channels and B, C for all N, rows
// [t0, t0 + rows). Each row of each array is two 16-byte pieces.
struct Tile {
  __nv_bfloat16 x[T_TILE][CH];
  __nv_bfloat16 dt[T_TILE][CH];
  __nv_bfloat16 z[T_TILE][CH];
  __nv_bfloat16 b[T_TILE][N_STATE];
  __nv_bfloat16 c[T_TILE][N_STATE];
};

__device__ __forceinline__ void load_tile(Tile& tile, const __nv_bfloat16* x,
                                          const __nv_bfloat16* dt, const __nv_bfloat16* z,
                                          const __nv_bfloat16* bm, const __nv_bfloat16* cm,
                                          const Strides& st, int batch, int d0, int t0,
                                          int rows) {
  for (int i = threadIdx.x; i < 5 * T_TILE * 2; i += THREADS) {
    const int arr = i / (T_TILE * 2);
    const int r = (i % (T_TILE * 2)) >> 1;
    const int half = i & 1;
    if (r >= rows) continue;
    const long long t = t0 + r;
    const __nv_bfloat16* src;
    __nv_bfloat16* dst;
    switch (arr) {
      case 0:
        src = x + batch * st.x_b + t * st.x_t + d0;
        dst = tile.x[r];
        break;
      case 1:
        src = dt + batch * st.dt_b + t * st.dt_t + d0;
        dst = tile.dt[r];
        break;
      case 2:
        src = z + batch * st.z_b + t * st.z_t + d0;
        dst = tile.z[r];
        break;
      case 3:
        src = bm + batch * st.b_b + t * st.b_t;
        dst = tile.b[r];
        break;
      default:
        src = cm + batch * st.c_b + t * st.c_t;
        dst = tile.c[r];
        break;
    }
    cp_async16(dst + half * 8, src + half * 8);
  }
  cp_async_commit();
}

// One step of one thread's four states; returns the channel's y (summed
// over its four threads) and updates h in place where `valid`.
__device__ __forceinline__ float step(float (&h)[PER_THREAD], const float (&a2)[PER_THREAD],
                                      float delta, float xv, const __nv_bfloat16* bq,
                                      const __nv_bfloat16* cq, bool valid) {
  const float dx = delta * xv;
  const uint2 braw = *reinterpret_cast<const uint2*>(bq);
  const uint2 craw = *reinterpret_cast<const uint2*>(cq);
  const __nv_bfloat16* bv = reinterpret_cast<const __nv_bfloat16*>(&braw);
  const __nv_bfloat16* cv = reinterpret_cast<const __nv_bfloat16*>(&craw);
  float y = 0.f;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const float hn = fmaf(exp2f(delta * a2[j]), h[j], dx * bf(bv[j]));
    h[j] = valid ? hn : h[j];
    y = fmaf(bf(cv[j]), h[j], y);
  }
  y += __shfl_xor_sync(0xffffffffu, y, 1);
  y += __shfl_xor_sync(0xffffffffu, y, 2);
  return y;
}

__device__ __forceinline__ float gate(float y, float dskip, float xv, float zv) {
  return (y + dskip * xv) * (zv / (1.f + expf(-zv)));
}

__global__ void __launch_bounds__(THREADS)
selective_scan_chunk(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dt,
                     const __nv_bfloat16* __restrict__ z, const __nv_bfloat16* __restrict__ bm,
                     const __nv_bfloat16* __restrict__ cm, const float* __restrict__ a_log,
                     const float* __restrict__ dt_bias, const float* __restrict__ d_skip,
                     const float* __restrict__ h0, const int* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ h_out, int S, int Di,
                     Strides st) {
  __shared__ __align__(16) Tile tiles[2];
  __shared__ float delta_s[T_TILE][CH];           // softplus(dt + bias); 0 past the length
  __shared__ float dx_s[T_TILE][CH];              // delta * x
  __shared__ __align__(16) float ypart[T_TILE][THREADS];  // each thread's h C over its states
  __shared__ float bias_s[CH], dskip_s[CH];
  const int batch = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int q = tid & (QUARTERS - 1);
  const int ch = tid / QUARTERS;
  const long long hoff =
      (static_cast<long long>(batch) * Di + d0 + ch) * N_STATE + q * PER_THREAD;

  float h[PER_THREAD], a2[PER_THREAD];
  const float4 hv = *reinterpret_cast<const float4*>(h0 + hoff);
  const float4 av = *reinterpret_cast<const float4*>(
      a_log + static_cast<long long>(d0 + ch) * N_STATE + q * PER_THREAD);
  h[0] = hv.x, h[1] = hv.y, h[2] = hv.z, h[3] = hv.w;
  a2[0] = -expf(av.x) * LOG2E, a2[1] = -expf(av.y) * LOG2E;
  a2[2] = -expf(av.z) * LOG2E, a2[3] = -expf(av.w) * LOG2E;
  if (tid < CH) {
    bias_s[tid] = dt_bias[d0 + tid];
    dskip_s[tid] = d_skip[d0 + tid];
  }
  const int len = lengths[batch];
  __nv_bfloat16* yb = y + static_cast<long long>(batch) * S * Di + d0;

  const int ntiles = (S + T_TILE - 1) / T_TILE;
  load_tile(tiles[0], x, dt, z, bm, cm, st, batch, d0, 0, min(T_TILE, S));
  for (int tile = 0; tile < ntiles; ++tile) {
    const int t0 = tile * T_TILE;
    if (tile + 1 < ntiles) {
      load_tile(tiles[(tile + 1) & 1], x, dt, z, bm, cm, st, batch, d0, t0 + T_TILE,
                min(T_TILE, S - t0 - T_TILE));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Tile& tl = tiles[tile & 1];
    const int rows = min(T_TILE, S - t0);
    // 1: the step sizes of the tile's rows, off the recurrence's path; a
    // row past the length takes delta 0: decay exp2(0) = 1, input 0
    for (int i = tid; i < rows * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      const float dl = t0 + r < len ? softplus(bf(tl.dt[r][c]) + bias_s[c]) : 0.f;
      delta_s[r][c] = dl;
      dx_s[r][c] = dl * bf(tl.x[r][c]);
    }
    __syncthreads();
    // 2: the recurrence, row after row; h is the only value carried
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const float dl = delta_s[r][ch], dxv = dx_s[r][ch];
      const uint2 braw = *reinterpret_cast<const uint2*>(tl.b[r] + q * PER_THREAD);
      const uint2 craw = *reinterpret_cast<const uint2*>(tl.c[r] + q * PER_THREAD);
      const __nv_bfloat16* bv = reinterpret_cast<const __nv_bfloat16*>(&braw);
      const __nv_bfloat16* cv = reinterpret_cast<const __nv_bfloat16*>(&craw);
      float yp = 0.f;
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        h[j] = fmaf(exp2f(dl * a2[j]), h[j], dxv * bf(bv[j]));
        yp = fmaf(bf(cv[j]), h[j], yp);
      }
      ypart[r][tid] = yp;
    }
    __syncthreads();
    // 3: y = (h C + D x) silu(z) for the tile, 16 channels of a row together
    for (int i = tid; i < rows * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      const float4 p = *reinterpret_cast<const float4*>(&ypart[r][c * QUARTERS]);
      yb[static_cast<long long>(t0 + r) * Di + c] = __float2bfloat16(
          gate(p.x + p.y + p.z + p.w, dskip_s[c], bf(tl.x[r][c]), bf(tl.z[r][c])));
    }
    __syncthreads();  // the stage and the scratch are refilled by the next tile
  }
  *reinterpret_cast<float4*>(h_out + hoff) = make_float4(h[0], h[1], h[2], h[3]);
}

__global__ void __launch_bounds__(THREADS)
selective_scan_step(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dt,
                    const __nv_bfloat16* __restrict__ z, const __nv_bfloat16* __restrict__ bm,
                    const __nv_bfloat16* __restrict__ cm, const float* __restrict__ a_log,
                    const float* __restrict__ dt_bias, const float* __restrict__ d_skip,
                    const float* __restrict__ h0, const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ h_out, int Di,
                    Strides st) {
  const int batch = blockIdx.y;
  const int q = threadIdx.x & (QUARTERS - 1);
  const int d = blockIdx.x * CH + threadIdx.x / QUARTERS;
  const long long hoff = (static_cast<long long>(batch) * Di + d) * N_STATE + q * PER_THREAD;

  float h[PER_THREAD], a2[PER_THREAD];
  const float4 hv = *reinterpret_cast<const float4*>(h0 + hoff);
  const float4 av = *reinterpret_cast<const float4*>(a_log + static_cast<long long>(d) * N_STATE +
                                                     q * PER_THREAD);
  h[0] = hv.x, h[1] = hv.y, h[2] = hv.z, h[3] = hv.w;
  a2[0] = -expf(av.x) * LOG2E, a2[1] = -expf(av.y) * LOG2E;
  a2[2] = -expf(av.z) * LOG2E, a2[3] = -expf(av.w) * LOG2E;
  const float xv = bf(x[batch * st.x_b + d]);
  const float zv = bf(z[batch * st.z_b + d]);
  const float delta = softplus(bf(dt[batch * st.dt_b + d]) + dt_bias[d]);
  const float yv = step(h, a2, delta, xv, bm + batch * st.b_b + q * PER_THREAD,
                        cm + batch * st.c_b + q * PER_THREAD, lengths[batch] > 0);
  if (q == 0) y[static_cast<long long>(batch) * Di + d] = __float2bfloat16(gate(yv, d_skip[d], xv, zv));
  *reinterpret_cast<float4*>(h_out + hoff) = make_float4(h[0], h[1], h[2], h[3]);
}

}  // namespace

// Plain C entry points, bound with ctypes. The caller guarantees: the
// shapes above with N = 16 and Di % 16 == 0; x, dt, z, B, C with a
// contiguous last dim, every stride (in elements) a multiple of 8 and every
// base 16-byte aligned (the chunk kernel copies 16-byte pieces); a_log, h0
// and h_out contiguous and 16-byte aligned; y contiguous. `uz_selective_scan`
// scans S rows (any S >= 1); `uz_selective_scan_step` takes S = 1 (the row
// strides are not read). Each returns cudaGetLastError() after its launch.
extern "C" int uz_selective_scan(const void* x, const void* dt, const void* z, const void* bm,
                                 const void* cm, const void* a_log, const void* dt_bias,
                                 const void* d_skip, const void* h0, const void* lengths, void* y,
                                 void* h_out, int Bt, int S, int Di, long long x_b, long long x_t,
                                 long long dt_b, long long dt_t, long long z_b, long long z_t,
                                 long long b_b, long long b_t, long long c_b, long long c_t,
                                 void* stream) {
  const Strides st{x_b, x_t, dt_b, dt_t, z_b, z_t, b_b, b_t, c_b, c_t};
  const dim3 grid(Di / CH, Bt);
  selective_scan_chunk<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dt),
      static_cast<const __nv_bfloat16*>(z), static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), static_cast<const float*>(a_log),
      static_cast<const float*>(dt_bias), static_cast<const float*>(d_skip),
      static_cast<const float*>(h0), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(h_out), S, Di, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int uz_selective_scan_step(const void* x, const void* dt, const void* z,
                                      const void* bm, const void* cm, const void* a_log,
                                      const void* dt_bias, const void* d_skip, const void* h0,
                                      const void* lengths, void* y, void* h_out, int Bt, int S,
                                      int Di, long long x_b, long long x_t, long long dt_b,
                                      long long dt_t, long long z_b, long long z_t, long long b_b,
                                      long long b_t, long long c_b, long long c_t, void* stream) {
  const Strides st{x_b, x_t, dt_b, dt_t, z_b, z_t, b_b, b_t, c_b, c_t};
  const dim3 grid(Di / CH, Bt);
  selective_scan_step<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dt),
      static_cast<const __nv_bfloat16*>(z), static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), static_cast<const float*>(a_log),
      static_cast<const float*>(dt_bias), static_cast<const float*>(d_skip),
      static_cast<const float*>(h0), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(h_out), Di, st);
  return static_cast<int>(cudaGetLastError());
}
