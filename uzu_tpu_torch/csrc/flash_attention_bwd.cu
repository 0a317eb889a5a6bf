// Backward of causal GQA flash attention over a contiguous KV cache (K3b).
//
// K3 (flash_attention.cu) computes, for query row s at position pos0 + s
// (pos0 = q_positions[0], read on the device) and head h of KV group
// g = h / rep (rep = H / G):
//   S[s,h,c] = scale * q[s,h] . k[c,g]     masked to c <= qpos (and
//              c > qpos - window when window > 0)
//   P = softmax_c(S),  O[s,h] = sum_c P[s,h,c] v[c,g]
// Given dO (f32 [S, H, DH]) and K3's own output O, this computes in f32
//   L[s,h]  = logsumexp_c S[s,h,c]         (recomputed here: K3 keeps no stats)
//   D[s,h]  = sum_d dO[s,h,d] * O[s,h,d]
//   dS      = P * (dO . v[c] - D)
//   dQ[s,h] = scale * sum_c dS[s,h,c] k[c,g]
//   dK[c,g] = scale * sum_{s, h in g} dS[s,h,c] q[s,h]
//   dV[c,g] = sum_{s, h in g} P[s,h,c] dO[s,h]
// for q, k, v in f32 or bf16 (read as they are, all sums in f32). It
// replaces no TPU kernel: the JAX package differentiates attention through
// XLA (its flash kernel stays off the TPU, uzu_tpu/ops/attention.py), but
// the port sends every causal prefill over a contiguous cache to K3, which
// has no autograd, so training through the port's forward needs this
// gradient as a kernel (uzu_tpu/tools/train_tiny.py:110 takes
// jax.value_and_grad of that forward).
//
// What bounds it on the H100. Per (query row, head, visible key) the
// gradient is five products of DH (the score, dO . v, dV, dQ, dK): ~10 DH
// FLOP against ~2 DH bytes of K/V per key read once, so it is bound by
// operations at every training shape (S = 512 over 512 visible keys). Here
// those run in f32 on the CUDA cores (67 TFLOP/s at most, against 989 on
// the bf16 tensor cores): simple and right first; tensor cores are later
// work.
//
// Design (no atomics: every output element is written by one thread, in
// one order, so the gradient repeats bitwise):
// - Launch 1, flash_bwd_dq: one block (128 threads) per KV group and tile
//   of T query rows in (s, r) order, as K3 orders them, so the rep heads
//   of a group share each K/V tile. Pass 1 walks the visible key tiles for
//   each row's log-sum-exp (online max and sum); D comes from dO and O.
//   Both go to a scratch of 2 S H floats. Pass 2 walks the same tiles:
//   the scores again, dP = dO V^T, dS into shared memory, dQ += dS K in
//   registers.
// - Launch 2, flash_bwd_dkdv: one block per KV group, tile of T keys and
//   part of the query tiles; K and V stay in shared memory while it loops
//   over the query tiles of its part that see any of its keys, with L and
//   D from the scratch: P and dS into shared memory, dV += P dO and dK +=
//   dS (scale q) in registers. A block whose part no query of its keys
//   falls in (past the last query position, before the window) writes
//   zeros and loops over nothing. The parts (`parts`, from the shapes and
//   the SM count: the wrapper's `bwd_parts`) exist because a chunk from
//   position 0 has few key tiles (S=512 over 6/2 heads: 8 with any work,
//   the first walking all 24 query tiles); with more than one, each part
//   writes its partial dK/dV to scratch and launch 3, flash_bwd_sum, adds
//   them in part order.
// - Tiles are [T][DH + 1] f32 in shared memory (the pad keeps column walks
//   free of bank conflicts). Each thread of the 16 x 8 grid owns T/16 rows
//   and T/8 strided columns of a score tile, and T/16 rows by DH/8
//   strided columns of an accumulator. T is 64 for DH <= 64, 32 at 128
//   and 16 at 256, so an accumulator is 32 registers (16 at DH 32).
// - DH is an instantiation (32, 64, 128, 256); a dh between two runs in
//   the next one up with the columns past dh zero-filled on load and
//   never stored, as K3 does. Rows past S*rep and keys past C load as
//   zeros and are masked out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TY = 16;  // thread rows of the 16 x 8 grid
constexpr int TX = 8;   // thread columns (consecutive lanes)

template <int DH>
struct Tile {
  static constexpr int T = DH <= 64 ? 64 : (DH == 128 ? 32 : 16);
  static constexpr int LD = DH + 1;  // padded row of a [T][DH] tile
  static constexpr int RT = T / TY;  // score rows a thread owns
  static constexpr int CT = T / TX;  // score columns a thread owns
  static constexpr int AC = DH / TX; // accumulator columns a thread owns
  static constexpr int DQ_FLOATS = 4 * T * LD + T * (T + 1);
  static constexpr int DKDV_FLOATS = 4 * T * LD + 2 * T * (T + 1) + 3 * T;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool visible(int qpos, int c, int window) {
  return c <= qpos && (window <= 0 || c > qpos - window);
}

// the 8 lanes of one thread row (consecutive lanes) combine
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// T query rows from row rho0 of group g of a [S, H, dh] tensor, times mul;
// zeros past R = S * rep rows and past column dh
template <typename TI, int DH>
__device__ void load_rows(float* dst, const TI* __restrict__ src, int rho0, int R, int rep,
                          int H, int g, int dh, float mul) {
  constexpr int T = Tile<DH>::T, LD = Tile<DH>::LD;
  for (int e = threadIdx.x; e < T * DH; e += THREADS) {
    const int i = e / DH, d = e - i * DH, rho = rho0 + i;
    float x = 0.f;
    if (rho < R && d < dh) {
      const int s = rho / rep, h = g * rep + (rho - s * rep);
      x = to_f(src[(static_cast<size_t>(s) * H + h) * dh + d]) * mul;
    }
    dst[i * LD + d] = x;
  }
}

// T keys from slot c0 of group g of a [C, G, dh] tensor; zeros past C and dh
template <typename TI, int DH>
__device__ void load_keys(float* dst, const TI* __restrict__ src, int c0, int C, int G, int g,
                          int dh) {
  constexpr int T = Tile<DH>::T, LD = Tile<DH>::LD;
  for (int e = threadIdx.x; e < T * DH; e += THREADS) {
    const int i = e / DH, d = e - i * DH, c = c0 + i;
    dst[i * LD + d] =
        c < C && d < dh ? to_f(src[(static_cast<size_t>(c) * G + g) * dh + d]) : 0.f;
  }
}

// acc[i][j] = A[ty*RT + i] . B[tx + TX*j] over DH: one score tile
template <int DH>
__device__ __forceinline__ void dot_tile(float (&acc)[Tile<DH>::RT][Tile<DH>::CT],
                                         const float* A, const float* B) {
  constexpr int RT = Tile<DH>::RT, CT = Tile<DH>::CT, LD = Tile<DH>::LD;
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float a[RT], b[CT];
#pragma unroll
    for (int i = 0; i < RT; ++i) a[i] = A[(ty * RT + i) * LD + d];
#pragma unroll
    for (int j = 0; j < CT; ++j) b[j] = B[(tx + TX * j) * LD + d];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// acc[i][j] += sum_b P[ty*RT + i][b] * B[b][tx + TX*j]: P [T][T+1], B [T][LD]
template <int DH>
__device__ __forceinline__ void mul_tile(float (&acc)[Tile<DH>::RT][Tile<DH>::AC],
                                         const float* P, const float* B) {
  constexpr int T = Tile<DH>::T, RT = Tile<DH>::RT, AC = Tile<DH>::AC, LD = Tile<DH>::LD;
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
#pragma unroll 4
  for (int b = 0; b < T; ++b) {
    float p[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) p[i] = P[(ty * RT + i) * (T + 1) + b];
#pragma unroll
    for (int j = 0; j < AC; ++j) {
      const float x = B[b * LD + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
    }
  }
}

template <typename TI, int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const TI* __restrict__ q, const TI* __restrict__ k, const TI* __restrict__ v,
             const float* __restrict__ out, const float* __restrict__ dout,
             const int* __restrict__ q_positions, float* __restrict__ dq,
             float* __restrict__ lse, float* __restrict__ delta, int S, int H, int G, int C,
             int dh, float scale, int window) {
  using Tl = Tile<DH>;
  constexpr int T = Tl::T, LD = Tl::LD, RT = Tl::RT, CT = Tl::CT, AC = Tl::AC;
  extern __shared__ float smem[];
  float* Qs = smem;          // [T][LD] scale * q
  float* dOs = Qs + T * LD;  // [T][LD]
  float* Ks = dOs + T * LD;  // [T][LD]
  float* Vs = Ks + T * LD;   // [T][LD]
  float* Ps = Vs + T * LD;   // [T][T + 1] dS
  const int g = blockIdx.y, rep = H / G, R = S * rep, rho0 = blockIdx.x * T;
  const int pos0 = q_positions[0];
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;

  load_rows<TI, DH>(Qs, q, rho0, R, rep, H, g, dh, scale);
  load_rows<float, DH>(dOs, dout, rho0, R, rep, H, g, dh, 1.f);
  __syncthreads();

  // this thread's rows: positions (-1 past R: sees no key) and D
  int qp[RT];
  float dl[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int a = ty * RT + i, rho = rho0 + a;
    float part = 0.f;
    qp[i] = -1;
    if (rho < R) {
      const int s = rho / rep, h = g * rep + (rho - s * rep);
      qp[i] = pos0 + s;
      const float* o = out + (static_cast<size_t>(s) * H + h) * dh;
      for (int d = tx; d < dh; d += TX) part = fmaf(dOs[a * LD + d], o[d], part);
    }
    dl[i] = row_sum(part);
  }

  // the key tiles the block's rows see
  const int rho_last = min(rho0 + T, R) - 1;
  const int c_hi = min(C - 1, pos0 + rho_last / rep);
  const int c_lo = window > 0 ? max(0, pos0 + rho0 / rep - window + 1) : 0;
  const int t_lo = c_lo / T, t_hi = c_hi >= c_lo ? c_hi / T : t_lo - 1;

  // pass 1: each row's log-sum-exp, online over the tiles
  float m[RT], l[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int kt = t_lo; kt <= t_hi; ++kt) {
    __syncthreads();
    load_keys<TI, DH>(Ks, k, kt * T, C, G, g, dh);
    __syncthreads();
    float sc[RT][CT];
    dot_tile<DH>(sc, Qs, Ks);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int c = kt * T + tx + TX * j;
        if (c >= C || !visible(qp[i], c, window)) sc[i][j] = -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
      // every lane of the warp reaches both shuffles; a row that has seen
      // no key yet (mn = -inf, its scores all -inf) sums zeros and keeps m
      const float mn = fmaxf(m[i], row_max(mx));
      const float base = mn == -INFINITY ? 0.f : mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j) sum += expf(sc[i][j] - base);
      const float total = row_sum(sum);
      if (mn != -INFINITY) {
        l[i] = l[i] * expf(m[i] - mn) + total;
        m[i] = mn;
      }
    }
  }
  float L[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    L[i] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    const int rho = rho0 + ty * RT + i;
    if (tx == 0 && rho < R) {
      const int s = rho / rep, h = g * rep + (rho - s * rep);
      lse[s * H + h] = L[i];
      delta[s * H + h] = dl[i];
    }
  }

  // pass 2: dS over the same tiles, dQ += dS K
  float acc[RT][AC];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int j = 0; j < AC; ++j) acc[i][j] = 0.f;
  }
  for (int kt = t_lo; kt <= t_hi; ++kt) {
    __syncthreads();
    load_keys<TI, DH>(Ks, k, kt * T, C, G, g, dh);
    load_keys<TI, DH>(Vs, v, kt * T, C, G, g, dh);
    __syncthreads();
    float sc[RT][CT], dp[RT][CT];
    dot_tile<DH>(sc, Qs, Ks);
    dot_tile<DH>(dp, dOs, Vs);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int c = kt * T + tx + TX * j;
        const float p = c < C && visible(qp[i], c, window) ? expf(sc[i][j] - L[i]) : 0.f;
        Ps[(ty * RT + i) * (T + 1) + tx + TX * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();
    mul_tile<DH>(acc, Ps, Ks);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int rho = rho0 + ty * RT + i;
    if (rho >= R) continue;
    const int s = rho / rep, h = g * rep + (rho - s * rep);
    float* row = dq + (static_cast<size_t>(s) * H + h) * dh;
#pragma unroll
    for (int j = 0; j < AC; ++j) {
      const int d = tx + TX * j;
      if (d < dh) row[d] = acc[i][j] * scale;
    }
  }
}

template <typename TI, int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const TI* __restrict__ q, const TI* __restrict__ k, const TI* __restrict__ v,
               const float* __restrict__ dout, const int* __restrict__ q_positions,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int S, int H, int G, int C,
               int dh, float scale, int window, int parts) {
  using Tl = Tile<DH>;
  constexpr int T = Tl::T, LD = Tl::LD, RT = Tl::RT, CT = Tl::CT, AC = Tl::AC;
  extern __shared__ float smem[];
  float* Ks = smem;               // [T][LD] this block's keys
  float* Vs = Ks + T * LD;        // [T][LD]
  float* Qs = Vs + T * LD;        // [T][LD] scale * q of one query tile
  float* dOs = Qs + T * LD;       // [T][LD]
  float* Ps = dOs + T * LD;       // [T keys][T + 1] P
  float* dSs = Ps + T * (T + 1);  // [T keys][T + 1] dS
  float* Ls = dSs + T * (T + 1);  // [T] the query tile's L
  float* Ds = Ls + T;             // [T] its D
  int* Qp = reinterpret_cast<int*>(Ds + T);  // [T] its positions (-1 past R)
  const int g = blockIdx.y, rep = H / G, R = S * rep, c0 = blockIdx.x * T;
  const int pos0 = q_positions[0];
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  // this block's part of the query tiles; with parts > 1 its partial sums
  // go to slot blockIdx.z of dk/dv ([parts][C][G][dh])
  const int per = ((R + T - 1) / T + parts - 1) / parts;
  const size_t slot = static_cast<size_t>(blockIdx.z) * C * G * dh;

  // the query rows that see any key of [c0, c_last]
  const int c_last = min(c0 + T, C) - 1;
  const int s_lo = max(0, c0 - pos0);
  const int s_hi = window > 0 ? min(S - 1, c_last + window - 1 - pos0) : S - 1;

  float acc_k[RT][AC], acc_v[RT][AC];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int j = 0; j < AC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  }
  if (s_lo <= s_hi) {
    load_keys<TI, DH>(Ks, k, c0, C, G, g, dh);
    load_keys<TI, DH>(Vs, v, c0, C, G, g, dh);
    const int rt_lo = max(s_lo * rep / T, static_cast<int>(blockIdx.z) * per);
    const int rt_hi = min((s_hi * rep + rep - 1) / T, static_cast<int>(blockIdx.z + 1) * per - 1);
    for (int rt = rt_lo; rt <= rt_hi; ++rt) {
      const int rho0 = rt * T;
      __syncthreads();
      load_rows<TI, DH>(Qs, q, rho0, R, rep, H, g, dh, scale);
      load_rows<float, DH>(dOs, dout, rho0, R, rep, H, g, dh, 1.f);
      for (int b = threadIdx.x; b < T; b += THREADS) {
        const int rho = rho0 + b;
        if (rho < R) {
          const int s = rho / rep, h = g * rep + (rho - s * rep);
          Ls[b] = lse[s * H + h];
          Ds[b] = delta[s * H + h];
          Qp[b] = pos0 + s;
        } else {
          Ls[b] = INFINITY;
          Ds[b] = 0.f;
          Qp[b] = -1;
        }
      }
      __syncthreads();
      float sc[RT][CT], dp[RT][CT];
      dot_tile<DH>(sc, Ks, Qs);  // rows: keys, columns: query rows
      dot_tile<DH>(dp, Vs, dOs);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int c = c0 + ty * RT + i;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int b = tx + TX * j;
          const float p = c < C && visible(Qp[b], c, window) ? expf(sc[i][j] - Ls[b]) : 0.f;
          Ps[(ty * RT + i) * (T + 1) + b] = p;
          dSs[(ty * RT + i) * (T + 1) + b] = p * (dp[i][j] - Ds[b]);
        }
      }
      __syncthreads();
      mul_tile<DH>(acc_v, Ps, dOs);
      mul_tile<DH>(acc_k, dSs, Qs);  // Qs holds scale * q: dK's scale is in it
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int c = c0 + ty * RT + i;
    if (c >= C) continue;
    const size_t base = slot + (static_cast<size_t>(c) * G + g) * dh;
#pragma unroll
    for (int j = 0; j < AC; ++j) {
      const int d = tx + TX * j;
      if (d < dh) {
        dk[base + d] = acc_k[i][j];
        dv[base + d] = acc_v[i][j];
      }
    }
  }
}

// dk/dv [i] = the sum over p of part [p][i], p in order (launch 3)
__global__ void __launch_bounds__(256)
flash_bwd_sum(const float* __restrict__ part_k, const float* __restrict__ part_v,
              float* __restrict__ dk, float* __restrict__ dv, size_t n, int parts) {
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  float a = 0.f, b = 0.f;
  for (int p = 0; p < parts; ++p) {
    a += part_k[p * n + i];
    b += part_v[p * n + i];
  }
  dk[i] = a;
  dv[i] = b;
}

inline int head_dim_instance(int dh) {
  if (dh <= 0 || dh % 8 || dh > 256) return 0;
  return dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
}

template <typename TI, int DH>
int launch(const void* q, const void* k, const void* v, const int* qpos, const float* out,
           const float* dout, float* dq, float* dk, float* dv, float* scratch, int S, int H,
           int G, int C, int dh, float scale, int window, int parts, cudaStream_t stream) {
  using Tl = Tile<DH>;
  constexpr int dq_bytes = Tl::DQ_FLOATS * 4, dkdv_bytes = Tl::DKDV_FLOATS * 4;
  static_assert(dkdv_bytes <= 232448, "K3b's tiles pass the shared memory of a block");
  // the shared-memory attribute is per device: set it once on each
  constexpr int MAX_DEVICES = 64;
  static bool attr[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES || !attr[dev]) {
    e = cudaFuncSetAttribute(flash_bwd_dq<TI, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(flash_bwd_dkdv<TI, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) attr[dev] = true;
  }
  const int R = S * (H / G);
  float* lse = scratch;
  float* delta = scratch + static_cast<size_t>(S) * H;
  flash_bwd_dq<TI, DH><<<dim3((R + Tl::T - 1) / Tl::T, G), THREADS, dq_bytes, stream>>>(
      static_cast<const TI*>(q), static_cast<const TI*>(k), static_cast<const TI*>(v), out,
      dout, qpos, dq, lse, delta, S, H, G, C, dh, scale, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // with parts > 1 the partial sums go to scratch after the row stats
  const size_t n = static_cast<size_t>(C) * G * dh;
  float* part_k = parts > 1 ? delta + static_cast<size_t>(S) * H : dk;
  float* part_v = parts > 1 ? part_k + parts * n : dv;
  flash_bwd_dkdv<TI, DH>
      <<<dim3((C + Tl::T - 1) / Tl::T, G, parts), THREADS, dkdv_bytes, stream>>>(
          static_cast<const TI*>(q), static_cast<const TI*>(k), static_cast<const TI*>(v), dout,
          qpos, lse, delta, part_k, part_v, S, H, G, C, dh, scale, window, parts);
  if (parts > 1) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_sum<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
        part_k, part_v, dk, dv, n, parts);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TI>
int dispatch(const void* q, const void* k, const void* v, const int* qpos, const float* out,
             const float* dout, float* dq, float* dk, float* dv, float* scratch, int S, int H,
             int G, int C, int dh, float scale, int window, int parts, cudaStream_t s) {
  switch (head_dim_instance(dh)) {
    case 32:
      return launch<TI, 32>(q, k, v, qpos, out, dout, dq, dk, dv, scratch, S, H, G, C, dh,
                            scale, window, parts, s);
    case 64:
      return launch<TI, 64>(q, k, v, qpos, out, dout, dq, dk, dv, scratch, S, H, G, C, dh,
                            scale, window, parts, s);
    case 128:
      return launch<TI, 128>(q, k, v, qpos, out, dout, dq, dk, dv, scratch, S, H, G, C, dh,
                             scale, window, parts, s);
    case 256:
      return launch<TI, 256>(q, k, v, qpos, out, dout, dq, dk, dv, scratch, S, H, G, C, dh,
                             scale, window, parts, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. The caller guarantees: q [S,H,dh]
// and k/v [C,G,dh] contiguous, of one dtype (bf16 when is_bf16, else f32);
// out (K3's output) and dout f32 [S,H,dh]; dq f32 [S,H,dh], dk/dv f32
// [C,G,dh]; scratch f32 of 2*S*H values, plus 2*parts*C*G*dh when parts >
// 1; dh a positive multiple of 8 up to 256; H % G == 0; q_positions int32
// on the device; window <= 0 means none; parts >= 1. Two launches (dQ with
// the row stats, then dK/dV), three with parts > 1 (the parts' sum);
// returns cudaGetLastError() after them.
extern "C" int uz_flash_attention_bwd(const void* q, const void* k, const void* v, int is_bf16,
                                      const void* q_positions, const void* out,
                                      const void* dout, void* dq, void* dk, void* dv,
                                      void* scratch, int S, int H, int G, int C, int dh,
                                      float scale, int window, int parts, void* stream) {
  const int* qpos = static_cast<const int*>(q_positions);
  const float* o = static_cast<const float*>(out);
  const float* d_o = static_cast<const float*>(dout);
  float* gq = static_cast<float*>(dq);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(q, k, v, qpos, o, d_o, gq, gk, gv, sc, S, H, G, C, dh,
                                   scale, window, parts, s);
  }
  return dispatch<float>(q, k, v, qpos, o, d_o, gq, gk, gv, sc, S, H, G, C, dh, scale, window,
                         parts, s);
}
