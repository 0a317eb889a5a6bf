// The merge of split-KV partials, shared by K3/K4 (flash_attention.cu) and
// K5/K6 (paged_attention.cu).
//
// A kernel that deals one row's keys to `splits` parts (K3/K4: ranges of
// tiles; K5/K6: every splits-th tile) writes, per part and row, its
// unnormalized state to f32 scratch: acc [splits, rows, dh], then m
// [splits, rows] (natural-log units; -1e30 where the part saw no key) and
// l [splits, rows]; dh is the tensors' head dim, DH >= dh the kernel's
// instantiation, or WIDE: dh > DH, and each block merges DH columns,
// [blockIdx.y * DH, blockIdx.y * DH + DH) of dh (ceil(dh / DH) block
// columns, as the wide kernels' column slices). Rows are (s, h) for K3/K4 and (b, h) for
// K5/K6, h fastest, so the head of a row is row % H. flash_combine merges
// the parts of each row in a fixed order (no atomics: greedy output
// repeats from run to run), folds the per-head sinks in once as one extra
// logit, and normalizes into out [rows, dh]. It may be launched as a
// programmatic dependent of the kernel that writes the partials (K5/K6
// do): it then waits for that grid before it reads them; launched plainly
// (K3/K4), the wait returns at once. Where `lse` is given (K3 asked for
// its rows' statistics, for its backward K3b), it also writes each row's
// log-sum-exp M + ln(Lsum), sinks left out, to lse[row]; nullptr (K4-K6,
// and K3 when serving) leaves the launch as it was.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace uz_split {

constexpr float NEG = -1e30f;

// Merge the split ranges of each (s, h) row in a fixed order, fold the
// sinks once, normalize. One warp per row.
template <int DH, bool WIDE = false>
__global__ void __launch_bounds__(256)
flash_combine(const float* __restrict__ part, const float* __restrict__ sinks,
              float* __restrict__ out, int S, int H, int dh, int splits,
              float* __restrict__ lse) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  constexpr int PER = DH / 32;
  const size_t SH = static_cast<size_t>(S) * H;
  const size_t row = static_cast<size_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int col0 = (WIDE ? static_cast<int>(blockIdx.y) * DH : 0) + lane;  // its first column
  if (row >= SH) return;
  const float* pm = part + static_cast<size_t>(splits) * SH * dh;
  const float* pl = pm + static_cast<size_t>(splits) * SH;
  float M = NEG;
  for (int i = 0; i < splits; ++i) M = fmaxf(M, pm[i * SH + row]);
  float Lsum = 0.f;
  float acc[PER];
#pragma unroll
  for (int d = 0; d < PER; ++d) acc[d] = 0.f;
  for (int i = 0; i < splits; ++i) {
    const float w = expf(pm[i * SH + row] - M);
    Lsum += pl[i * SH + row] * w;
    const float* a = part + (i * SH + row) * dh;
#pragma unroll
    for (int d = 0; d < PER; ++d) {
      if (col0 + 32 * d < dh) acc[d] += w * a[col0 + 32 * d];
    }
  }
  if (lse != nullptr && lane == 0 && blockIdx.y == 0) lse[row] = M + logf(Lsum);
  float mul = 1.f;
  if (sinks != nullptr) {
    const float sk = sinks[row % H];
    const float m2 = fmaxf(M, sk);
    mul = expf(M - m2);
    Lsum = Lsum * mul + expf(sk - m2);
  }
  mul /= fmaxf(Lsum, 1e-30f);
#pragma unroll
  for (int d = 0; d < PER; ++d) {
    if (col0 + 32 * d < dh) out[row * dh + col0 + 32 * d] = acc[d] * mul;
  }
}

}  // namespace uz_split
