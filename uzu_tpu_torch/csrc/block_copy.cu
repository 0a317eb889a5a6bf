// Zero-padded copy of a block of group scales (P1).
//
//   out[r, c] = c < kg ? s[r, c] : 0      s f32 [R, kg], out f32 [R, width]
//
// Replaces the TPU kernel tools/exp_qmm_bisect.py::copy_kernel, a layout
// probe that read a [256, kg] scale block with a small lane dimension and
// wrote it lane-padded to 128 columns: o[:] = jnp.pad(s[:], ((0, 0),
// (0, 128 - kg))). On Hopper nothing about a narrow row is special, so the
// kernel is a plain copy that the bisect probe runs to check that the
// block reads back exactly.
//
// What bounds it on Hopper: bytes. It reads R*kg and writes R*width f32
// values and does no arithmetic. At the probe's [256, 16] -> [256, 128]
// the whole copy is 144 KB, far below what it takes to fill the card: the
// launch is its time. Design: each thread writes one 16-byte vector (4
// consecutive columns of a row; width is a multiple of 4), reading the up
// to 4 source values it covers, so the probe's copy is 8192 threads in 32
// blocks, one wave. `uz_empty_launch` launches a kernel that does nothing
// (one block of one warp, no memory traffic): the launch floor that P1's
// time is read against.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
block_copy(const float* __restrict__ s, float4* __restrict__ out, int R, int kg, int width4) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= static_cast<int64_t>(R) * width4) return;
  const int64_t r = i / width4;
  const int c = static_cast<int>(i - r * width4) * 4;
  const float* row = s + r * kg;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = c + j < kg ? row[c + j] : 0.f;
  out[i] = make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void empty_kernel() {}

}  // namespace

// Plain C entry point, bound with ctypes. The caller guarantees: s and out
// contiguous f32 on the device, out 16-byte aligned, R >= 1, 1 <= kg <=
// width, width % 4 == 0. Returns cudaGetLastError() after the launch.
extern "C" int uz_scale_block_copy(const void* s, void* out, int R, int kg, int width,
                                   void* stream) {
  const int width4 = width / 4;
  const int64_t total = static_cast<int64_t>(R) * width4;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  block_copy<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<float4*>(out), R, kg, width4);
  return static_cast<int>(cudaGetLastError());
}

// One launch of a kernel that does nothing. Returns cudaGetLastError().
extern "C" int uz_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
