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
// values and does no arithmetic. Design: one thread per output element, a
// block's threads on consecutive elements of the output rows, so every
// warp writes 128 contiguous bytes and reads the row's kg values it covers
// contiguously. At the probe's [256, 16] -> [256, 128] the whole copy is
// 144 KB, far below what it takes to fill the card: launch latency is its
// time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
block_copy(const float* __restrict__ s, float* __restrict__ out, int R, int kg, int width) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= static_cast<int64_t>(R) * width) return;
  const int64_t r = i / width;
  const int c = static_cast<int>(i - r * width);
  out[i] = c < kg ? s[r * kg + c] : 0.f;
}

}  // namespace

// Plain C entry point, bound with ctypes. The caller guarantees: s and out
// contiguous f32 on the device, R >= 1, 1 <= kg <= width. Returns
// cudaGetLastError() after the launch.
extern "C" int uz_scale_block_copy(const void* s, void* out, int R, int kg, int width,
                                   void* stream) {
  const int64_t total = static_cast<int64_t>(R) * width;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  block_copy<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<float*>(out), R, kg, width);
  return static_cast<int>(cudaGetLastError());
}
