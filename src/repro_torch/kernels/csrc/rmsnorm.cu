// RMSNorm for Hopper. Replaces the TPU kernel
// src/repro/kernels/rmsnorm.py: rmsnorm / _rmsnorm_kernel.
//
// Bound on the H100: bytes. Each row is read once and written once and does
// about 4 flops per element, far below the 295 flop/byte ridge. At the
// serving shapes (4 to 256 rows of 768) the whole call moves tens of KB, so
// in practice the launch itself bounds it.
//
// Design: one block per row. Each thread walks the row with a block stride,
// squares and sums in fp32; a warp-shuffle reduction then one shared-memory
// pass across warps gives the mean. The second pass normalises in fp32,
// rounds to x's type, then multiplies by the gain in fp32 and rounds again:
// the rounding order of rmsnorm.py:23 and ref.py:85. A row count that is not
// a multiple of anything needs no special case (no 1-row-block fallback), and
// any d works: the stride loop masks the ragged tail.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ g,
                               T* __restrict__ out, int d, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  __shared__ float partial[kThreads / 32];
  __shared__ float inv_rms;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) inv_rms = 1.0f / sqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float y = to_f32(from_f32<T>(to_f32(xr[i]) * r));
    orow[i] = from_f32<T>(y * to_f32(g[i]));
  }
}

}  // namespace

extern "C" int repro_rmsnorm(const void* x, const void* g, void* out,
                             int rows, int d, float eps, int dtype,
                             void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) {
    rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
        (const float*)x, (const float*)g, (float*)out, d, eps);
  } else {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (__nv_bfloat16*)out,
        d, eps);
  }
  return (int)cudaGetLastError();
}
