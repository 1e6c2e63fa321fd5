// RWKV6 WKV recurrence for Hopper. Replaces the TPU kernel
// src/repro/kernels/rwkv_wkv.py: wkv / _wkv_kernel.
//
// For each (b, h), with an fp32 hd x hd state S carried over time:
//   y_t = r_t (S + u * k_t^T v_t);   S <- diag(w_t) S + k_t^T v_t
// and the final S is returned.
//
// Bound on the H100: at a decode step (S = 1) bytes: the fp32 state is read
// and written once (32 KB per head), against 7 flops per state element. At
// prefill the time loop is sequential inside each (b, h), so latency bounds
// it: every step is a chain of hd dependent FMAs per thread.
//
// Design (the simple one; the chunked-parallel form with wgmma is later
// work): one block per (b, h) and hd = 64 threads. Thread j holds column j
// of the state in registers, so the state never leaves the SM between time
// steps; the TPU kernel's "arbitrary" chunk grid dimension becomes the loop
// over t inside the block, so there is no S % chunk requirement. At each
// step every thread stages its element of r_t, k_t and w_t in shared memory
// (double-buffered, one __syncthreads per step) and keeps v_t[j] in a
// register. The state update and the bonus term use separately rounded
// products and sums (__fmul_rn / __fadd_rn, no FMA contraction), the same
// operations as the plain PyTorch version, so the state matches it bit for
// bit and only the order of the sum that gives y differs.
//
// r, k, v (model dtype) and w (fp32) are read through (b, t, h) strides with
// a contiguous last dimension, so the model's (B,S,H,hd) projections go in
// without a transpose; y is written contiguous (B,S,H,hd) in r's type.
//
// In place: s_out may be the same buffer as s0 (the decode step updates the
// cache's state this way). Each block reads its own (b, h) state once,
// before the loop, and writes it once, after; no block touches another's
// state and each thread reads and writes only its own column. So s0 and
// s_out are deliberately not __restrict__.
#include "common.cuh"

namespace {

constexpr int kHd = 64;

template <typename T>
__global__ void __launch_bounds__(kHd)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const T* __restrict__ u, const float* s0, T* __restrict__ y,
           float* s_out, int H, int S,
           int64_t rsb, int64_t rst, int64_t rsh,
           int64_t ksb, int64_t kst, int64_t ksh,
           int64_t vsb, int64_t vst, int64_t vsh,
           int64_t wsb, int64_t wst, int64_t wsh) {
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int j = threadIdx.x;
  const int64_t state_off = ((int64_t)b * H + h) * kHd * kHd;

  __shared__ float sr[2][kHd], sk[2][kHd], sw[2][kHd], su[kHd];
  su[j] = to_f32(u[h * kHd + j]);

  float st[kHd];  // st[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < kHd; ++i)
    st[i] = s0 ? s0[state_off + i * kHd + j] : 0.f;

  const T* rp = r + b * rsb + h * rsh + j;
  const T* kp = k + b * ksb + h * ksh + j;
  const T* vp = v + b * vsb + h * vsh + j;
  const float* wp = w + b * wsb + h * wsh + j;
  T* yp = y + ((int64_t)b * S * H + h) * kHd + j;

  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    sr[buf][j] = to_f32(rp[t * rst]);
    sk[buf][j] = to_f32(kp[t * kst]);
    sw[buf][j] = wp[t * wst];
    const float vj = to_f32(vp[t * vst]);
    // one barrier per step: buffer buf is rewritten at step t + 2, after
    // every thread has passed step t + 1's barrier and so finished step t
    __syncthreads();
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kHd; ++i) {
      const float kv = __fmul_rn(sk[buf][i], vj);
      acc = fmaf(sr[buf][i], __fadd_rn(st[i], __fmul_rn(su[i], kv)), acc);
      st[i] = __fadd_rn(__fmul_rn(sw[buf][i], st[i]), kv);
    }
    yp[(int64_t)t * H * kHd] = from_f32<T>(acc);
  }

#pragma unroll
  for (int i = 0; i < kHd; ++i) s_out[state_off + i * kHd + j] = st[i];
}

}  // namespace

// strides: (b, t, h) in elements for r, k, v and w, in that order (12 values).
extern "C" int repro_wkv(const void* r, const void* k, const void* v,
                         const float* w, const void* u, const float* s0,
                         void* y, float* s_out, int B, int H, int S, int hd,
                         int64_t rsb, int64_t rst, int64_t rsh,
                         int64_t ksb, int64_t kst, int64_t ksh,
                         int64_t vsb, int64_t vst, int64_t vsh,
                         int64_t wsb, int64_t wst, int64_t wsh,
                         int dtype, void* stream) {
  if (hd != kHd) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = B * H;
  if (dtype == kF32) {
    wkv_kernel<float><<<grid, kHd, 0, s>>>(
        (const float*)r, (const float*)k, (const float*)v, w, (const float*)u,
        s0, (float*)y, s_out, H, S, rsb, rst, rsh, ksb, kst, ksh, vsb, vst,
        vsh, wsb, wst, wsh);
  } else {
    wkv_kernel<__nv_bfloat16><<<grid, kHd, 0, s>>>(
        (const __nv_bfloat16*)r, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, w, (const __nv_bfloat16*)u, s0,
        (__nv_bfloat16*)y, s_out, H, S, rsb, rst, rsh, ksb, kst, ksh, vsb,
        vst, vsh, wsb, wst, wsh);
  }
  return (int)cudaGetLastError();
}
