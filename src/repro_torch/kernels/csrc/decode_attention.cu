// Single-token decode attention against a ring-buffer KV cache, for Hopper.
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention / _decode_kernel.
//
// Bound on the H100: bytes. Every K/V slot of the (b, kv head) is read once
// and used for G query heads, about 4*G flops per element, far below the
// ridge. At the serving shape (B=4, Hkv=4, C=512, d=64, bf16) the whole call
// reads 2.1 MB, under a microsecond at 3.35 TB/s, so the launch dominates.
//
// Design: one block per (b, kv head) with one warp per query head of the GQA
// group (G warps). The loop over C inside the block replaces the TPU's
// sequential "arbitrary" kv-block grid dimension. Each 32-slot K/V tile is
// loaded once into shared memory (fp32) and shared by all G warps; lane j of
// a warp scores slot c0+j, so the tile's max and sum are warp shuffles. The
// streaming softmax keeps m, l and the (d) accumulator in fp32 registers,
// with the l == 0 guard of the TPU kernel. The ring position of slot j is
// pos - ((pos - j) mod C) with a non-negative modulo. K/V are read through
// strides, so the model's (B, C, KV*hd) cache slice is used as is.
// Splitting C across blocks (16 blocks fill few of 132 SMs) is later work.
#include "common.cuh"

namespace {

constexpr int kTile = 32;

template <typename T, int D>
__global__ void decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ pos,
                              T* __restrict__ out, int Hkv, int C, int G,
                              int64_t qb, int64_t qh,
                              int64_t kb, int64_t kh, int64_t kc,
                              int64_t vb, int64_t vh, int64_t vc,
                              int window, int chunk, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                         // [kTile][D + 1]
  float* Vs = Ks + kTile * (D + 1);         // [kTile][D]
  float* Qs = Vs + kTile * D;               // [G][D]
  float* Ps = Qs + G * D;                   // [G][kTile]

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nthreads = blockDim.x;
  const int p_now = pos[b];

  for (int i = threadIdx.x; i < G * D; i += nthreads) {
    int gg = i / D, dd = i % D;
    Qs[i] = to_f32(q[b * qb + (int64_t)(h * G + gg) * qh + dd]);
  }

  constexpr int kCols = D / 32;
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  float m = REPRO_NEG_INF, l = 0.f;

  const T* kbase = k + b * kb + h * kh;
  const T* vbase = v + b * vb + h * vh;
  for (int c0 = 0; c0 < C; c0 += kTile) {
    __syncthreads();  // previous tile fully consumed (and Qs written)
    for (int i = threadIdx.x; i < kTile * D; i += nthreads) {
      int j = i / D, dd = i % D;
      int slot = c0 + j;
      float kv_k = 0.f, kv_v = 0.f;
      if (slot < C) {
        kv_k = to_f32(kbase[slot * kc + dd]);
        kv_v = to_f32(vbase[slot * vc + dd]);
      }
      Ks[j * (D + 1) + dd] = kv_k;
      Vs[j * D + dd] = kv_v;
    }
    __syncthreads();

    const int j = c0 + lane;
    const bool in_range = j < C;
    float s = -INFINITY;
    if (in_range) {
      float dot = 0.f;
      const float* qg = Qs + g * D;
      const float* kr = Ks + lane * (D + 1);
#pragma unroll 16
      for (int dd = 0; dd < D; ++dd) dot += qg[dd] * kr[dd];
      s = dot * scale;
      int pslot = p_now - mod_nonneg(p_now - j, C);
      bool ok = pslot >= 0;
      if (window > 0) ok = ok && (p_now - pslot) < window;
      if (chunk > 0) ok = ok && floor_div(pslot, chunk) == floor_div(p_now, chunk);
      if (!ok) s = REPRO_NEG_INF;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float p = in_range ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = l * alpha + warp_sum(p);
    m = m_new;
    Ps[g * kTile + lane] = p;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      float a = acc[i] * alpha;
      const int col = lane + 32 * i;
      for (int jj = 0; jj < kTile; ++jj) a += Ps[g * kTile + jj] * Vs[jj * D + col];
      acc[i] = a;
    }
  }
  const float denom = (l == 0.f) ? 1.f : l;
  T* orow = out + ((int64_t)b * Hkv * G + (int64_t)h * G + g) * D;
#pragma unroll
  for (int i = 0; i < kCols; ++i) orow[lane + 32 * i] = from_f32<T>(acc[i] / denom);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* pos, void* out,
           int B, int Hkv, int C, int G, const int64_t* st, int window,
           int chunk, float scale, cudaStream_t s) {
  size_t smem = sizeof(float) * (kTile * (D + 1) + kTile * D + G * D + G * kTile);
  auto kern = decode_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Hkv, B);
  kern<<<grid, 32 * G, smem, s>>>((const T*)q, (const T*)k, (const T*)v, pos,
                                  (T*)out, Hkv, C, G, st[0], st[1], st[2], st[3],
                                  st[4], st[5], st[6], st[7], window, chunk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, const int* pos,
               void* out, int B, int Hkv, int C, int G, const int64_t* st,
               int window, int chunk, float scale, cudaStream_t s) {
  // head dim 64 only: the registry's configs use no other
  if (d != 64) return (int)cudaErrorInvalidValue;
  return launch<T, 64>(q, k, v, pos, out, B, Hkv, C, G, st, window, chunk, scale, s);
}

}  // namespace

// strides (in elements): q_b, q_h, k_b, k_h, k_c, v_b, v_h, v_c; the last
// (feature) dimension of q, k and v must be contiguous. out is (B, Hq, d)
// contiguous. window/chunk <= 0 mean "no mask".
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* pos, void* out, int B, int Hkv,
                                      int C, int G, int d,
                                      int64_t q_b, int64_t q_h,
                                      int64_t k_b, int64_t k_h, int64_t k_c,
                                      int64_t v_b, int64_t v_h, int64_t v_c,
                                      int window, int chunk, float scale,
                                      int dtype, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (G < 1 || G > 32 || C < 1) return (int)cudaErrorInvalidValue;
  const int64_t st[8] = {q_b, q_h, k_b, k_h, k_c, v_b, v_h, v_c};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return dispatch_d<float>(d, q, k, v, (const int*)pos, out, B, Hkv, C, G, st,
                             window, chunk, scale, s);
  return dispatch_d<__nv_bfloat16>(d, q, k, v, (const int*)pos, out, B, Hkv, C, G,
                                   st, window, chunk, scale, s);
}
