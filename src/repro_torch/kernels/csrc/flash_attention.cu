// Forward prefill attention for Hopper. Replaces the TPU kernel
// src/repro/kernels/flash_attention.py: flash_attention / _flash_kernel.
//
// Bound on the H100: at the serving shapes (B=1, Hq=12, Hkv=4, d=64,
// S = 8..256) the call moves under 0.5 MB and does a few MFLOP, so neither
// the 3.35 TB/s nor the tensor-core rate is near: the launch and the
// per-block latency of the K/V tile loop bound it. At long S it becomes
// operation-bound (4*d flops per visible query-key pair), which wants
// wgmma/mma.sync; this first version uses plain fp32 FMA.
//
// Design: one block of 128 threads per (b, q head, 64-row q tile). Two
// threads share a query row: each scores half of a 64-column K tile and
// holds half of the row's d accumulators, and the pair combines its row max
// and sum with one shuffle. K/V tiles of 64 rows are staged in shared memory
// as fp32 and read by every row of the q tile. The softmax is online, in
// fp32, with the l == 0 guard. Tiles that the causal, window or chunk mask
// hides entirely are skipped. GQA maps q head h to kv head h / G, with no
// K/V repeat. Rows and columns past S are masked in the kernel, so S need
// not be a multiple of the tile (the TPU kernel asserts S % block == 0).
// q, k, v and the output are addressed through strides, so the model's
// (B, S, KV, G, hd) and (B, S, KV, hd) projections are used as they are.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 2 * kBQ;
constexpr int kHalfK = kBK / 2;

struct Strides {
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int G,
             Strides st, int causal, int window, int chunk, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);          // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);          // [kBK][D]
  float* Ps = Vs + kBK * D;                // [kBQ][kBK + 1]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;
  const int qpos = q0 + r;

  const T* qbase = q + b * st.qb + h * st.qh;
  const T* kbase = k + b * st.kb + kvh * st.kh;
  const T* vbase = v + b * st.vb + kvh * st.vh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    int rr = i / D, dd = i % D;
    int p = q0 + rr;
    Qs[rr * (D + 1) + dd] = p < S ? to_f32(qbase[p * st.qs + dd]) : 0.f;
  }

  constexpr int kCols = D / 2;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  float m = REPRO_NEG_INF, l = 0.f;

  const int q_hi = min(q0 + kBQ, S) - 1;
  const int n_kt = (S + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const int k_hi = min(k0 + kBK, S) - 1;
    // block-uniform visibility pre-check, as flash_attention.py:48-59
    bool visible = true;
    if (causal) visible = visible && (k0 <= q_hi);
    if (window > 0) visible = visible && (q0 - k_hi) < window;
    if (chunk > 0)
      visible = visible && (q_hi / chunk >= k0 / chunk) && (q0 / chunk <= k_hi / chunk);
    if (!visible) continue;

    __syncthreads();  // previous tile consumed (and Qs written)
    for (int i = tid; i < kBK * D; i += kThreads) {
      int j = i / D, dd = i % D;
      int p = k0 + j;
      float kk = 0.f, vv = 0.f;
      if (p < S) {
        kk = to_f32(kbase[p * st.ks + dd]);
        vv = to_f32(vbase[p * st.vs + dd]);
      }
      Ks[j * (D + 1) + dd] = kk;
      Vs[j * D + dd] = vv;
    }
    __syncthreads();

    float s[kHalfK];
    float m_tile = -INFINITY;
    const float* qr = Qs + r * (D + 1);
#pragma unroll
    for (int jj = 0; jj < kHalfK; ++jj) {
      const int j = half * kHalfK + jj;
      const int kpos = k0 + j;
      float val = -INFINITY;  // column past S: excluded entirely
      if (kpos < S) {
        const float* kr = Ks + j * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int dd = 0; dd < D; ++dd) dot += qr[dd] * kr[dd];
        val = dot * scale;
        bool ok = true;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        if (chunk > 0) ok = ok && (qpos / chunk) == (kpos / chunk);
        if (!ok) val = REPRO_NEG_INF;
      }
      s[jj] = val;
      m_tile = fmaxf(m_tile, val);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    const float m_new = fmaxf(m, m_tile);
    float psum = 0.f;
    float* prow = Ps + r * (kBK + 1);
#pragma unroll
    for (int jj = 0; jj < kHalfK; ++jj) {
      const float p = expf(s[jj] - m_new);
      psum += p;
      prow[half * kHalfK + jj] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's other half of P is written
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
    for (int j = 0; j < kBK; ++j) {
      const float p = prow[j];
      const float* vr = Vs + j * D + half * kCols;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] += p * vr[c];
    }
  }
  if (qpos < S) {
    const float denom = (l == 0.f) ? 1.f : l;
    T* orow = out + b * st.ob + h * st.oh + qpos * st.os + half * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[c] = from_f32<T>(acc[c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq,
           int S, int G, const Strides& st, int causal, int window, int chunk,
           float scale, cudaStream_t s) {
  size_t smem = sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                                 kBQ * (kBK + 1));
  auto kern = flash_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, s>>>((const T*)q, (const T*)k, (const T*)v,
                                    (T*)out, S, G, st, causal, window, chunk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* out,
               int B, int Hq, int S, int G, const Strides& st, int causal,
               int window, int chunk, float scale, cudaStream_t s) {
  // head dim 64 only: the registry's configs use no other
  if (d != 64) return (int)cudaErrorInvalidValue;
  return launch<T, 64>(q, k, v, out, B, Hq, S, G, st, causal, window, chunk, scale, s);
}

}  // namespace

// q: (B, Hq, S, d), k/v: (B, Hkv, S, d), out: (B, Hq, S, d), each given by
// its (b, h, s) strides in elements with a contiguous last dimension.
// window/chunk <= 0 mean "no mask".
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, int B, int Hq, int Hkv, int S, int d,
                                     int64_t q_b, int64_t q_h, int64_t q_s,
                                     int64_t k_b, int64_t k_h, int64_t k_s,
                                     int64_t v_b, int64_t v_h, int64_t v_s,
                                     int64_t o_b, int64_t o_h, int64_t o_s,
                                     int causal, int window, int chunk, float scale,
                                     int dtype, void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  if (Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Strides st{q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s};
  const int G = Hq / Hkv;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return dispatch_d<float>(d, q, k, v, out, B, Hq, S, G, st, causal, window,
                             chunk, scale, s);
  return dispatch_d<__nv_bfloat16>(d, q, k, v, out, B, Hq, S, G, st, causal,
                                   window, chunk, scale, s);
}
