// Rotary embedding of q and k for Hopper, and at a decode step the append
// of the roped K and of V to the ring-buffer cache, in one launch.
//
// Replaces no TPU kernel. The JAX package ropes with jnp ops
// (src/repro/models/common.py: rope), which XLA fuses, and writes the ring
// with an indexed update (src/repro/models/attention.py: decode_attend).
// Run eagerly, the same arithmetic took 18 aten launches per rope call
// (frequency table, angle, cos, sin, the half copies, four products, a sub,
// an add, a cat, a cast), two calls a layer, and five more for the ring
// write (pos.long(), remainder, arange, two index_put_): 41 of a dense
// decode layer's 55 launches. At a served decode step the host's dispatch
// of those launches is the step, so they become one launch a layer.
//
// Bound on the H100: bytes. Each element of q and k (and of v at a decode
// step) is read once and written once, with six flops; the exp, cos and sin
// depend only on (position, frequency), so each block computes them once
// for its row and every head of the row shares them. A decode step (32
// rows of 32 + 8 heads of 64) moves 0.39 MB, a tenth of a microsecond at
// 3.35 TB/s: the launch and one memory round trip are what count. A prefill
// of 8,192 rows of 48 + 8 heads of 128 moves 235 MB, about 70 us.
//
// Design: one block per row (b, s). Its threads first fill a shared table of
// cos and sin for the row's position at the hd/2 frequencies, then walk the
// row's work items: for each q head and each k head, `half / vec` chunks of
// `vec` rotate-half pairs (x[i], x[i + half]); at a decode step also each v
// head's `hd / vec` chunks, copied bit for bit. Roped q goes to a fresh
// contiguous (B,S,Hq,hd); roped k to a fresh (B,S,KV,hd) at a prefill, or,
// with a ring of C slots, with v into slot pos % C of the (B,C,KV*hd) rings,
// in place. pos is read on the device. The geometry (`geometry` below)
// depends on shapes only: B*S blocks; vec = 16 bytes of elements when every
// pointer and row/head stride is a multiple of 16 bytes and hd/2 is a
// multiple of it, else 1 (the scalar path of the same kernel); threads = the
// row's items rounded up to a warp, at most 256.
//
// Numerics are those of the plain version (kernels/rope.py: rope_plain) run
// on the card, op by op in fp32: freq_i = expf((c * i) * (1 / half)) with
// c = (float)(-ln theta) (torch's CUDA division by a host scalar multiplies
// by its reciprocal), angle = float(pos) * freq_i, cosf and sinf, then
// x1*cos - x2*sin and x2*cos + x1*sin with each product rounded on its own
// (__fmul_rn, __fsub_rn, __fadd_rn: no contraction into an FMA), and one
// rounding to the element type at the end. The build has no fast math.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxHalf = 256;      // head dims up to 512

struct Args {
  const void* q;
  const void* k;
  const void* v;            // null at a prefill
  const int* pos;
  void* q_out;
  void* k_out;
  void* v_out;              // null at a prefill
  int S, Hq, KV, hd, C;     // C > 0: k_out/v_out are rings of C slots
  // strides in elements: q, k, v by (b, s, head); pos by (b, s); the k and
  // v destinations by (b, row), row being s, or the ring slot pos % C
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, p_b, p_s;
  int64_t ko_b, ko_r, vo_b, vo_r;
  float neg_log_theta, inv_half;
};

struct Geometry {
  int vec, items, threads, blocks;
};

Geometry geometry(int rows, int Hq, int KV, int hd, bool ring, int elem_bytes,
                  bool aligned) {
  Geometry g;
  const int v16 = 16 / elem_bytes, half = hd / 2;
  g.vec = (aligned && half % v16 == 0) ? v16 : 1;
  g.items = (Hq + KV) * (half / g.vec) + (ring ? KV * (hd / g.vec) : 0);
  const int warps = (g.items + 31) / 32;
  g.threads = warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
  g.blocks = rows;
  return g;
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  if constexpr (VEC == 1)
    f[0] = to_f32(*p);
  else
    unpack16(*reinterpret_cast<const uint4*>(p), f, T());
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  if constexpr (VEC == 1)
    *p = from_f32<T>(f[0]);
  else
    *reinterpret_cast<uint4*>(p) = pack16(f, T());
}

template <typename T, int VEC>
__device__ __forceinline__ void copy_vec(const T* src, T* dst) {
  if constexpr (VEC == 1)
    *dst = *src;
  else
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads) rope_kernel(const Args a) {
  __shared__ float cos_t[kMaxHalf], sin_t[kMaxHalf];
  const int row = blockIdx.x;
  const int b = row / a.S, s = row - b * a.S;
  const int p = a.pos[b * a.p_b + s * a.p_s];
  const int half = a.hd >> 1;
  const float pf = __int2float_rn(p);
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const float freq = expf(__fmul_rn(__fmul_rn(a.neg_log_theta, __int2float_rn(i)),
                                      a.inv_half));
    const float ang = __fmul_rn(pf, freq);
    cos_t[i] = cosf(ang);
    sin_t[i] = sinf(ang);
  }
  __syncthreads();

  const int dst = a.C > 0 ? mod_nonneg(p, a.C) : s;
  const T* q = static_cast<const T*>(a.q) + b * a.q_b + s * a.q_s;
  const T* k = static_cast<const T*>(a.k) + b * a.k_b + s * a.k_s;
  T* qo = static_cast<T*>(a.q_out) + (int64_t)row * a.Hq * a.hd;
  T* ko = static_cast<T*>(a.k_out) + b * a.ko_b + dst * a.ko_r;
  const int per_half = half / VEC, per_head = a.hd / VEC;
  const int n_q = a.Hq * per_half, n_qk = n_q + a.KV * per_half;
  const int n = n_qk + (a.v ? a.KV * per_head : 0);
  for (int it = threadIdx.x; it < n; it += blockDim.x) {
    if (it < n_qk) {
      const bool is_q = it < n_q;
      const int j = is_q ? it : it - n_q;
      const int h = j / per_half, c = (j - h * per_half) * VEC;
      const T* src = is_q ? q + h * a.q_h : k + h * a.k_h;
      T* out = (is_q ? qo : ko) + h * a.hd;
      float x1[VEC], x2[VEC], o1[VEC], o2[VEC];
      load_vec<T, VEC>(src + c, x1);
      load_vec<T, VEC>(src + half + c, x2);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float cs = cos_t[c + e], sn = sin_t[c + e];
        o1[e] = __fsub_rn(__fmul_rn(x1[e], cs), __fmul_rn(x2[e], sn));
        o2[e] = __fadd_rn(__fmul_rn(x2[e], cs), __fmul_rn(x1[e], sn));
      }
      store_vec<T, VEC>(out + c, o1);
      store_vec<T, VEC>(out + half + c, o2);
    } else {
      const int j = it - n_qk;
      const int h = j / per_head, c = (j - h * per_head) * VEC;
      const T* src = static_cast<const T*>(a.v) + b * a.v_b + s * a.v_s + h * a.v_h;
      T* out = static_cast<T*>(a.v_out) + b * a.vo_b + dst * a.vo_r + h * a.hd;
      copy_vec<T, VEC>(src + c, out + c);
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// a stride that matters (its dimension is longer than 1) in 16-byte steps
bool stride16(int64_t stride, int n, int elem_bytes) {
  return n <= 1 || (stride * elem_bytes) % 16 == 0;
}

template <typename T>
int run(const Args& a, int B, cudaStream_t s) {
  const int es = sizeof(T);
  const bool ring = a.C > 0;
  const int rows_to = ring ? a.C : a.S;
  bool aligned = aligned16(a.q) && aligned16(a.k) && aligned16(a.q_out) &&
                 aligned16(a.k_out) &&
                 stride16(a.q_b, B, es) && stride16(a.q_s, a.S, es) &&
                 stride16(a.q_h, a.Hq, es) && stride16(a.k_b, B, es) &&
                 stride16(a.k_s, a.S, es) && stride16(a.k_h, a.KV, es) &&
                 stride16(a.ko_b, B, es) && stride16(a.ko_r, rows_to, es);
  if (a.v)
    aligned = aligned && aligned16(a.v) && aligned16(a.v_out) &&
              stride16(a.v_b, B, es) && stride16(a.v_s, a.S, es) &&
              stride16(a.v_h, a.KV, es) && stride16(a.vo_b, B, es) &&
              stride16(a.vo_r, rows_to, es);
  const Geometry g = geometry(B * a.S, a.Hq, a.KV, a.hd, a.v != nullptr, es, aligned);
  if (g.vec > 1)
    rope_kernel<T, 16 / sizeof(T)><<<g.blocks, g.threads, 0, s>>>(a);
  else
    rope_kernel<T, 1><<<g.blocks, g.threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,S,Hq,hd) and k (B,S,KV,hd), any strides with a contiguous last
// dimension; pos int32 by (b, s) strides. q_out is a contiguous
// (B,S,Hq,hd). C == 0 (a prefill): k_out is a contiguous (B,S,KV,hd)
// (ko_b, ko_r its batch and row strides), v and v_out are null. C > 0 (a
// decode step, S == 1): k_out and v_out are (B,C,KV*hd) rings whose slot
// pos % C receives the roped k and v; v is (B,1,KV,hd).
extern "C" int repro_rope(const void* q, const void* k, const void* v,
                          const void* pos, void* q_out, void* k_out, void* v_out,
                          int B, int S, int Hq, int KV, int hd, int C,
                          int64_t q_b, int64_t q_s, int64_t q_h,
                          int64_t k_b, int64_t k_s, int64_t k_h,
                          int64_t v_b, int64_t v_s, int64_t v_h,
                          int64_t p_b, int64_t p_s, int64_t ko_b, int64_t ko_r,
                          int64_t vo_b, int64_t vo_r, float neg_log_theta,
                          int dtype, void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  if (hd < 2 || hd % 2 || hd / 2 > kMaxHalf || Hq < 1 || KV < 1 || C < 0 ||
      (C > 0 && (S != 1 || !v || !v_out)))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, (const int*)pos, q_out, k_out, v_out, S, Hq, KV, hd, C,
         q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, p_b, p_s,
         ko_b, ko_r, vo_b, vo_r, neg_log_theta, 1.0f / (float)(hd / 2)};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == kF32 ? run<float>(a, B, s) : run<__nv_bfloat16>(a, B, s);
}
