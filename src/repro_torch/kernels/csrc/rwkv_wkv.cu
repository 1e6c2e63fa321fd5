// RWKV6 WKV recurrence for Hopper. Replaces the TPU kernel
// src/repro/kernels/rwkv_wkv.py: wkv / _wkv_kernel.
//
// For each (b, h), with an fp32 hd x hd state S carried over time:
//   y_t = r_t (S + u * k_t^T v_t);   S <- diag(w_t) S + k_t^T v_t
// and the final S is returned.
//
// Bound on the H100: at a decode step (S = 1) bytes: the fp32 state is read
// and written once (16 KB per head each way), against 7 flops per state
// element. At prefill the time loop is sequential inside each (b, h), so
// latency bounds it: the chain of a step, and the memory round trip of each
// step's inputs unless they are fetched ahead.
//
// Design (the chunked-parallel form with tensor cores is later work: it
// reorders the state's sums, so the state would no longer be bit-identical):
// - Columns split across blocks. Column j of the state depends only on
//   v_t[j] and on the shared r_t, k_t and w_t, so each (b, h) takes
//   kColBlocks = 4 blocks of 16 columns: 256 blocks at B = 1, H = 64.
// - Rows split across lanes. kSplit = 4 adjacent lanes share a column; lane
//   q keeps rows 16q..16q+15 of it in registers, so the state never leaves
//   the SM between steps. Each lane's partial sum of y_t[j] is a dependent
//   chain of 16 FMAs instead of 64; the partials wait in shared memory and
//   y_t[j] = (p0 + p1) + (p2 + p3) is summed when the chunk is stored, so
//   no step waits on a shuffle. The state update is the only serial chain
//   (y does not feed it); the step loop is unrolled so that successive
//   steps overlap.
// - Staged ahead. The (b, h) rows of r, k and w, and v's 16 columns, for a
//   chunk of kT steps (32 for bf16, 16 for fp32: under 48 KB of static
//   shared memory) are copied into shared memory with 16-byte cp.async,
//   double-buffered: while chunk c is computed, chunk c + 1 is in flight,
//   so no step waits on device memory. A tail chunk (S % kT) copies only its
//   steps, and the step loop and the y store stop at S. fp32 rows are padded
//   by 16 bytes per row quarter, so the 4 lanes of a column read 4 banks.
// - y for a chunk is summed from the partials in shared memory and stored
//   coalesced, 16 bytes a thread.
// - The decode step (S = 1) has nothing to stage ahead, and bytes bound it:
//   a kernel of its own (the same 4 row lanes a column, the same step
//   arithmetic and order of y's sum) gives each warp 32 columns of one row
//   lane, so the state moves in whole 128-byte rows, and loads r, k, w and
//   u (16-byte loads), v[j] and the state straight into registers, all at
//   once. The 4 partials of y meet in shared memory behind its one barrier.
//   Two blocks of 128 threads per (b, h), registers capped at 128, so all
//   512 blocks at B = 4 are resident in one wave.
// The state update and the bonus term use separately rounded products and
// sums (__fmul_rn / __fadd_rn, no FMA contraction) in the same order as the
// plain PyTorch version, so the state matches it bit for bit; only the order
// of the sum that gives y differs.
//
// r, k, v (model dtype) and w (fp32) are read through (b, t, h) strides with
// a contiguous last dimension and 16-byte aligned rows (the wrapper checks
// these and u's alignment), so the model's (B,S,H,hd) projections go in
// without a transpose; y is written contiguous (B,S,H,hd) in r's type.
//
// In place: s_out may be the same buffer as s0 (the decode step updates the
// cache's state this way). Each block reads its own columns of the (b, h)
// state once, before the loop, and writes them once, after; no block
// touches another's columns and each thread reads and writes only its own
// elements. So s0 and s_out are deliberately not __restrict__.
#include "common.cuh"

namespace {

constexpr int kHd = 64;
constexpr int kColBlocks = 4;               // blocks per (b, h) at a prefill
constexpr int kCols = kHd / kColBlocks;     // 16 columns a block
constexpr int kSplit = 4;                   // lanes per column
constexpr int kRows = kHd / kSplit;         // 16 state rows a lane
constexpr int kThreads = kCols * kSplit;    // 64
constexpr int kStepCols = 32;               // columns a decode block
static_assert(kSplit == 4, "sum4 adds the partials of 4 row lanes");

// One chunk of kT steps in shared memory: 32 for bf16, 16 for fp32, under
// 48 KB of static shared memory double-buffered. 16 elements of a row take
// kQ slots: 16 for bf16 (32 bytes: the lanes' rows already fall in distinct
// banks), 20 for fp32 (16 bytes of padding).
template <typename T>
struct Stage {
  static constexpr int kT = sizeof(T) == 2 ? 32 : 16;
  static constexpr int kQ = sizeof(T) == 2 ? 16 : 20;
  static constexpr int kWQ = 20;            // w is fp32 in either case
  T r[kT][4 * kQ];
  T k[kT][4 * kQ];
  float w[kT][4 * kWQ];
  T v[kT][kCols];
};

// element e of a 64-wide row at its padded slot (Q slots per 16 elements)
template <int Q>
__device__ __forceinline__ int slot(int e) { return e + (e / 16) * (Q - 16); }

// Issue the copies of steps t0 .. t0 + n - 1 into stage st.
template <typename T>
__device__ __forceinline__ void stage_chunk(
    Stage<T>& st, int t0, int n, int tid, const T* rp, const T* kp,
    const T* vp, const float* wp, int64_t rst, int64_t kst, int64_t vst,
    int64_t wst) {
  using S = Stage<T>;
  constexpr int E = 16 / sizeof(T);   // elements per 16 bytes
  constexpr int RC = kHd / E;         // chunks per r/k row
  constexpr int WC = kHd / 4;         // chunks per w row
  constexpr int VC = kCols / E;       // chunks of v's 16 columns
  for (int i = tid; i < n * RC; i += kThreads) {
    const int t = i / RC, e = (i % RC) * E;
    cp_async16(&st.r[t][slot<S::kQ>(e)], rp + (t0 + t) * rst + e, true);
    cp_async16(&st.k[t][slot<S::kQ>(e)], kp + (t0 + t) * kst + e, true);
  }
  for (int i = tid; i < n * WC; i += kThreads) {
    const int t = i / WC, e = (i % WC) * 4;
    cp_async16(&st.w[t][slot<S::kWQ>(e)], wp + (t0 + t) * wst + e, true);
  }
  for (int i = tid; i < n * VC; i += kThreads) {
    const int t = i / VC, e = (i % VC) * E;
    cp_async16(&st.v[t][e], vp + (t0 + t) * vst + e, true);
  }
}

// A lane's kRows consecutive values of a row (16-byte aligned, in shared or
// device memory) as floats, with 16-byte loads.
__device__ __forceinline__ void lane_rows(const float* p, float* f) {
#pragma unroll
  for (int i = 0; i < kRows / 4; ++i)
    unpack16(reinterpret_cast<const uint4*>(p)[i], f + 4 * i, 0.f);
}
__device__ __forceinline__ void lane_rows(const __nv_bfloat16* p, float* f) {
#pragma unroll
  for (int i = 0; i < kRows / 8; ++i)
    unpack16(reinterpret_cast<const uint4*>(p)[i], f + 8 * i, __nv_bfloat16());
}

// y_t[j] from the kSplit = 4 row lanes' partial sums p[q]
__device__ __forceinline__ float sum4(const float* p) {
  return (p[0] + p[1]) + (p[2] + p[3]);
}

// One time step on a row lane's kRows state rows of column j: returns the
// lane's partial sum of y_t[j] and updates st in place with separately
// rounded products and sums, as wkv_plain does.
__device__ __forceinline__ float step_rows(float* st, const float* rr,
                                           const float* kk, const float* ww,
                                           const float* uu, float vj) {
  float acc = 0.f;
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const float kv = __fmul_rn(kk[ii], vj);
    acc = fmaf(rr[ii], __fadd_rn(st[ii], __fmul_rn(uu[ii], kv)), acc);
    st[ii] = __fadd_rn(__fmul_rn(ww[ii], st[ii]), kv);
  }
  return acc;
}

// A prefill (S > 1): chunks staged ahead, y summed and stored per chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const T* __restrict__ u, const float* s0, T* __restrict__ y,
           float* s_out, int H, int S,
           int64_t rsb, int64_t rst, int64_t rsh,
           int64_t ksb, int64_t kst, int64_t ksh,
           int64_t vsb, int64_t vst, int64_t vsh,
           int64_t wsb, int64_t wst, int64_t wsh) {
  using St = Stage<T>;
  constexpr int kT = St::kT;
  constexpr int E = 16 / sizeof(T);
  constexpr int YC = kCols / E;       // 16-byte chunks of a step's y slice
  // raw bytes: __nv_bfloat16 members would make a __shared__ St need a constructor
  __shared__ __align__(16) unsigned char stage_raw[2 * sizeof(St)];
  __shared__ float sy[kT][kCols][kSplit];   // the lanes' partials of y
  St* stage = reinterpret_cast<St*>(stage_raw);

  const int b = blockIdx.x / H, h = blockIdx.x % H, cb = blockIdx.y;
  const int tid = threadIdx.x;
  const int jl = tid / kSplit, q = tid % kSplit;   // column in block, row lane
  const int j = cb * kCols + jl;
  const int64_t state_off = (int64_t)blockIdx.x * kHd * kHd;

  const T* rp = r + b * rsb + h * rsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh + cb * kCols;
  const float* wp = w + b * wsb + h * wsh;
  T* yp = y + ((int64_t)b * S * H + h) * kHd + cb * kCols;

  const int n_chunks = (S + kT - 1) / kT;
  if (n_chunks > 0)
    stage_chunk(stage[0], 0, min(kT, S), tid, rp, kp, vp, wp, rst, kst, vst, wst);
  cp_async_commit();

  float st[kRows], uu[kRows];  // st[ii] = S[kRows * q + ii][j]
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int i = q * kRows + ii;
    st[ii] = s0 ? s0[state_off + i * kHd + j] : 0.f;
    uu[ii] = to_f32(u[h * kHd + i]);
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kT;
    if (c + 1 < n_chunks)  // its buffer was last read in chunk c - 1
      stage_chunk(stage[(c + 1) & 1], t0 + kT, min(kT, S - t0 - kT), tid, rp,
                  kp, vp, wp, rst, kst, vst, wst);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const St& sc = stage[c & 1];
    const int n = min(kT, S - t0);
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      float rr[kRows], kk[kRows], ww[kRows];
      lane_rows(&sc.r[t][slot<St::kQ>(q * kRows)], rr);
      lane_rows(&sc.k[t][slot<St::kQ>(q * kRows)], kk);
      lane_rows(&sc.w[t][slot<St::kWQ>(q * kRows)], ww);
      sy[t][jl][q] = step_rows(st, rr, kk, ww, uu, to_f32(sc.v[t][jl]));
    }
    __syncthreads();
    // y of this chunk: n steps x 16 columns, 16 bytes a thread
    if (tid < n * YC) {
      const int t = tid / YC, e = (tid % YC) * E;
      float f[E];
#pragma unroll
      for (int i = 0; i < E; ++i) f[i] = sum4(sy[t][e + i]);
      *reinterpret_cast<uint4*>(yp + (int64_t)(t0 + t) * H * kHd + e) =
          pack16(f, T());
    }
  }

#pragma unroll
  for (int ii = 0; ii < kRows; ++ii)
    s_out[state_off + (q * kRows + ii) * kHd + j] = st[ii];
}

// The decode step (S = 1): every load issued at once into registers. Lane
// jl of warp q holds rows kRows * q .. of column j, so each warp reads and
// writes whole 128-byte rows of the state; the 4 partials of y meet in
// shared memory, behind the kernel's one barrier.
template <typename T>
__global__ void __launch_bounds__(kStepCols * kSplit, 4)
wkv_kernel_decode(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const T* __restrict__ u, const float* s0, T* __restrict__ y,
                  float* s_out, int H, int64_t rsb, int64_t rsh, int64_t ksb,
                  int64_t ksh, int64_t vsb, int64_t vsh, int64_t wsb,
                  int64_t wsh) {
  __shared__ float part[kStepCols][kSplit];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int jl = threadIdx.x % kStepCols, q = threadIdx.x / kStepCols;
  const int j = blockIdx.y * kStepCols + jl, i0 = q * kRows;
  const int64_t state_off = (int64_t)blockIdx.x * kHd * kHd;

  float rr[kRows], kk[kRows], ww[kRows], uu[kRows], st[kRows];
  lane_rows(r + b * rsb + h * rsh + i0, rr);
  lane_rows(k + b * ksb + h * ksh + i0, kk);
  lane_rows(w + b * wsb + h * wsh + i0, ww);
  lane_rows(u + h * kHd + i0, uu);
  const float vj = to_f32(v[b * vsb + h * vsh + j]);
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii)
    st[ii] = s0 ? s0[state_off + (i0 + ii) * kHd + j] : 0.f;

  part[jl][q] = step_rows(st, rr, kk, ww, uu, vj);
  __syncthreads();
  if (q == 0) y[(int64_t)blockIdx.x * kHd + j] = from_f32<T>(sum4(part[jl]));
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii)
    s_out[state_off + (i0 + ii) * kHd + j] = st[ii];
}

template <typename T>
void launch(const void* r, const void* k, const void* v, const float* w,
            const void* u, const float* s0, void* y, float* s_out, int B,
            int H, int S, const int64_t* st, cudaStream_t s) {
  if (S == 1) {
    wkv_kernel_decode<T><<<dim3(B * H, kHd / kStepCols), kStepCols * kSplit,
                           0, s>>>(
        (const T*)r, (const T*)k, (const T*)v, w, (const T*)u, s0, (T*)y,
        s_out, H, st[0], st[2], st[3], st[5], st[6], st[8], st[9], st[11]);
  } else {
    wkv_kernel<T><<<dim3(B * H, kColBlocks), kThreads, 0, s>>>(
        (const T*)r, (const T*)k, (const T*)v, w, (const T*)u, s0, (T*)y,
        s_out, H, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
        st[8], st[9], st[10], st[11]);
  }
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
  const int64_t st[12] = {rsb, rst, rsh, ksb, kst, ksh,
                          vsb, vst, vsh, wsb, wst, wsh};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    launch<float>(r, k, v, w, u, s0, y, s_out, B, H, S, st, s);
  else
    launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, H, S, st, s);
  return (int)cudaGetLastError();
}
