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
// Head dims 16, 32 and 64 are built (HD, one template instance each with
// bf16 and fp32 inputs): 64 serves rwkv6-7b at full width, 16 its reduced()
// config (the smoke launcher), 32 the reference's own kernel sweeps.
//
// Design (the chunked-parallel form with tensor cores is later work: it
// reorders the state's sums, so the state would no longer be bit-identical):
// - Columns split across blocks. Column j of the state depends only on
//   v_t[j] and on the shared r_t, k_t and w_t, so each (b, h) takes
//   kColBlocks = HD / 16 blocks of kCols = 16 columns (1, 2 or 4): 256
//   blocks at B = 1, H = 64, HD = 64.
// - Rows split across lanes. kSplit = 4 adjacent lanes share a column; lane
//   q keeps rows kRows q .. kRows q + kRows - 1 of it in registers (kRows =
//   HD / 4: 4, 8 or 16), so the state never leaves the SM between steps.
//   Each lane's partial sum of y_t[j] is a dependent chain of kRows FMAs
//   instead of HD; the partials wait in shared memory and
//   y_t[j] = (p0 + p1) + (p2 + p3) is summed when the chunk is stored, so
//   no step waits on a shuffle. The state update is the only serial chain
//   (y does not feed it); the step loop is unrolled so that successive
//   steps overlap.
// - Staged ahead. The (b, h) rows of r, k and w, and v's 16 columns, for a
//   chunk of kT steps (32 for bf16, 16 for fp32: under 48 KB of static
//   shared memory at HD 64) are copied into shared memory with 16-byte
//   cp.async, double-buffered: while chunk c is computed, chunk c + 1 is in
//   flight, so no step waits on device memory. A tail chunk (S % kT) copies
//   only its steps, and the step loop and the y store stop at S. A lane's
//   kRows values of a row (its quarter) are 64 bytes in fp32 at HD 64 (and
//   w's at HD 64), which would put lanes 0 and 2 in the same banks: those
//   quarters are padded by 16 bytes (quarter()); the narrower quarters of
//   HD 16 and 32 (8 to 32 bytes) already fall in distinct banks.
// - y for a chunk is summed from the partials in shared memory and stored
//   coalesced, 16 bytes a thread.
// - The decode step (S = 1) has nothing to stage ahead, and bytes bound it:
//   a kernel of its own (the same 4 row lanes a column, the same step
//   arithmetic and order of y's sum) gives each warp kStepCols = min(32, HD)
//   columns of one row lane (two row lanes a warp at HD 16), so the state
//   moves in whole rows (128 bytes; 64 at HD 16), and loads r, k, w and u
//   (16-byte loads, 8 bytes a lane for bf16 at HD 16), v[j] and the state
//   straight into registers, all at once. The 4 partials of y meet in
//   shared memory behind its one barrier. HD / kStepCols blocks (1 or 2)
//   per (b, h), registers capped at 128, so all 512 blocks at B = 4, H =
//   64, HD = 64 are resident in one wave.
// The state update and the bonus term use separately rounded products and
// sums (__fmul_rn / __fadd_rn, no FMA contraction) in the same order as the
// plain PyTorch version, so the state matches it bit for bit at every HD;
// only the order of the sum that gives y differs.
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

constexpr int kCols = 16;                   // columns a prefill block owns
constexpr int kSplit = 4;                   // lanes per column
constexpr int kThreads = kCols * kSplit;    // 64, a prefill block
static_assert(kSplit == 4, "sum4 adds the partials of 4 row lanes");

// The partition of a head dim HD's state.
template <int HD>
struct Part {
  static_assert(HD == 16 || HD == 32 || HD == 64, "WKV is built at HD 16, 32, 64");
  static constexpr int kColBlocks = HD / kCols;        // blocks per (b, h) at a prefill
  static constexpr int kRows = HD / kSplit;            // state rows a lane
  static constexpr int kStepCols = HD < 32 ? HD : 32;  // columns a decode warp
  static constexpr int kStepThreads = kStepCols * kSplit;
};

// Slots a lane's quarter of a row (Rows elements of Bytes each) takes in
// shared memory: 16 bytes of padding where the quarter is 64 bytes, which
// would put lanes 0 and 2 in the same banks.
template <int Rows, int Bytes>
constexpr int quarter() { return Rows * Bytes == 64 ? Rows + 16 / Bytes : Rows; }

// One chunk of kT steps in shared memory: 32 for bf16, 16 for fp32, under
// 48 KB of static shared memory double-buffered at HD 64. A row is 4
// quarters of kQ (r, k) or kWQ (w, fp32 in either case) slots.
template <typename T, int HD>
struct Stage {
  static constexpr int kT = sizeof(T) == 2 ? 32 : 16;
  static constexpr int kQ = quarter<Part<HD>::kRows, sizeof(T)>();
  static constexpr int kWQ = quarter<Part<HD>::kRows, 4>();
  T r[kT][kSplit * kQ];
  T k[kT][kSplit * kQ];
  float w[kT][kSplit * kWQ];
  T v[kT][kCols];
};

// element e of a row at its padded slot (Q slots per quarter of R elements)
template <int Q, int R>
__device__ __forceinline__ int slot(int e) { return e + (e / R) * (Q - R); }

// Issue the copies of steps t0 .. t0 + n - 1 into stage st.
template <typename T, int HD>
__device__ __forceinline__ void stage_chunk(
    Stage<T, HD>& st, int t0, int n, int tid, const T* rp, const T* kp,
    const T* vp, const float* wp, int64_t rst, int64_t kst, int64_t vst,
    int64_t wst) {
  using S = Stage<T, HD>;
  constexpr int R = Part<HD>::kRows;
  constexpr int E = 16 / sizeof(T);   // elements per 16 bytes
  constexpr int RC = HD / E;          // chunks per r/k row
  constexpr int WC = HD / 4;          // chunks per w row
  constexpr int VC = kCols / E;       // chunks of v's 16 columns
  // a chunk never straddles a padded quarter: padding is 16 bytes after a
  // quarter of 64, which holds whole chunks
  for (int i = tid; i < n * RC; i += kThreads) {
    const int t = i / RC, e = (i % RC) * E;
    cp_async16(&st.r[t][slot<S::kQ, R>(e)], rp + (t0 + t) * rst + e, true);
    cp_async16(&st.k[t][slot<S::kQ, R>(e)], kp + (t0 + t) * kst + e, true);
  }
  for (int i = tid; i < n * WC; i += kThreads) {
    const int t = i / WC, e = (i % WC) * 4;
    cp_async16(&st.w[t][slot<S::kWQ, R>(e)], wp + (t0 + t) * wst + e, true);
  }
  for (int i = tid; i < n * VC; i += kThreads) {
    const int t = i / VC, e = (i % VC) * E;
    cp_async16(&st.v[t][e], vp + (t0 + t) * vst + e, true);
  }
}

// A lane's N consecutive values of a row (in shared or device memory,
// aligned to their size) as floats: 16-byte loads, or one 8-byte load for
// the 4 bf16 values of a lane at HD 16.
template <int N>
__device__ __forceinline__ void lane_rows(const float* p, float* f) {
  static_assert(N % 4 == 0, "whole 16-byte fp32 loads");
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    unpack16(reinterpret_cast<const uint4*>(p)[i], f + 4 * i, 0.f);
}
template <int N>
__device__ __forceinline__ void lane_rows(const __nv_bfloat16* p, float* f) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      unpack16(reinterpret_cast<const uint4*>(p)[i], f + 8 * i, __nv_bfloat16());
  } else {
    static_assert(N == 4, "4 bf16 values: one 8-byte load");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
}

// y_t[j] from the kSplit = 4 row lanes' partial sums p[q]
__device__ __forceinline__ float sum4(const float* p) {
  return (p[0] + p[1]) + (p[2] + p[3]);
}

// One time step on a row lane's N state rows of column j: returns the
// lane's partial sum of y_t[j] and updates st in place with separately
// rounded products and sums, as wkv_plain does.
template <int N>
__device__ __forceinline__ float step_rows(float* st, const float* rr,
                                           const float* kk, const float* ww,
                                           const float* uu, float vj) {
  float acc = 0.f;
#pragma unroll
  for (int ii = 0; ii < N; ++ii) {
    const float kv = __fmul_rn(kk[ii], vj);
    acc = fmaf(rr[ii], __fadd_rn(st[ii], __fmul_rn(uu[ii], kv)), acc);
    st[ii] = __fadd_rn(__fmul_rn(ww[ii], st[ii]), kv);
  }
  return acc;
}

// A prefill (S > 1): chunks staged ahead, y summed and stored per chunk.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const T* __restrict__ u, const float* s0, T* __restrict__ y,
           float* s_out, int H, int S,
           int64_t rsb, int64_t rst, int64_t rsh,
           int64_t ksb, int64_t kst, int64_t ksh,
           int64_t vsb, int64_t vst, int64_t vsh,
           int64_t wsb, int64_t wst, int64_t wsh) {
  using St = Stage<T, HD>;
  constexpr int kRows = Part<HD>::kRows;
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
  const int64_t state_off = (int64_t)blockIdx.x * HD * HD;

  const T* rp = r + b * rsb + h * rsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh + cb * kCols;
  const float* wp = w + b * wsb + h * wsh;
  T* yp = y + ((int64_t)b * S * H + h) * HD + cb * kCols;

  const int n_chunks = (S + kT - 1) / kT;
  if (n_chunks > 0)
    stage_chunk(stage[0], 0, min(kT, S), tid, rp, kp, vp, wp, rst, kst, vst, wst);
  cp_async_commit();

  float st[kRows], uu[kRows];  // st[ii] = S[kRows * q + ii][j]
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int i = q * kRows + ii;
    st[ii] = s0 ? s0[state_off + i * HD + j] : 0.f;
    uu[ii] = to_f32(u[h * HD + i]);
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
      lane_rows<kRows>(&sc.r[t][q * St::kQ], rr);
      lane_rows<kRows>(&sc.k[t][q * St::kQ], kk);
      lane_rows<kRows>(&sc.w[t][q * St::kWQ], ww);
      sy[t][jl][q] = step_rows<kRows>(st, rr, kk, ww, uu, to_f32(sc.v[t][jl]));
    }
    __syncthreads();
    // y of this chunk: n steps x 16 columns, 16 bytes a thread
    if (tid < n * YC) {
      const int t = tid / YC, e = (tid % YC) * E;
      float f[E];
#pragma unroll
      for (int i = 0; i < E; ++i) f[i] = sum4(sy[t][e + i]);
      *reinterpret_cast<uint4*>(yp + (int64_t)(t0 + t) * H * HD + e) =
          pack16(f, T());
    }
  }

#pragma unroll
  for (int ii = 0; ii < kRows; ++ii)
    s_out[state_off + (q * kRows + ii) * HD + j] = st[ii];
}

// The decode step (S = 1): every load issued at once into registers. Lane
// jl of row lane q holds rows kRows * q .. of column j, so each warp reads
// and writes whole rows of the state; the 4 partials of y meet in shared
// memory, behind the kernel's one barrier.
template <typename T, int HD>
__global__ void __launch_bounds__(Part<HD>::kStepThreads,
                                  512 / Part<HD>::kStepThreads)
wkv_kernel_decode(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const T* __restrict__ u, const float* s0, T* __restrict__ y,
                  float* s_out, int H, int64_t rsb, int64_t rsh, int64_t ksb,
                  int64_t ksh, int64_t vsb, int64_t vsh, int64_t wsb,
                  int64_t wsh) {
  constexpr int kRows = Part<HD>::kRows, kStepCols = Part<HD>::kStepCols;
  __shared__ float part[kStepCols][kSplit];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int jl = threadIdx.x % kStepCols, q = threadIdx.x / kStepCols;
  const int j = blockIdx.y * kStepCols + jl, i0 = q * kRows;
  const int64_t state_off = (int64_t)blockIdx.x * HD * HD;

  float rr[kRows], kk[kRows], ww[kRows], uu[kRows], st[kRows];
  lane_rows<kRows>(r + b * rsb + h * rsh + i0, rr);
  lane_rows<kRows>(k + b * ksb + h * ksh + i0, kk);
  lane_rows<kRows>(w + b * wsb + h * wsh + i0, ww);
  lane_rows<kRows>(u + h * HD + i0, uu);
  const float vj = to_f32(v[b * vsb + h * vsh + j]);
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii)
    st[ii] = s0 ? s0[state_off + (i0 + ii) * HD + j] : 0.f;

  part[jl][q] = step_rows<kRows>(st, rr, kk, ww, uu, vj);
  __syncthreads();
  if (q == 0) y[(int64_t)blockIdx.x * HD + j] = from_f32<T>(sum4(part[jl]));
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii)
    s_out[state_off + (i0 + ii) * HD + j] = st[ii];
}

template <typename T, int HD>
void launch(const void* r, const void* k, const void* v, const float* w,
            const void* u, const float* s0, void* y, float* s_out, int B,
            int H, int S, const int64_t* st, cudaStream_t s) {
  using P = Part<HD>;
  if (S == 1) {
    wkv_kernel_decode<T, HD><<<dim3(B * H, HD / P::kStepCols),
                               P::kStepThreads, 0, s>>>(
        (const T*)r, (const T*)k, (const T*)v, w, (const T*)u, s0, (T*)y,
        s_out, H, st[0], st[2], st[3], st[5], st[6], st[8], st[9], st[11]);
  } else {
    wkv_kernel<T, HD><<<dim3(B * H, P::kColBlocks), kThreads, 0, s>>>(
        (const T*)r, (const T*)k, (const T*)v, w, (const T*)u, s0, (T*)y,
        s_out, H, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
        st[8], st[9], st[10], st[11]);
  }
}

}  // namespace

// strides: (b, t, h) in elements for r, k, v and w, in that order (12 values).
// hd: 16, 32 or 64 (kernels/rwkv_wkv.py: HEAD_DIMS); any other is refused.
extern "C" int repro_wkv(const void* r, const void* k, const void* v,
                         const float* w, const void* u, const float* s0,
                         void* y, float* s_out, int B, int H, int S, int hd,
                         int64_t rsb, int64_t rst, int64_t rsh,
                         int64_t ksb, int64_t kst, int64_t ksh,
                         int64_t vsb, int64_t vst, int64_t vsh,
                         int64_t wsb, int64_t wst, int64_t wsh,
                         int dtype, void* stream) {
  if (hd != 16 && hd != 32 && hd != 64) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  const int64_t st[12] = {rsb, rst, rsh, ksb, kst, ksh,
                          vsb, vst, vsh, wsb, wst, wsh};
  cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto HD) {
    constexpr int kHD = decltype(HD)::value;
    if (dtype == kF32)
      launch<float, kHD>(r, k, v, w, u, s0, y, s_out, B, H, S, st, s);
    else
      launch<__nv_bfloat16, kHD>(r, k, v, w, u, s0, y, s_out, B, H, S, st, s);
  };
  if (hd == 16) go(std::integral_constant<int, 16>{});
  else if (hd == 32) go(std::integral_constant<int, 32>{});
  else go(std::integral_constant<int, 64>{});
  return (int)cudaGetLastError();
}
