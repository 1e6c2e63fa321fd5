// Forward prefill attention for Hopper. Replaces the TPU kernel
// src/repro/kernels/flash_attention.py: flash_attention / _flash_kernel.
//
// Head dims 16, 32, 64, 96 and 128 are built (one template instance each):
// 64, 96 and 128 serve the registry's configs at full width, 16 every
// config's reduced() (the smoke launchers and the serving bench), 32 the
// reference's own kernel sweeps. One more bf16 instance takes keys of 192
// and values of 128 (flash_kernel_mma<192, 128>): DeepSeek-V2's latent
// attention at prefill, whose decompressed heads are 128 dims of their own
// and 64 of the one shared rope key, with values of 128. It has no fp32
// instance.
//
// Bound on the H100: at the serving shapes (B=1, Hq=12, Hkv=4, d=64,
// S = 8..512; qwen3-4b Hq=32, Hkv=8, d=128; phi3 Hq=Hkv=32, d=96) the
// call moves at most 12.6 MB (3.8 us at 3.35 TB/s; at S = 64 under a
// microsecond) and does at most 2.2 GFLOP (2.2 us at 989 TFLOP/s), so the
// bounds are a few microseconds at most: the latency of each block's tile
// loop is what sets the time.
// The first version did fp32 FMA from shared memory with element-wise
// loads, and loaded each K/V tile once for every query head of a group.
//
// Design of the bf16 kernel (flash_kernel_mma):
// - Rows packed by kv head: a block owns 64 packed rows of one (b, kv
//   head); packed row r = s*G + g is position s of q head kv*G + g. A
//   64-row tile spans about 64/G positions, so causal tile skipping stays
//   tight, and each K/V tile is loaded once for all G heads of the group.
//   Grid (ceil(S*G/64), Hkv, B), 4 warps of 16 packed rows each. q, k, v
//   and the output are addressed through their (b, h, s) strides, so the
//   model's (B,S,H,d) projections are read as they are.
// - Products on the tensor cores: mma.sync m16n8k16 bf16 with fp32
//   accumulators, fed by ldmatrix (Q.K^T reads K row-major as the "col" B
//   operand; P.V reads V with ldmatrix.trans). The online softmax rescales
//   the S accumulators in fp32, then rounds them to bf16 and uses them in
//   registers as the A operand of P.V (the m16n8 C layout is the m16n8k16
//   A layout), with no trip through shared memory. P is therefore rounded
//   to bf16 before P.V, as the JAX XLA path does; l sums the fp32 P.
// - Tile loads: Q once, then 64-row K and V tiles with 16-byte cp.async,
//   double-buffered so tile t+1 is in flight while tile t is in the tensor
//   cores. Rows past S are zero-filled (src-size 0), so a ragged S needs no
//   padding. Shared-memory rows are padded by 16 bytes, which keeps every
//   ldmatrix free of bank conflicts.
// - Masks: tiles that the causal, window or chunk mask hides from the whole
//   packed row range are skipped (block-uniform); inside a tile each score
//   is masked on its packed row's position with the -1e30 sentinel,
//   columns past S are excluded, and the l == 0 guard holds at the end.
//
// fp32 inputs keep a full-fp32 path with no TF32: flash_kernel_fma, the
// first version's kernel (one block of 128 threads per (b, q head, 64-row
// q tile), two threads per query row owning D / 2 output columns each,
// fp32 FMA from shared memory: 115 KB of it at D = 128, under the 227 KB
// opt-in). The bf16 kernel takes (64 + 4 * 64) padded rows of D + 8, 87 KB
// at D = 128.
#include "common.cuh"

namespace {

struct Strides {
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ bool pair_visible(int qpos, int kpos, int causal,
                                             int window, int chunk) {
  bool ok = true;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && (qpos - kpos) < window;
  if (chunk > 0) ok = ok && (qpos / chunk) == (kpos / chunk);
  return ok;
}

// block-uniform visibility of a key tile [k0, k_hi] from query positions
// [q_lo, q_hi], as flash_attention.py:48-59
__device__ __forceinline__ bool tile_visible(int q_lo, int q_hi, int k0, int k_hi,
                                             int causal, int window, int chunk) {
  bool visible = true;
  if (causal) visible = visible && (k0 <= q_hi);
  if (window > 0) visible = visible && (q_lo - k_hi) < window;
  if (chunk > 0)
    visible = visible && (q_hi / chunk >= k0 / chunk) && (q_lo / chunk <= k_hi / chunk);
  return visible;
}

// ---- bf16: tensor cores, rows packed by kv head --------------------------

constexpr int kBM = 64;        // packed rows per block
constexpr int kBN = 64;        // keys per tile
constexpr int kWarps = kBM / 16;
constexpr int kPad = 8;        // bf16 elements (16 bytes) of row padding

template <int D, int DV>
__global__ void __launch_bounds__(32 * kWarps)
flash_kernel_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int S, int G, Strides st,
                 int causal, int window, int chunk, float scale) {
  // D / 16 k-steps of Q.K^T taken two at a time (one ldmatrix.x4 of K for
  // both; an odd last k-step, d 16's only one, takes an ldmatrix.x2), D / 8
  // n8-tiles of P.V taken two at a time: 1 and 2 at d 16, 2 and 4 at d 32,
  // 4 and 8 at d 64, 6 and 12 at d 96, 8 and 16 at d 128. Rows of D + 8
  // elements are 48, 80, 144, 208 and 272 bytes, an odd number of 16-byte
  // chunks each, so the 8 row addresses of every ldmatrix fall in 8
  // different bank quads. Q's fragments (D / 4 registers, loaded once a
  // tile) and the O accumulators (D / 2 fp32 a lane) stay in registers:
  // 84, 105, 136, 164 and 194 registers with 0 spills at d 16, 32, 64, 96
  // and 128 (ptxas, chip_smoke.py phase 1). Re-reading Q's fragments per k-step pair instead (8 of them
  // live) cut d 128 to 187 registers but made d 64 at S 512 7-10% slower
  // (kernel_ab.py against the held fragments; PERF.md, section 6).
  // Values of DV columns (DV = D but for the 192/128 instance) take DV / 8
  // n8-tiles of P.V and V rows of DV + 8 elements (272 bytes at 128).
  static_assert(D % 16 == 0 && DV % 16 == 0, "n8-tiles of P.V are taken in pairs");
  static_assert(DV <= D, "a V row's copies ride on its K row's");
  using bf16 = __nv_bfloat16;
  constexpr int kRow = D + kPad;
  constexpr int kRowV = DV + kPad;
  constexpr int kChunks = D / 8;          // 16-byte copies per row
  constexpr int kChunksV = DV / 8;
  constexpr int kStage = kBN * (kRow + kRowV);
  constexpr int kThreads = 32 * kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [kBM][kRow]
  bf16* KVs = Qs + kBM * kRow;     // [2 stages][K [kBN][kRow], V [kBN][kRowV]]

  const int R0 = blockIdx.x * kBM;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = S * G;

  const bf16* kbase = k + b * st.kb + kvh * st.kh;
  const bf16* vbase = v + b * st.vb + kvh * st.vh;
  for (int i = tid; i < kBM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks, R = R0 + r;
    const bool ok = R < rows;
    const int s = ok ? R / G : 0, g = ok ? R % G : 0;
    cp_async16(Qs + r * kRow + c * 8,
               q + b * st.qb + (kvh * G + g) * st.qh + s * st.qs + c * 8, ok);
  }
  cp_async_commit();

  const int q_lo = R0 / G, q_hi = (min(R0 + kBM, rows) - 1) / G;
  const int n_kt = (S + kBN - 1) / kBN;
  auto next_tile = [&](int kt) -> int {
    for (; kt < n_kt; ++kt)
      if (tile_visible(q_lo, q_hi, kt * kBN, min(kt * kBN + kBN, S) - 1, causal,
                       window, chunk))
        break;
    return kt;
  };
  auto issue = [&](int kt, int stage) {
    bf16* ks = KVs + stage * kStage;
    bf16* vs = ks + kBN * kRow;
    for (int i = tid; i < kBN * kChunks; i += kThreads) {
      const int j = i / kChunks, c = i % kChunks, p = kt * kBN + j;
      const bool ok = p < S;
      const int ps = ok ? p : 0;
      cp_async16(ks + j * kRow + c * 8, kbase + ps * st.ks + c * 8, ok);
      if (kChunksV == kChunks || c < kChunksV)
        cp_async16(vs + j * kRowV + c * 8, vbase + ps * st.vs + c * 8, ok);
    }
  };

  // this lane's two rows of the warp's 16: r and r + 8, at positions qpos[]
  const int r_lane = warp * 16 + lane / 4;
  const int qpos[2] = {(R0 + r_lane) / G, (R0 + r_lane + 8) / G};
  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
  float l[2] = {0.f, 0.f};   // this lane's share of the row sums

  int kt = next_tile(0);
  if (kt < n_kt) issue(kt, 0);
  cp_async_commit();
  int stage = 0;
  while (kt < n_kt) {
    const int nk = next_tile(kt + 1);
    if (nk < n_kt) issue(nk, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // Q and tile kt have landed
    __syncthreads();
    const bf16* ks = KVs + stage * kStage;
    const bf16* vs = ks + kBN * kRow;

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qa[kk], Qs + (warp * 16 + (lane & 15)) * kRow + kk * 16 + (lane >> 4) * 8);
    float sc[kBN / 8][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        if (kk + 1 < D / 16) {
          uint32_t kb4[4];
          ldmatrix_x4(kb4, ks + (n * 8 + (lane & 7)) * kRow + kk * 16 + (lane >> 3) * 8);
          mma_bf16_16816(sc[n], qa[kk], kb4[0], kb4[1]);
          mma_bf16_16816(sc[n], qa[kk + 1], kb4[2], kb4[3]);
        } else {   // one k-step left: columns kk*16 .. kk*16 + 15
          uint32_t kb2[2];
          ldmatrix_x2(kb2, ks + (n * 8 + (lane & 7)) * kRow + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16_16816(sc[n], qa[kk], kb2[0], kb2[1]);
        }
      }
    }

    // masks and the online softmax, in fp32; element e of sc[n] is row
    // e / 2 (r or r + 8) and key kt*64 + 8n + 2(lane % 4) + e % 2
    const int k0 = kt * kBN;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
        float x = -INFINITY;   // key past S: excluded entirely
        if (kpos < S)
          x = pair_visible(qpos[e >> 1], kpos, causal, window, chunk)
                  ? sc[n][e] * scale : REPRO_NEG_INF;
        sc[n][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 1));
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 2));
      const float m_new = fmaxf(m[rr], mt[rr]);
      alpha[rr] = expf(m[rr] - m_new);
      m[rr] = m_new;
      l[rr] *= alpha[rr];
    }
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[n][e] - m[e >> 1]);
        sc[n][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P from the S accumulators, rounded to bf16, in registers
#pragma unroll
    for (int kj = 0; kj < kBN / 16; ++kj) {
      const uint32_t pa[4] = {pack_bf16x2(sc[2 * kj][0], sc[2 * kj][1]),
                              pack_bf16x2(sc[2 * kj][2], sc[2 * kj][3]),
                              pack_bf16x2(sc[2 * kj + 1][0], sc[2 * kj + 1][1]),
                              pack_bf16x2(sc[2 * kj + 1][2], sc[2 * kj + 1][3])};
#pragma unroll
      for (int n = 0; n < DV / 8; n += 2) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, vs + (kj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRowV
                                   + n * 8 + (lane >> 4) * 8);
        mma_bf16_16816(o[n], pa, vb4[0], vb4[1]);
        mma_bf16_16816(o[n + 1], pa, vb4[2], vb4[3]);
      }
    }
    __syncthreads();   // the stage is consumed before it is refilled
    kt = nk;
    stage ^= 1;
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    const int R = R0 + r_lane + 8 * rr;
    if (R >= rows) continue;
    const float inv = 1.f / ((l[rr] == 0.f) ? 1.f : l[rr]);
    bf16* orow = out + b * st.ob + (kvh * G + R % G) * st.oh + (R / G) * st.os;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      store2(orow + n * 8 + 2 * (lane & 3), o[n][2 * rr] * inv, o[n][2 * rr + 1] * inv);
  }
}

// ---- fp32: FMA, one block per (b, q head, 64-row q tile) -----------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kFmaThreads = 2 * kBQ;
constexpr int kHalfK = kBK / 2;

template <int D>
__global__ void __launch_bounds__(kFmaThreads)
flash_kernel_fma(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S,
                 int G, Strides st, int causal, int window, int chunk, float scale) {
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

  const float* qbase = q + b * st.qb + h * st.qh;
  const float* kbase = k + b * st.kb + kvh * st.kh;
  const float* vbase = v + b * st.vb + kvh * st.vh;

  for (int i = tid; i < kBQ * D; i += kFmaThreads) {
    int rr = i / D, dd = i % D;
    int p = q0 + rr;
    Qs[rr * (D + 1) + dd] = p < S ? qbase[p * st.qs + dd] : 0.f;
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
    if (!tile_visible(q0, q_hi, k0, k_hi, causal, window, chunk)) continue;

    __syncthreads();  // previous tile consumed (and Qs written)
    for (int i = tid; i < kBK * D; i += kFmaThreads) {
      int j = i / D, dd = i % D;
      int p = k0 + j;
      float kk = 0.f, vv = 0.f;
      if (p < S) {
        kk = kbase[p * st.ks + dd];
        vv = vbase[p * st.vs + dd];
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
        val = pair_visible(qpos, kpos, causal, window, chunk) ? dot * scale
                                                               : REPRO_NEG_INF;
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
    float* orow = out + b * st.ob + h * st.oh + qpos * st.os + half * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[c] = acc[c] / denom;
  }
}

template <int D, int DV = D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int Hkv, int S, int G, const Strides& st, int causal, int window,
               int chunk, float scale, cudaStream_t s) {
  constexpr int kRow = D + kPad, kRowV = DV + kPad;
  const size_t smem = sizeof(__nv_bfloat16) * (kBM * kRow + 2 * kBN * (kRow + kRowV));
  auto kern = flash_kernel_mma<D, DV>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S * G + kBM - 1) / kBM, Hkv, B);
  kern<<<grid, 32 * kWarps, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, S, G, st, causal, window, chunk, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, void* out, int B,
               int Hq, int S, int G, const Strides& st, int causal, int window,
               int chunk, float scale, cudaStream_t s) {
  size_t smem = sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                                 kBQ * (kBK + 1));
  auto kern = flash_kernel_fma<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kFmaThreads, smem, s>>>((const float*)q, (const float*)k,
                                       (const float*)v, (float*)out, S, G, st,
                                       causal, window, chunk, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           int B, int Hq, int Hkv, int S, int G, const Strides& st, int causal,
           int window, int chunk, float scale, cudaStream_t s) {
  if (dtype == kF32)
    return launch_fma<D>(q, k, v, out, B, Hq, S, G, st, causal, window, chunk,
                         scale, s);
  return launch_mma<D>(q, k, v, out, B, Hkv, S, G, st, causal, window, chunk,
                       scale, s);
}

}  // namespace

// q: (B, Hq, S, d), k/v: (B, Hkv, S, d), out: (B, Hq, S, d), each given by
// its (b, h, s) strides in elements with a contiguous last dimension; every
// base pointer and stride a multiple of 16 bytes (the wrapper checks).
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
  return with_head_dim(d, [&](auto D) {
    return launch<decltype(D)::value>(dtype, q, k, v, out, B, Hq, Hkv, S, G, st,
                                      causal, window, chunk, scale, s);
  });
}

// The same with values of their own width: v (B, Hkv, S, dv) and out (B, Hq,
// S, dv). Built for d 192 with dv 128 in bf16 only (DeepSeek-V2's latent
// attention at prefill); an entry point of its own, so that
// repro_flash_attention keeps its signature.
extern "C" int repro_flash_attention_split(
    const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
    int S, int d, int dv, int64_t q_b, int64_t q_h, int64_t q_s, int64_t k_b,
    int64_t k_h, int64_t k_s, int64_t v_b, int64_t v_h, int64_t v_s, int64_t o_b,
    int64_t o_h, int64_t o_s, int causal, int window, int chunk, float scale,
    int dtype, void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  if (Hkv < 1 || Hq % Hkv != 0 || d != 192 || dv != 128 || dtype != kBF16)
    return (int)cudaErrorInvalidValue;
  const Strides st{q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s};
  return launch_mma<192, 128>(q, k, v, out, B, Hkv, S, Hq / Hkv, st, causal, window,
                              chunk, scale, (cudaStream_t)stream);
}
