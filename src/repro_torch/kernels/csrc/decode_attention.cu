// Single-token decode attention against a ring-buffer KV cache, for Hopper.
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention / _decode_kernel.
//
// Bound on the H100: bytes. Every K/V slot of the (b, kv head) is read once
// and used for G query heads, about 4*G flops per element, far below the
// ridge. At the serving shape (B=4, Hkv=4, C=512, d=64, bf16) the whole call
// reads 2.1 MB, under a microsecond at 3.35 TB/s, so what bounds it in
// practice is latency: how many loads are in flight at once, and how many of
// the 132 SMs hold them. One block per (b, kv head) walking the ring in
// serial tiles (the first version) kept 16 SMs busy, one tile in flight each.
//
// Design: split the ring across a thread-block cluster and merge in
// distributed shared memory, in one launch.
// - Grid (n_split, Hkv, B), with a cluster of the n_split blocks of one
//   (b, kv head); n_split = min(8, C), 8 being the largest portable cluster.
//   Block `split` owns the contiguous slots [split*per, min(C, split*per +
//   per)), per = ceil(C / n_split): 64 slots (16 KB of bf16 K and V) at
//   C = 512, so 128 blocks instead of 16. The grid depends on C only; pos
//   stays on the device.
// - Each block brings its range in with 16-byte cp.async copies into
//   padded shared-memory rows (a 64-slot tile in one round trip, tiles
//   double-buffered when the range is longer). Slots past the range are
//   zero-filled, so no stale bits reach the P.V sums.
// - Before a tile's loads the block evaluates the ring/window/chunk mask of
//   its slots (__syncthreads_or): a tile with no visible slot is neither
//   loaded nor computed. A block with none writes the neutral partial
//   m = -1e30, l = 0, acc = 0. At the start of a request most blocks skip.
// - One warp per query head of the GQA group (G <= 32): lane j scores
//   slots j and j + 32 of the tile (q, which travels with the first tile's
//   copies, and K as 16-byte vectors from shared memory, q by broadcast;
//   the 16-byte row padding keeps the K reads free of bank conflicts); the
//   tile's max and sum are warp shuffles; lane j owns output columns 2j and
//   2j+1 and takes each slot's weight by shuffle. Loops stop at the range's
//   last slot. m, l and acc stay fp32, with the masks of the TPU kernel bit
//   for bit (non-negative ring modulo, floor division for chunks).
// - Merge: each warp writes its (m, l, acc) straight into the shared memory
//   of the cluster's first block (distributed shared memory). Every thread
//   arrives on the cluster barrier at entry (relaxed, so the loads are not
//   held up) and waits on it just before that write: no block touches
//   another's shared memory before the whole cluster has started. One
//   cluster.sync() then publishes the partials, the other blocks exit, and
//   the first block forms sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i
//   with M = max_i m_i and the l == 0 guard of the TPU kernel's finalize,
//   from its own shared memory. No second (combine) launch.
// fp32 inputs take the same design with 4-byte elements; the tensor cores
// play no part (G = 3 query rows are too few for an mma tile).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSplit = 8;   // cluster size: the largest portable one
constexpr int kTile = 64;      // slots per shared-memory tile

// the cluster barrier in two halves: a relaxed arrive (no ordering of
// earlier writes) and the wait that completes it; every thread of every
// block of the cluster executes both
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// slot j of a ring of C holds position pos - ((pos - j) mod C); it is visible
// if that position exists and lies in the window and the current chunk
__device__ __forceinline__ bool slot_visible(int j, int p_now, int C, int window,
                                             int chunk) {
  const int pslot = p_now - mod_nonneg(p_now - j, C);
  bool ok = pslot >= 0;
  if (window > 0) ok = ok && (p_now - pslot) < window;
  if (chunk > 0) ok = ok && floor_div(pslot, chunk) == floor_div(p_now, chunk);
  return ok;
}

// one warp per query head: up to 1024 threads (G = 32)
template <typename T, int D>
__global__ void __launch_bounds__(1024)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ pos,
              T* __restrict__ out, int Hkv, int C, int G, int per,
              int64_t qb, int64_t qh, int64_t kb, int64_t kh, int64_t kc,
              int64_t vb, int64_t vh, int64_t vc, int window, int chunk,
              float scale) {
  static_assert(D == 64, "one lane owns two of the 64 output columns");
  constexpr int kVec = 16 / sizeof(T);      // elements per 16-byte copy
  constexpr int kRow = D + kVec;            // padded shared-memory row
  constexpr int kChunks = D / kVec;         // 16-byte copies per row
  constexpr int kSL = kTile / 32;           // slots of a tile per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* KV = reinterpret_cast<T*>(smem_raw);   // [2 stages][K, V][kTile][kRow]
  T* Qs = KV + 4 * kTile * kRow;            // [G][D]
  // [n_split][G][D + 2]: every block's partials (acc[D], m, l), pushed
  // into the cluster's first block; the others leave theirs unused
  float* part = reinterpret_cast<float*>(Qs + G * D);

  cluster_arrive_relaxed();   // this block has started (see the merge)
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int g = tid / 32, lane = tid % 32;  // warp g: head g of the group
  const int p_now = pos[b];
  const int lo = split * per, hi = min(C, lo + per);
  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;

  const T* kbase = k + b * kb + h * kh;
  const T* vbase = v + b * vb + h * vh;

  // block-uniform: does tile t hold a visible slot? (one barrier)
  auto tile_visible = [&](int t) -> bool {
    int any = 0;
    for (int i = tid; i < kTile; i += nthreads) {
      const int j = lo + t * kTile + i;
      if (j < hi && slot_visible(j, p_now, C, window, chunk)) any = 1;
    }
    return __syncthreads_or(any) != 0;
  };
  auto next_tile = [&](int t) -> int {
    while (t < n_tiles && !tile_visible(t)) ++t;
    return t;
  };
  auto issue = [&](int t, int stage) {
    T* ks = KV + stage * 2 * kTile * kRow;
    T* vs = ks + kTile * kRow;
    const int j0 = lo + t * kTile;
    for (int i = tid; i < kTile * kChunks; i += nthreads) {
      const int jj = i / kChunks, c = i % kChunks;
      const int j = j0 + jj;
      const bool ok = j < hi;
      const int js = ok ? j : lo;
      cp_async16(ks + jj * kRow + c * kVec, kbase + js * kc + c * kVec, ok);
      cp_async16(vs + jj * kRow + c * kVec, vbase + js * vc + c * kVec, ok);
    }
  };

  float m = REPRO_NEG_INF, l = 0.f, acc0 = 0.f, acc1 = 0.f;
  int t = next_tile(0);
  if (t < n_tiles) {   // q of the group travels with the first tile
    issue(t, 0);
    for (int i = tid; i < G * kChunks; i += nthreads)
      cp_async16(Qs + i * kVec, q + b * qb + (h * G + i / kChunks) * qh
                                    + (i % kChunks) * kVec, true);
  }
  cp_async_commit();
  int stage = 0;
  while (t < n_tiles) {
    const int nt = next_tile(t + 1);
    if (nt < n_tiles) issue(nt, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                // tile t has landed
    __syncthreads();                   // for every thread; Qs too

    const T* ks = KV + stage * 2 * kTile * kRow;
    const T* vs = ks + kTile * kRow;
    const T* qg = Qs + g * D;
    const int j0 = lo + t * kTile;
    const int n_mine = min(kTile, hi - j0);              // slots in range
    float s[kSL];
    float m_tile = -INFINITY;
#pragma unroll
    for (int i = 0; i < kSL; ++i) {
      const int jj = lane + 32 * i, j = j0 + jj;
      float val = -INFINITY;   // past the range: excluded entirely
      if (lane + 32 * i < n_mine) {
        const T* kr = ks + jj * kRow;
        float dot0 = 0.f, dot1 = 0.f;   // two chains of FMAs
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          float kf[kVec], qf[kVec];
          unpack16(*reinterpret_cast<const uint4*>(kr + c * kVec), kf, T());
          unpack16(*reinterpret_cast<const uint4*>(qg + c * kVec), qf, T());
#pragma unroll
          for (int e = 0; e < kVec; e += 2) {
            dot0 = fmaf(qf[e], kf[e], dot0);
            dot1 = fmaf(qf[e + 1], kf[e + 1], dot1);
          }
        }
        val = slot_visible(j, p_now, C, window, chunk) ? (dot0 + dot1) * scale
                                                       : REPRO_NEG_INF;
      }
      s[i] = val;
      m_tile = fmaxf(m_tile, val);
    }
    const float m_new = fmaxf(m, warp_max(m_tile));
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kSL; ++i) {
      s[i] = (lane + 32 * i < n_mine) ? expf(s[i] - m_new) : 0.f;
      psum += s[i];
    }
    const float alpha = expf(m - m_new);
    l = l * alpha + warp_sum(psum);
    m = m_new;
    acc0 *= alpha;
    acc1 *= alpha;
#pragma unroll
    for (int i = 0; i < kSL; ++i) {
      const int n_i = min(32, n_mine - 32 * i);   // warp-uniform
#pragma unroll 8
      for (int jj = 0; jj < n_i; ++jj) {
        const float p = __shfl_sync(0xffffffffu, s[i], jj);
        const float2 vv = load2(vs + (32 * i + jj) * kRow + 2 * lane);
        acc0 += p * vv.x;
        acc1 += p * vv.y;
      }
    }
    __syncthreads();   // the stage is consumed before it is refilled
    t = nt;
    stage ^= 1;
  }

  // every block of the cluster has started: push this warp's partial into
  // rank 0's shared memory; cluster.sync() releases it there, and no block
  // reads another's after
  cluster_wait();
  float* mine = cluster.map_shared_rank(part, 0) + (split * G + g) * (D + 2);
  mine[2 * lane] = acc0;
  mine[2 * lane + 1] = acc1;
  if (lane == 0) {
    mine[D] = m;
    mine[D + 1] = l;
  }
  cluster.sync();
  if (split != 0) return;
  // partial split*G + g; a fixed trip count lets every load issue
  const int n_part = gridDim.x;
  float mj[kMaxSplit];
  float M = REPRO_NEG_INF;
#pragma unroll
  for (int j = 0; j < kMaxSplit; ++j) {
    mj[j] = j < n_part ? part[(j * G + g) * (D + 2) + D] : REPRO_NEG_INF;
    M = fmaxf(M, mj[j]);
  }
  float num0 = 0.f, num1 = 0.f, den = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxSplit; ++j) {
    if (j < n_part) {
      const float* pr = part + (j * G + g) * (D + 2);
      const float wt = expf(mj[j] - M);
      den += wt * pr[D + 1];
      num0 += wt * pr[2 * lane];
      num1 += wt * pr[2 * lane + 1];
    }
  }
  den = (den == 0.f) ? 1.f : den;
  T* orow = out + ((int64_t)b * Hkv * G + (int64_t)h * G + g) * D;
  store2(orow + 2 * lane, num0 / den, num1 / den);
}

// n_split and slots per split for a ring of C slots. This decides the
// launch; kernels/decode_attention.py:split_geometry mirrors it for labels
// and tests only, and must be changed with it.
void split_geometry(int C, int* n_split, int* per) {
  *n_split = C < kMaxSplit ? C : kMaxSplit;
  *per = (C + *n_split - 1) / *n_split;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* pos, void* out,
           int B, int Hkv, int C, int G, const int64_t* st, int window,
           int chunk, float scale, cudaStream_t s) {
  constexpr int kRow = D + 16 / sizeof(T);
  const size_t smem =
      sizeof(T) * (4 * kTile * kRow + G * D) + sizeof(float) * kMaxSplit * G * (D + 2);
  auto kern = decode_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int n_split, per;
  split_geometry(C, &n_split, &per);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, Hkv, B);
  cfg.blockDim = dim3(32 * G);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, (const T*)q, (const T*)k, (const T*)v, pos,
                         (T*)out, Hkv, C, G, per, st[0], st[1], st[2], st[3],
                         st[4], st[5], st[6], st[7], window, chunk, scale);
  if (e != cudaSuccess) return (int)e;
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
// (feature) dimension of q, k and v must be contiguous, and every base
// pointer and stride of k and v a multiple of 16 bytes (the wrapper checks).
// out is (B, Hq, d) contiguous. window/chunk <= 0 mean "no mask".
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
