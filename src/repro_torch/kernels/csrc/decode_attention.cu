// Single-token decode attention against a ring-buffer KV cache, for Hopper.
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention / _decode_kernel.
//
// Head dims 16, 32, 64, 96 and 128 are built (one template instance each):
// 64, 96 and 128 serve the registry's configs at full width, 16 every
// config's reduced() (the smoke launchers and the serving bench), 32 the
// reference's own kernel sweeps.
//
// Bound on the H100: bytes. Every K/V slot of the (b, kv head) is read once
// and used for G query heads, about 4*G flops per element, far below the
// ridge. At dcache-agent-150m's serving shape (B=4, Hkv=4, C=512, d=64,
// bf16) the whole call reads 2.1 MB, under a microsecond at 3.35 TB/s, so
// what bounds it in practice is latency: how many loads are in flight at
// once, and how many of the 132 SMs hold them. The larger dense configs
// read 8.4 MB (qwen3-4b: Hkv=8, d=128), 25.2 MB (phi3-mini: Hkv=32, d=96)
// and 41.9 MB (qwen1.5-32b: Hkv=40, d=128) a call, 2.5 to 12.5 us. One
// block per (b, kv head) walking the ring in serial tiles (the first
// version) kept 16 SMs busy, one tile in flight each.
//
// Design: split each row's valid span across a thread-block cluster and
// merge in distributed shared memory, in one launch.
// - Grid (n_split, Hkv * n_gt, B), with a cluster of the n_split blocks of
//   one (b, kv head, group tile); n_split = min(8, C), 8 being the largest
//   portable cluster. A group of G query heads is cut into n_gt tiles of at
//   most max_threads / 32 heads (32; 16 for fp32 at d 96 and 128), as even
//   as they come (group_tiles): any G runs, MQA included. n_gt is 1 up to
//   G 32, so every served config launches as before; a group of n_gt tiles
//   reads the ring n_gt times, once for each tile.
// - The blocks split the row's valid span, not the ring (split_span). From
//   p = pos[b] each block derives the visible positions [start, p], start =
//   max(0, p - C + 1, p - window + 1, floor(p / chunk) * chunk) (window and
//   chunk where set): n = p - start + 1 positions, in the slots (start + o)
//   mod C. Block `split` takes the offsets [split * per, min(n, split * per
//   + per)), per = ceil(n / n_split), counted from slot start mod C, or
//   from slot 0 when the span is the whole ring (n = C): a full ring keeps
//   the ranges [split * ceil(C / n_split), ...) of a split by capacity. A
//   piece that passes slot C - 1 goes on at slot 0. At ~2,000 valid
//   positions of a 16,384-slot ring each of the 8 blocks walks ~250 slots,
//   where a split by capacity (2,048 slots a block) left one block to walk
//   them all while seven skipped. Pieces are not rounded to the 64-slot
//   tile: a piece of per slots takes as many tiles as one of per rounded
//   up. The grid depends on shapes only; pos stays on the device.
// - Each block brings its piece in with 16-byte cp.async copies into
//   padded shared-memory rows (a 64-slot tile in one round trip, tiles
//   double-buffered when the piece is longer). Slots past the piece are
//   zero-filled, so no stale bits reach the P.V sums.
// - Every slot of a piece is visible; each score still passes the
//   ring/window/chunk mask of the TPU kernel (slot_visible), bit for bit. A
//   block with an empty piece (n < n_split, or pos < 0) writes the neutral
//   partial m = -1e30, l = 0, acc = 0.
// - One warp per query head of the group tile: lane j scores
//   slots j and j + 32 of the tile (q, which travels with the first tile's
//   copies, and K as 16-byte vectors from shared memory, q by broadcast;
//   the 16-byte row padding keeps the K reads free of bank conflicts); the
//   tile's max and sum are warp shuffles; lane j owns D / 32 output columns
//   (Cols<D>: 2j and 2j+1 at d 64; also 64+2j and 65+2j at d 128; 64+j at
//   d 96; j at d 32) and takes each slot's weight by shuffle. At d 16 the
//   two half-warps own the 16 columns twice over (lane j column j % 16) and
//   take alternate slots of the tile, and one shuffle adds the halves' acc
//   before the merge (m and l are warp-wide already). Loops stop at the piece's
//   last slot. m, l and acc stay fp32, with the masks of the TPU kernel bit
//   for bit (non-negative ring modulo, floor division for chunks).
// - Merge: each warp writes its (m, l, acc) straight into the shared memory
//   of the cluster's first block (distributed shared memory). Every thread
//   arrives on the cluster barrier once its block has consumed its last
//   tile and waits on it just before that write: no block writes another's
//   shared memory before every block of the cluster has finished reading
//   its own, so the partials' buffer overlays the K/V stages and q (a
//   block's shared memory is the larger of the two, not their sum:
//   smem_bytes). One cluster.sync() then publishes the partials, the other
//   blocks exit, and the first block forms sum_i e^(m_i - M) acc_i / sum_i
//   e^(m_i - M) l_i with M = max_i m_i and the l == 0 guard of the TPU
//   kernel's finalize, from its own shared memory. No second (combine)
//   launch.
// fp32 inputs take the same design with 4-byte elements; the tensor cores
// play no part (G = 3 query rows are too few for an mma tile).
//
// The int8 variant (decode_int8_kernel, repro_decode_attention_int8) serves
// the int8 KV cache of cfg.kv_quant. It has no Pallas counterpart: it
// replaces the XLA chain dequantize_kv + masked softmax attention of
// src/repro/models/attention.py:decode_attend. Same grid, cluster, span
// split, masks and merge; what differs is the tile:
// - a head row of codes is D bytes, D / 16 16-byte cp.async copies (half
//   the bf16 bytes), into padded shared-memory rows of 48, 48, 80, 112 and
//   144 bytes at d 16, 32, 64, 96 and 128 (int8_row: an odd number of
//   16-byte chunks, as the bf16 rows are, so row reads stay free of bank
//   conflicts);
// - the scales (one per slot and kv head, in q's type, strided by Hkv
//   elements) are too narrow for cp.async: each thread loads its slots'
//   scales of the next tile into registers when it issues that tile's
//   copies and stores them to shared memory after computing the current
//   tile, so the load's latency hides behind the compute;
// - each element is dequantized when it is read from shared memory, as
//   dequantize_kv does it: float(code) * float(scale), rounded to q's type
//   (bf16 round to nearest even) before it enters q.k or P.V in fp32.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSplit = 8;   // cluster size: the largest portable one
constexpr int kTile = 64;      // slots per shared-memory tile
constexpr int kMaxSmem = 232448;   // the opt-in dynamic shared memory a block may use

// The output columns a lane owns: D / 32 of them (1 at d 32, 2 at d 64, 3
// at d 96, 4 at d 128). The first 64 * (D / 64) columns go in pairs,
// columns 64p + 2 lane and 64p + 2 lane + 1 (one 4- or 8-byte access); the
// last 32 of a D that is not a multiple of 64 go one a lane, column 64 (D /
// 64) + lane. Either way a warp's accesses to one shared-memory row are
// consecutive. At d 16 (kHalves = 2) lane j owns column j % 16 and its
// half-warp j / 16 takes every other slot (slot_of), so the warp reads two
// rows at once; owner() marks the lanes that write the merged columns.
template <int D>
struct Cols {
  static_assert(D == 16 || D % 32 == 0, "a warp owns 16, 32 or 64 columns at a time");
  static constexpr int kHalves = D == 16 ? 2 : 1;   // slots a warp takes at once
  static constexpr int kPairs = D / 64;
  static constexpr int kSingles = D == 16 ? 1 : (D % 64) / 32;
  static constexpr int kN = 2 * kPairs + kSingles;
  __device__ static __forceinline__ int col(int i, int lane) {
    return i < 2 * kPairs ? 64 * (i / 2) + 2 * lane + (i & 1)
                          : 64 * kPairs + 32 * (i - 2 * kPairs) + lane % (32 / kHalves);
  }
  // the slot of a step of kHalves slots (from jj) this lane takes
  __device__ static __forceinline__ int slot_of(int jj, int lane) {
    return jj + lane / (32 / kHalves);
  }
  __device__ static __forceinline__ bool owner(int lane) {
    return lane < 32 / kHalves;
  }
  // add the half-warps' partial sums (every lane ends with the column's total)
  __device__ static __forceinline__ void join_halves(float* acc) {
    if (kHalves == 2) {
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
    }
  }
};

// the cluster barrier in two halves: an arrive that releases this thread's
// earlier shared-memory accesses, and the wait that completes it; every
// thread of every block of the cluster executes both
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
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

// A block's piece of its row's valid span: `len` slots from slot `first`,
// (first + o) mod C for o < len. The span is the visible positions [start,
// p_now] (n of them, none for p_now < 0), in the slots (start + o) mod C;
// block `split` of n_split takes offsets [split * per, split * per + per)
// of it, per = ceil(n / n_split), counted from slot start mod C, or from
// slot 0 when the span is the whole ring (the ranges of a split by
// capacity). kernels/decode_attention.py:split_geometry mirrors it for
// labels and tests only, and must be changed with it.
struct Piece {
  int first, len;
  __device__ __forceinline__ int slot(int o, int C) const {
    const int j = first + o;   // first < C and o < C
    return j < C ? j : j - C;
  }
};

__device__ __forceinline__ Piece split_span(int p_now, int C, int window,
                                            int chunk, int split, int n_split) {
  int start = max(0, p_now - C + 1);
  if (window > 0) start = max(start, p_now - window + 1);
  if (chunk > 0) start = max(start, floor_div(p_now, chunk) * chunk);
  const int n = max(0, p_now - start + 1);
  const int per = (n + n_split - 1) / n_split;
  const int lo = min(n, split * per);
  Piece pc;
  pc.first = (n == C ? 0 : start % C) + lo;
  pc.first -= pc.first < C ? 0 : C;
  pc.len = min(n, lo + per) - lo;
  return pc;
}

// The group's head a tile's warp i computes: g0 + i, or the group's last
// head for a warp past the end of the last (shorter) tile, which computes
// on a real head and stores nothing.
__device__ __forceinline__ int head_of(int g0, int i, int G) {
  return min(g0 + i, G - 1);
}

// The output row of head g of kv head h's group, or null past the group.
template <typename T>
__device__ __forceinline__ T* out_row(T* out, int b, int h, int Hkv, int G,
                                      int g, int D) {
  return g < G ? out + ((int64_t)b * Hkv * G + (int64_t)h * G + g) * D : nullptr;
}

// Every block of the cluster has consumed its tiles (each arrived on the
// cluster barrier after its last one): push this warp's partial (acc over
// the lane's columns Cols<D>::col, m, l) into rank 0's shared memory `part`
// ([n_split][G][D + 2], G the tile's heads, over rank 0's K/V stages);
// cluster.sync() releases it there, and no block reads another's after.
// Rank 0 then merges the partials of head g into orow (null for a warp past
// the last tile's heads: it stores nothing).
template <typename T, int D>
__device__ __forceinline__ void merge_partials(float* part, int split, int G,
                                               int g, int lane, float m, float l,
                                               const float* acc, T* orow) {
  using C = Cols<D>;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();
  float* mine = cluster.map_shared_rank(part, 0) + (split * G + g) * (D + 2);
  if (C::owner(lane)) {
#pragma unroll
    for (int i = 0; i < C::kN; ++i) mine[C::col(i, lane)] = acc[i];
  }
  if (lane == 0) {
    mine[D] = m;
    mine[D + 1] = l;
  }
  cluster.sync();
  if (split != 0 || orow == nullptr) return;
  // partial split*G + g; a fixed trip count lets every load issue
  const int n_part = gridDim.x;
  float mj[kMaxSplit];
  float M = REPRO_NEG_INF;
#pragma unroll
  for (int j = 0; j < kMaxSplit; ++j) {
    mj[j] = j < n_part ? part[(j * G + g) * (D + 2) + D] : REPRO_NEG_INF;
    M = fmaxf(M, mj[j]);
  }
  float num[C::kN], den = 0.f;
#pragma unroll
  for (int i = 0; i < C::kN; ++i) num[i] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxSplit; ++j) {
    if (j < n_part) {
      const float* pr = part + (j * G + g) * (D + 2);
      const float wt = expf(mj[j] - M);
      den += wt * pr[D + 1];
#pragma unroll
      for (int i = 0; i < C::kN; ++i) num[i] += wt * pr[C::col(i, lane)];
    }
  }
  den = (den == 0.f) ? 1.f : den;
#pragma unroll
  for (int p = 0; p < C::kPairs; ++p)
    store2(orow + C::col(2 * p, lane), num[2 * p] / den, num[2 * p + 1] / den);
  if (C::owner(lane)) {
#pragma unroll
    for (int i = 2 * C::kPairs; i < C::kN; ++i)
      orow[C::col(i, lane)] = from_f32<T>(num[i] / den);
  }
}

// Threads a block may have, one warp per query head of its group tile: 32
// heads, except fp32 at d 96 and 128, 16. Under a 1,024-thread bound ptxas
// kept those two instances to 32 registers and spilled; under 640 they
// took 47-48, and the d 96 one spilled 8 bytes once the group tiles' indices
// were added; under 512 alone they took 40 and the d 128 one spilled 20
// bytes once the span split was added. min_blocks asks for two such blocks
// an SM, which lets them have 64 registers: no spill. 0, for every other
// instance, leaves ptxas its own choice.
template <typename T, int D>
constexpr int max_threads() { return sizeof(T) == 4 && D > 64 ? 512 : 1024; }
template <typename T, int D>
constexpr int min_blocks() { return max_threads<T, D>() == 512 ? 2 : 0; }

template <typename T, int D>
__global__ void __launch_bounds__(max_threads<T, D>(), min_blocks<T, D>())
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ pos,
              T* __restrict__ out, int Hkv, int C, int G,
              int64_t qb, int64_t qh, int64_t kb, int64_t kh, int64_t kc,
              int64_t vb, int64_t vh, int64_t vc, int window, int chunk,
              float scale) {
  using Cl = Cols<D>;                       // the lane's output columns
  constexpr int kVec = 16 / sizeof(T);      // elements per 16-byte copy
  constexpr int kRow = D + kVec;            // padded shared-memory row
  constexpr int kChunks = D / kVec;         // 16-byte copies per row
  constexpr int kSL = kTile / 32;           // slots of a tile per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* KV = reinterpret_cast<T*>(smem_raw);   // [2 stages][K, V][kTile][kRow]
  const int gt = blockDim.x / 32;           // heads of a group tile
  T* Qs = KV + 4 * kTile * kRow;            // [gt][D]
  // [n_split][gt][D + 2]: every block's partials (acc[D], m, l), pushed
  // into the cluster's first block over its stages and q once they are
  // consumed; the others leave theirs unused
  float* part = reinterpret_cast<float*>(smem_raw);

  const int split = blockIdx.x, b = blockIdx.z;
  const int n_gt = gridDim.y / Hkv, h = blockIdx.y / n_gt;
  const int g0 = (blockIdx.y % n_gt) * gt;  // the tile's first head
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int g = tid / 32, lane = tid % 32;  // warp g: head g0 + g of the group
  const int p_now = pos[b];
  const Piece pc = split_span(p_now, C, window, chunk, split, gridDim.x);
  const int n_tiles = (pc.len + kTile - 1) / kTile;

  const T* kbase = k + b * kb + h * kh;
  const T* vbase = v + b * vb + h * vh;

  auto issue = [&](int t, int stage) {
    T* ks = KV + stage * 2 * kTile * kRow;
    T* vs = ks + kTile * kRow;
    const int o0 = t * kTile;
    for (int i = tid; i < kTile * kChunks; i += nthreads) {
      const int jj = i / kChunks, c = i % kChunks;
      const bool ok = o0 + jj < pc.len;
      const int js = ok ? pc.slot(o0 + jj, C) : pc.first;
      cp_async16(ks + jj * kRow + c * kVec, kbase + js * kc + c * kVec, ok);
      cp_async16(vs + jj * kRow + c * kVec, vbase + js * vc + c * kVec, ok);
    }
  };

  float m = REPRO_NEG_INF, l = 0.f, acc[Cl::kN];
#pragma unroll
  for (int i = 0; i < Cl::kN; ++i) acc[i] = 0.f;
  if (n_tiles > 0) {   // q of the tile travels with the first tile
    issue(0, 0);
    for (int i = tid; i < gt * kChunks; i += nthreads)
      cp_async16(Qs + i * kVec, q + b * qb + (h * G + head_of(g0, i / kChunks, G)) * qh
                                    + (i % kChunks) * kVec, true);
  }
  cp_async_commit();
  int stage = 0;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) issue(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                // tile t has landed
    __syncthreads();                   // for every thread; Qs too

    const T* ks = KV + stage * 2 * kTile * kRow;
    const T* vs = ks + kTile * kRow;
    const T* qg = Qs + g * D;
    const int o0 = t * kTile;
    const int n_mine = min(kTile, pc.len - o0);          // slots in the piece
    float s[kSL];
    float m_tile = -INFINITY;
#pragma unroll
    for (int i = 0; i < kSL; ++i) {
      const int jj = lane + 32 * i;
      float val = -INFINITY;   // past the piece: excluded entirely
      if (jj < n_mine) {
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
        val = slot_visible(pc.slot(o0 + jj, C), p_now, C, window, chunk)
                  ? (dot0 + dot1) * scale : REPRO_NEG_INF;
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
#pragma unroll
    for (int c = 0; c < Cl::kN; ++c) acc[c] *= alpha;
    // slots past n_i (a step of two at d 16) have p = 0 and zero-filled V
#pragma unroll
    for (int i = 0; i < kSL; ++i) {
      const int n_i = min(32, n_mine - 32 * i);   // warp-uniform
#pragma unroll 8
      for (int jj = 0; jj < n_i; jj += Cl::kHalves) {
        const int js = Cl::slot_of(jj, lane);
        const float p = __shfl_sync(0xffffffffu, s[i], js);
        const T* vr = vs + (32 * i + js) * kRow;
#pragma unroll
        for (int c = 0; c < Cl::kPairs; ++c) {
          const float2 vv = load2(vr + Cl::col(2 * c, lane));
          acc[2 * c] += p * vv.x;
          acc[2 * c + 1] += p * vv.y;
        }
#pragma unroll
        for (int c = 2 * Cl::kPairs; c < Cl::kN; ++c)
          acc[c] += p * to_f32(vr[Cl::col(c, lane)]);
      }
    }
    __syncthreads();   // the stage is consumed before it is refilled
    stage ^= 1;
  }

  cluster_arrive();   // this block's stages and q are consumed (see the merge)
  Cl::join_halves(acc);
  merge_partials<T, D>(part, split, gt, g, lane, m, l, acc,
                       out_row(out, b, h, Hkv, G, g0 + g, D));
}

// A 16-byte chunk of codes is four 32-bit words; code e of word w, sign
// extended.
__device__ __forceinline__ int code_at(uint32_t w, int e) {
  return static_cast<int>(w << (24 - 8 * e)) >> 24;
}

// an element as dequantize_kv gives it: float(code) * float(scale), cast to T
template <typename T>
__device__ __forceinline__ float dequant(int code, float s) {
  return to_f32(from_f32<T>(static_cast<float>(code) * s));
}

// The int8 kernel's padded shared-memory row of codes, in bytes: D + 16,
// or D + 32 where that would be an even number of 16-byte chunks (d 16).
template <int D>
__host__ __device__ constexpr int int8_row() { return (D / 16) % 2 ? D + 32 : D + 16; }

// Threads an int8 block may have: 32 heads a group tile at every d.
constexpr int kInt8Threads = 1024;

// The int8 variant: k/v are int8 codes, ks/vs the per-slot-per-kv-head
// scales in T (strides in elements). One warp per query head of the group
// tile, as above.
template <typename T, int D>
__global__ void __launch_bounds__(kInt8Threads)
decode_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                   const int8_t* __restrict__ v, const T* __restrict__ ks,
                   const T* __restrict__ vs, const int* __restrict__ pos,
                   T* __restrict__ out, int Hkv, int C, int G,
                   int64_t qb, int64_t qh, int64_t kb, int64_t kh, int64_t kc,
                   int64_t vb, int64_t vh, int64_t vc, int64_t ksb, int64_t ksh,
                   int64_t ksc, int64_t vsb, int64_t vsh, int64_t vsc,
                   int window, int chunk, float scale) {
  using Cl = Cols<D>;                       // the lane's output columns
  constexpr int kVec = 16 / sizeof(T);      // q elements per 16-byte copy
  constexpr int kRow = int8_row<D>();       // padded shared-memory row, bytes
  constexpr int kChunks = D / 16;           // 16-byte copies (16 codes) per row
  constexpr int kSL = kTile / 32;           // slots of a tile per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* KV = reinterpret_cast<int8_t*>(smem_raw);  // [2][K, V][kTile][kRow]
  float* SC = reinterpret_cast<float*>(KV + 4 * kTile * kRow);  // [2][K, V][kTile]
  const int gt = blockDim.x / 32;                               // heads of a group tile
  T* Qs = reinterpret_cast<T*>(SC + 4 * kTile);                 // [gt][D]
  // [n_split][gt][D + 2], over the stages, scales and q (see decode_kernel)
  float* part = reinterpret_cast<float*>(smem_raw);

  const int split = blockIdx.x, b = blockIdx.z;
  const int n_gt = gridDim.y / Hkv, h = blockIdx.y / n_gt;
  const int g0 = (blockIdx.y % n_gt) * gt;  // the tile's first head
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int g = tid / 32, lane = tid % 32;
  const int p_now = pos[b];
  const Piece pc = split_span(p_now, C, window, chunk, split, gridDim.x);
  const int n_tiles = (pc.len + kTile - 1) / kTile;

  // the row's base pointers are formed where they are used: held in
  // registers across the tile loop they took the fp32 d 96 instance past
  // its 64 registers (a 4-byte spill)
  auto issue = [&](int t, int stage) {
    int8_t* kst = KV + stage * 2 * kTile * kRow;
    int8_t* vst = kst + kTile * kRow;
    const int o0 = t * kTile;
    for (int i = tid; i < kTile * kChunks; i += nthreads) {
      const int jj = i / kChunks, c = i % kChunks;
      const bool ok = o0 + jj < pc.len;
      const int js = ok ? pc.slot(o0 + jj, C) : pc.first;
      cp_async16(kst + jj * kRow + c * 16, k + b * kb + h * kh + js * kc + c * 16, ok);
      cp_async16(vst + jj * kRow + c * 16, v + b * vb + h * vh + js * vc + c * 16, ok);
    }
  };
  // this thread's scales of a tile (slots tid and tid + nthreads; two cover
  // the tile when a tile holds one head), 0 past the piece
  float ksr[2], vsr[2];
  auto load_scales = [&](int t) {
    const int o0 = t * kTile;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = tid + r * nthreads;
      const bool ok = i < kTile && o0 + i < pc.len;
      const int j = ok ? pc.slot(o0 + i, C) : 0;
      ksr[r] = ok ? to_f32(ks[b * ksb + h * ksh + j * ksc]) : 0.f;
      vsr[r] = ok ? to_f32(vs[b * vsb + h * vsh + j * vsc]) : 0.f;
    }
  };
  auto store_scales = [&](int stage) {
    float* kss = SC + stage * 2 * kTile;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = tid + r * nthreads;
      if (i < kTile) {
        kss[i] = ksr[r];
        kss[kTile + i] = vsr[r];
      }
    }
  };

  float m = REPRO_NEG_INF, l = 0.f, acc[Cl::kN];
#pragma unroll
  for (int i = 0; i < Cl::kN; ++i) acc[i] = 0.f;
  if (n_tiles > 0) {   // q of the tile travels with the first tile
    issue(0, 0);
    for (int i = tid; i < gt * (D / kVec); i += nthreads)
      cp_async16(Qs + i * kVec,
                 q + b * qb + (h * G + head_of(g0, i / (D / kVec), G)) * qh
                   + (i % (D / kVec)) * kVec, true);
    load_scales(0);
    store_scales(0);
  }
  cp_async_commit();
  int stage = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const bool more = t + 1 < n_tiles;
    if (more) {
      issue(t + 1, stage ^ 1);
      load_scales(t + 1);              // stored after this tile's compute
    }
    cp_async_commit();
    cp_async_wait<1>();                // tile t has landed
    __syncthreads();                   // for every thread; Qs and scales too

    const int8_t* kst = KV + stage * 2 * kTile * kRow;
    const int8_t* vst = kst + kTile * kRow;
    const float* kss = SC + stage * 2 * kTile;
    const float* vss = kss + kTile;
    const T* qg = Qs + g * D;
    const int o0 = t * kTile;
    const int n_mine = min(kTile, pc.len - o0);          // slots in the piece
    float s[kSL];
    float m_tile = -INFINITY;
#pragma unroll
    for (int i = 0; i < kSL; ++i) {
      const int jj = lane + 32 * i;
      float val = -INFINITY;   // past the piece: excluded entirely
      if (jj < n_mine) {
        const int8_t* kr = kst + jj * kRow;
        const float sk = kss[jj];
        float dot0 = 0.f, dot1 = 0.f;   // two chains of FMAs
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const uint4 u = *reinterpret_cast<const uint4*>(kr + c * 16);
          const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int qq = 0; qq < 16 / kVec; ++qq) {
            float qf[kVec];
            unpack16(*reinterpret_cast<const uint4*>(qg + c * 16 + qq * kVec),
                     qf, T());
#pragma unroll
            for (int e = 0; e < kVec; e += 2) {
              const int n = qq * kVec + e;   // code n and n + 1 of the chunk
              dot0 = fmaf(qf[e], dequant<T>(code_at(w[n / 4], n % 4), sk), dot0);
              dot1 = fmaf(qf[e + 1],
                          dequant<T>(code_at(w[(n + 1) / 4], (n + 1) % 4), sk),
                          dot1);
            }
          }
        }
        val = slot_visible(pc.slot(o0 + jj, C), p_now, C, window, chunk)
                  ? (dot0 + dot1) * scale : REPRO_NEG_INF;
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
#pragma unroll
    for (int c = 0; c < Cl::kN; ++c) acc[c] *= alpha;
    // slots past n_i (a step of two at d 16) have p = 0, zero codes and
    // scale 0
#pragma unroll
    for (int i = 0; i < kSL; ++i) {
      const int n_i = min(32, n_mine - 32 * i);   // warp-uniform
#pragma unroll 8
      for (int jj = 0; jj < n_i; jj += Cl::kHalves) {
        const int js = Cl::slot_of(jj, lane);
        const int slot = 32 * i + js;
        const float p = __shfl_sync(0xffffffffu, s[i], js);
        const float sv = vss[slot];
        const int8_t* vr = vst + slot * kRow;
#pragma unroll
        for (int c = 0; c < Cl::kPairs; ++c) {
          const uint32_t two =
              *reinterpret_cast<const uint16_t*>(vr + Cl::col(2 * c, lane));
          acc[2 * c] += p * dequant<T>(code_at(two, 0), sv);
          acc[2 * c + 1] += p * dequant<T>(code_at(two, 1), sv);
        }
#pragma unroll
        for (int c = 2 * Cl::kPairs; c < Cl::kN; ++c)
          acc[c] += p * dequant<T>(vr[Cl::col(c, lane)], sv);
      }
    }
    if (more) store_scales(stage ^ 1);   // its readers passed the last
    __syncthreads();   // barrier; the stage is consumed before refilled
    stage ^= 1;
  }
  cluster_arrive();   // stages, scales and q consumed (see the merge)
  Cl::join_halves(acc);
  merge_partials<T, D>(part, split, gt, g, lane, m, l, acc,
                       out_row(out, b, h, Hkv, G, g0 + g, D));
}

// Blocks a cluster has for a ring of C slots: the grid depends on C only.
// Which slots each block reads is decided on the device, from pos
// (split_span).
int n_splits(int C) { return C < kMaxSplit ? C : kMaxSplit; }

// A group of G query heads in n_gt tiles of at most max_heads heads, as
// even as they come: tile i takes heads [i * gt, min(G, (i + 1) * gt)), and
// none is empty ((n_gt - 1) * gt <= (n_gt - 1) * max_heads < G). This
// decides the launch; kernels/decode_attention.py:group_tiles mirrors it
// for labels and tests only, and must be changed with it.
void group_tiles(int G, int max_heads, int* n_gt, int* gt) {
  *n_gt = (G + max_heads - 1) / max_heads;
  *gt = (G + *n_gt - 1) / *n_gt;
}

// What a launch of one instance needs beside its arguments: the kernel, its
// group tiles (gt warps a block) and its dynamic shared memory, the larger
// of the tile stages (with q, and the int8 scales) and the merge buffer
// ([kMaxSplit][gt][D + 2] floats) that overlays them.
struct Geometry {
  const void* kern;
  int n_gt, gt;
  size_t smem;
};

size_t merge_bytes(int gt, int D) { return sizeof(float) * kMaxSplit * gt * (D + 2); }

template <typename T, int D>
Geometry plain_geometry(int G) {
  Geometry g;
  group_tiles(G, max_threads<T, D>() / 32, &g.n_gt, &g.gt);
  constexpr int kRow = D + 16 / sizeof(T);
  g.smem = std::max(sizeof(T) * (4 * kTile * kRow + g.gt * D), merge_bytes(g.gt, D));
  g.kern = (const void*)decode_kernel<T, D>;
  return g;
}

template <typename T, int D>
Geometry int8_geometry(int G) {
  Geometry g;
  group_tiles(G, kInt8Threads / 32, &g.n_gt, &g.gt);
  g.smem = std::max(4 * kTile * int8_row<D>() + sizeof(float) * 4 * kTile
                        + sizeof(T) * g.gt * D,
                    merge_bytes(g.gt, D));
  g.kern = (const void*)decode_int8_kernel<T, D>;
  return g;
}

// The launch of geo's kernel on the grid (n_split, Hkv * n_gt, B) with
// clusters of the n_split blocks of one (b, kv head, group tile), after
// the opt-in to its shared memory; attr holds the cluster's size.
cudaError_t cluster_config(const Geometry& geo, int B, int Hkv, int C,
                           cudaStream_t s, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  // the merge buffer grows with gt * D: every instance's largest tile fits
  // (fp32 d 128 at 16 heads, bf16 and int8 at 32); a larger one is refused
  // here
  if (geo.smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      geo.kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (e != cudaSuccess) return e;
  const int n_split = n_splits(C);
  *cfg = {};
  cfg->gridDim = dim3(n_split, Hkv * geo.n_gt, B);
  cfg->blockDim = dim3(32 * geo.gt);
  cfg->dynamicSmemBytes = geo.smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n_split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Launch `go(cfg)` on geo's cluster_config.
template <typename Go>
int launch_clusters(const Geometry& geo, int B, int Hkv, int C, cudaStream_t s,
                    Go&& go) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = cluster_config(geo, B, Hkv, C, s, &attr, &cfg);
  if (e == cudaSuccess) e = go(cfg);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* pos, void* out,
           int B, int Hkv, int C, int G, const int64_t* st, int window,
           int chunk, float scale, cudaStream_t s) {
  const Geometry geo = plain_geometry<T, D>(G);
  auto kern = decode_kernel<T, D>;
  return launch_clusters(geo, B, Hkv, C, s, [&](const cudaLaunchConfig_t& cfg) {
    return cudaLaunchKernelEx(&cfg, kern, (const T*)q, (const T*)k,
                              (const T*)v, pos, (T*)out, Hkv, C, G, st[0], st[1],
                              st[2], st[3], st[4], st[5], st[6], st[7], window,
                              chunk, scale);
  });
}

template <typename T, int D>
int launch_int8(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const int* pos, void* out, int B, int Hkv, int C,
                int G, const int64_t* st, int window, int chunk, float scale,
                cudaStream_t s) {
  const Geometry geo = int8_geometry<T, D>(G);
  auto kern = decode_int8_kernel<T, D>;
  return launch_clusters(geo, B, Hkv, C, s, [&](const cudaLaunchConfig_t& cfg) {
    return cudaLaunchKernelEx(&cfg, kern, (const T*)q,
                              (const int8_t*)k, (const int8_t*)v, (const T*)ks,
                              (const T*)vs, pos, (T*)out, Hkv, C, G, st[0], st[1],
                              st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                              st[9], st[10], st[11], st[12], st[13], window,
                              chunk, scale);
  });
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
  if (G < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int64_t st[8] = {q_b, q_h, k_b, k_h, k_c, v_b, v_h, v_c};
  cudaStream_t s = (cudaStream_t)stream;
  return with_head_dim(d, [&](auto D) {
    constexpr int kD = decltype(D)::value;
    if (dtype == kF32)
      return launch<float, kD>(q, k, v, (const int*)pos, out, B, Hkv, C, G, st,
                               window, chunk, scale, s);
    return launch<__nv_bfloat16, kD>(q, k, v, (const int*)pos, out, B, Hkv, C,
                                     G, st, window, chunk, scale, s);
  });
}

// The int8 variant. k/v: int8 codes with the strides of repro_decode_attention
// (in elements, which are bytes here); k_scale/v_scale: (B, Hkv, C) in q's
// type (dtype), strides ks_b, ks_h, ks_c and vs_b, vs_h, vs_c in elements,
// no alignment needed beyond the element. out is (B, Hq, d) contiguous.
extern "C" int repro_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* pos, void* out, int B, int Hkv, int C,
    int G, int d, int64_t q_b, int64_t q_h, int64_t k_b, int64_t k_h,
    int64_t k_c, int64_t v_b, int64_t v_h, int64_t v_c, int64_t ks_b,
    int64_t ks_h, int64_t ks_c, int64_t vs_b, int64_t vs_h, int64_t vs_c,
    int window, int chunk, float scale, int dtype, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (G < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int64_t st[14] = {q_b, q_h, k_b, k_h, k_c, v_b, v_h, v_c,
                          ks_b, ks_h, ks_c, vs_b, vs_h, vs_c};
  cudaStream_t s = (cudaStream_t)stream;
  return with_head_dim(d, [&](auto D) {
    constexpr int kD = decltype(D)::value;
    if (dtype == kF32)
      return launch_int8<float, kD>(q, k, v, k_scale, v_scale, (const int*)pos,
                                    out, B, Hkv, C, G, st, window, chunk, scale,
                                    s);
    return launch_int8<__nv_bfloat16, kD>(q, k, v, k_scale, v_scale,
                                          (const int*)pos, out, B, Hkv, C, G, st,
                                          window, chunk, scale, s);
  });
}

// For labels: what a launch of repro_decode_attention (int8 0) or of
// repro_decode_attention_int8 (int8 1) takes at Hkv kv heads of G query
// heads each, head dim d and a ring of C slots, as five ints: threads a
// block, dynamic shared memory a block (bytes), blocks resident on one SM,
// clusters resident on the card at once, blocks a cluster (n_split).
extern "C" int repro_decode_attention_occupancy(int Hkv, int C, int G, int d,
                                                int dtype, int int8, int* res) {
  if (Hkv < 1 || G < 1 || C < 1) return (int)cudaErrorInvalidValue;
  return with_head_dim(d, [&](auto D) {
    constexpr int kD = decltype(D)::value;
    const Geometry geo =
        dtype == kF32 ? (int8 ? int8_geometry<float, kD>(G) : plain_geometry<float, kD>(G))
                      : (int8 ? int8_geometry<__nv_bfloat16, kD>(G)
                              : plain_geometry<__nv_bfloat16, kD>(G));
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cudaError_t e = cluster_config(geo, 1, Hkv, C, 0, &attr, &cfg);
    int blocks = 0, clusters = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, geo.kern,
                                                        32 * geo.gt, geo.smem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, geo.kern, &cfg);
    const int v[5] = {32 * geo.gt, (int)geo.smem, blocks, clusters, n_splits(C)};
    for (int i = 0; i < 5; ++i) res[i] = v[i];
    return (int)e;
  });
}
