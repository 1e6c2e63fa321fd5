// Absorbed latent-attention (MLA) decode against a latent ring, for Hopper.
//
// Replaces no TPU kernel: the JAX package has no latent attention. It serves
// DeepSeek-V2's decode step in its absorbed form. Each token's K and V are
// one latent row of 576: the normed latent c (512) and the roped shared key
// k_rope (64). Each query head's q_nope is multiplied into the latent space
// by W_UK beforehand (models/attention.py), so a head's query is q = [q_lat
// (512) | q_rope (64)], its score against slot j is q . ring[j] over all 576,
// and its output is softmax(scale * scores) . ring[:, :512], the latent that
// W_UV and o_proj take from there. All 16 heads share the one ring row: MQA
// with a key of 576 and a value of 512.
//
// Bound on the H100: bytes. A row reads each valid latent row once (1,152 B)
// for 16 heads; the work is 16 x (576 + 512) x 2 = 34,816 FLOPs a position,
// 30 a byte, far below bf16's ridge (295) but above fp32 FMA's (20), so the
// products go to the tensor cores. At dsv2lite-react's decode step (64 rows
// at ~6.6K valid positions of a 16,384-slot ring) a layer reads ~490 MB,
// ~146 us at 3.35 TB/s.
//
// Design (mla_latent_kernel; named apart from decode_kernel and
// flash_kernel, which the benchmark's readers find by substring):
// - Grid (n_split, 1, B) with a thread-block cluster of the n_split blocks
//   of a row; n_split = 8 (the largest portable cluster), fewer on a ring of
//   fewer slots (a power of two, so the merge's column slices are even). The
//   blocks split the row's valid span, not the ring, as decode_kernel does
//   since it was split over each row's valid span (split_span): from p =
//   pos[b] the visible positions are [max(0, p - C + 1), p], and block i
//   takes the i-th of n_split even pieces of them, counted from the slot of
//   the first (from slot 0 when the span is the whole ring). The grid
//   depends on shapes only; pos stays on the device.
// - A block has 4 warps and walks its piece in tiles of 32 slots, brought in
//   with 16-byte cp.async copies into padded shared-memory rows (584
//   elements, 73 16-byte chunks: an odd count keeps every ldmatrix free of
//   bank conflicts), double-buffered; slots past the piece are zero-filled.
//   q (16 x 576, rows past H zero-filled) comes with the first tile.
// - Scores on the tensor cores: mma.sync m16n8k16 bf16 with fp32
//   accumulators, the 16 heads as the 16 rows of the A tile (ldmatrix of
//   q), warp w taking the tile's slots 8w..8w+7 (ldmatrix of the rows as the
//   "col" B operand) over 36 k-steps, in two chains of accumulators.
// - Online softmax in fp32: each warp's row maxima go through shared
//   memory, so every warp rescales with the same running max m; a warp keeps
//   the row sums l of its own slots. P is rounded to bf16 into shared memory
//   (16 x 32), as the flash kernel rounds P before P.V.
// - O += P V on the tensor cores: warp w owns the 128 value columns 128w ..
//   128w + 127 (16 n8-tiles, 64 fp32 accumulators a lane), V read from the
//   same tile rows with ldmatrix.trans.
// - Merge: each block writes its partial (O 16 x 512, m, l; fp32) over its
//   own consumed stages, then cluster.sync(); block i merges the columns
//   [i * 512 / n_split, (i + 1) * 512 / n_split) of every head from all the
//   blocks' shared memory (distributed shared memory), with weights
//   e^(m_j - M) / sum_j e^(m_j - M) l_j, M = max_j m_j (a zero denominator,
//   none in practice, counts as 1), and writes them in bf16; a last
//   cluster.sync() keeps every block's shared memory alive until all have
//   read it. One launch, no scratch in device memory.
// bf16 only; the plain version (kernels/mla_decode.py) serves the CPU.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kH = 16;             // query heads: the 16 rows of an mma tile
constexpr int kDK = 576;           // score width: latent 512 + rope 64
constexpr int kDV = 512;           // value width: the latent
constexpr int kTile = 32;          // ring slots a tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplit = 8;       // cluster size: the largest portable one
constexpr int kRow = kDK + 8;      // padded shared-memory row (elements)
constexpr int kChunks = kDK / 8;   // 16-byte copies a row
constexpr int kPRow = kTile + 8;   // P row: 80 bytes, 5 16-byte chunks
constexpr int kCols = kDV / kWarps;  // value columns a warp owns
constexpr int kKSteps = kDK / 16;  // 36

// shared memory, in bytes: q, two stages, P, the warps' row maxima
constexpr size_t kSmemQ = sizeof(bf16) * kH * kRow;
constexpr size_t kSmemStages = sizeof(bf16) * 2 * kTile * kRow;
constexpr size_t kSmemP = sizeof(bf16) * kH * kPRow;
constexpr size_t kSmem = kSmemQ + kSmemStages + kSmemP + sizeof(float) * kWarps * kH;
// the partials that overlay it once the tiles are consumed: O, m, l, the
// warps' l, the merge's weights
constexpr size_t kSmemPart =
    sizeof(float) * (kH * kDV + 2 * kH + kWarps * kH + kMaxSplit * kH);
static_assert(kSmemPart <= kSmem, "the partials overlay the tiles");
static_assert(kDV % (8 * kWarps) == 0 && kCols % 16 == 0, "n8-tiles in pairs");

// A block's piece of its row's valid span: `len` slots from slot `first`,
// (first + o) mod C for o < len.
struct Piece {
  int first, len;
  __device__ __forceinline__ int slot(int o, int C) const {
    const int j = first + o;   // first < C and o < C
    return j < C ? j : j - C;
  }
};

__device__ __forceinline__ Piece split_span(int p_now, int C, int split,
                                            int n_split) {
  const int start = max(0, p_now - C + 1);
  const int n = max(0, p_now - start + 1);
  const int per = (n + n_split - 1) / n_split;
  const int lo = min(n, split * per);
  Piece pc;
  pc.first = (n == C ? 0 : start % C) + lo;
  pc.first -= pc.first < C ? 0 : C;
  pc.len = min(n, lo + per) - lo;
  return pc;
}

__global__ void __launch_bounds__(kThreads)
mla_latent_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ring,
                  const int* __restrict__ pos, bf16* __restrict__ out, int H,
                  int C, int64_t qb, int64_t qh, int64_t rb, int64_t rc,
                  float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);          // [kH][kRow]
  bf16* KV = Qs + kH * kRow;                             // [2][kTile][kRow]
  bf16* Ps = KV + 2 * kTile * kRow;                      // [kH][kPRow]
  float* red = reinterpret_cast<float*>(Ps + kH * kPRow);  // [kWarps][kH]
  // the partials, over the consumed tiles: [kH][kDV], m [kH], l [kH],
  // the warps' l [kWarps][kH], the merge's weights [kMaxSplit][kH]
  float* po = reinterpret_cast<float*>(smem_raw);
  float* pm = po + kH * kDV;
  float* pl = pm + kH;
  float* lw = pl + kH;
  float* wt = lw + kWarps * kH;

  const int split = blockIdx.x, n_split = gridDim.x, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Piece pc = split_span(pos[b], C, split, n_split);
  const int n_tiles = (pc.len + kTile - 1) / kTile;
  const bf16* rbase = ring + b * rb;

  auto issue = [&](int t, int stage) {
    bf16* ks = KV + stage * kTile * kRow;
    const int o0 = t * kTile;
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int jj = i / kChunks, c = i % kChunks;
      const bool ok = o0 + jj < pc.len;
      const int js = ok ? pc.slot(o0 + jj, C) : pc.first;
      cp_async16(ks + jj * kRow + c * 8, rbase + js * rc + c * 8, ok);
    }
  };

  if (n_tiles > 0) {   // q travels with the first tile
    issue(0, 0);
    for (int i = tid; i < kH * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      cp_async16(Qs + r * kRow + c * 8, q + b * qb + min(r, H - 1) * qh + c * 8,
                 r < H);
    }
  }
  cp_async_commit();

  // this lane's rows of the m16n8 accumulators: r and r + 8
  const int r0 = lane / 4;
  float o[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
  float l[2] = {0.f, 0.f};   // this lane's share of its warp's row sums

  int stage = 0;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) issue(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // q and tile t have landed
    __syncthreads();
    const bf16* ks = KV + stage * kTile * kRow;
    const int n_mine = min(kTile, pc.len - t * kTile);

    // scores of the 16 heads against slots 8w .. 8w + 7 of the tile
    float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 6
    for (int kk = 0; kk < kKSteps; kk += 2) {
      uint32_t qa0[4], qa1[4], kb4[4];
      ldmatrix_x4(qa0, Qs + (lane & 15) * kRow + kk * 16 + (lane >> 4) * 8);
      ldmatrix_x4(qa1, Qs + (lane & 15) * kRow + (kk + 1) * 16 + (lane >> 4) * 8);
      ldmatrix_x4(kb4, ks + (warp * 8 + (lane & 7)) * kRow + kk * 16 + (lane >> 3) * 8);
      mma_bf16_16816(sa, qa0, kb4[0], kb4[1]);
      mma_bf16_16816(sb, qa1, kb4[2], kb4[3]);
    }
    // element e: row r0 + 8 (e / 2), slot 8 warp + 2 (lane % 4) + e % 2
    float x[4], mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = warp * 8 + 2 * (lane & 3) + (e & 1);
      x[e] = j < n_mine ? (sa[e] + sb[e]) * scale : -INFINITY;   // past the piece
      mt[e >> 1] = fmaxf(mt[e >> 1], x[e]);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 1));
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 2));
    }
    if ((lane & 3) == 0) {
      red[warp * kH + r0] = mt[0];
      red[warp * kH + r0 + 8] = mt[1];
    }
    __syncthreads();   // every warp's maxima
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float tm = red[r0 + 8 * rr];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) tm = fmaxf(tm, red[w * kH + r0 + 8 * rr]);
      const float m_new = fmaxf(m[rr], tm);
      alpha[rr] = expf(m[rr] - m_new);
      m[rr] = m_new;
      l[rr] *= alpha[rr];
    }
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = expf(x[e] - m[e >> 1]);
      l[e >> 1] += p[e];
    }
    const int pc0 = warp * 8 + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(Ps + r0 * kPRow + pc0) = pack_bf16x2(p[0], p[1]);
    *reinterpret_cast<uint32_t*>(Ps + (r0 + 8) * kPRow + pc0) = pack_bf16x2(p[2], p[3]);
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    __syncthreads();   // P is whole

    // O += P V over this warp's columns
#pragma unroll
    for (int kj = 0; kj < kTile / 16; ++kj) {
      uint32_t pa[4];
      ldmatrix_x4(pa, Ps + (lane & 15) * kPRow + kj * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < kCols / 8; n += 2) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, ks + (kj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow
                                   + warp * kCols + n * 8 + (lane >> 4) * 8);
        mma_bf16_16816(o[n], pa, vb4[0], vb4[1]);
        mma_bf16_16816(o[n + 1], pa, vb4[2], vb4[3]);
      }
    }
    __syncthreads();   // the stage, P and the maxima are consumed
    stage ^= 1;
  }

  // this block's partial, over its own consumed tiles
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) {
    const int c = warp * kCols + n * 8 + 2 * (lane & 3);
    *reinterpret_cast<float2*>(po + r0 * kDV + c) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(po + (r0 + 8) * kDV + c) = make_float2(o[n][2], o[n][3]);
  }
  if ((lane & 3) == 0) {
    lw[warp * kH + r0] = l[0];
    lw[warp * kH + r0 + 8] = l[1];
    if (warp == 0) {
      pm[r0] = m[0];
      pm[r0 + 8] = m[1];
    }
  }
  __syncthreads();
  if (tid < kH) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += lw[w * kH + tid];
    pl[tid] = s;
  }

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every block's partial is in its shared memory
  if (tid < kH) {   // head tid's weight for each block's partial
    float mj[kMaxSplit], M = REPRO_NEG_INF;
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j) {
      mj[j] = j < n_split ? cluster.map_shared_rank(pm, j)[tid] : REPRO_NEG_INF;
      M = fmaxf(M, mj[j]);
    }
    float den = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j) {
      if (j < n_split) {
        mj[j] = expf(mj[j] - M);
        den += mj[j] * cluster.map_shared_rank(pl, j)[tid];
      }
    }
    const float inv = 1.f / ((den == 0.f) ? 1.f : den);
    for (int j = 0; j < n_split; ++j) wt[j * kH + tid] = mj[j] * inv;
  }
  __syncthreads();
  const int width = kDV / n_split, c0 = split * width;
  for (int i = tid; i < H * (width / 2); i += kThreads) {
    const int r = i / (width / 2), c = c0 + 2 * (i % (width / 2));
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(
          cluster.map_shared_rank(po, j) + r * kDV + c);
      const float w = wt[j * kH + r];
      a0 += w * v.x;
      a1 += w * v.y;
    }
    store2(out + ((int64_t)b * H + r) * kDV + c, a0, a1);
  }
  cluster.sync();   // no block leaves while another reads its partial
}

int n_splits(int C) {
  int n = kMaxSplit;
  while (n > C) n /= 2;
  return n;
}

}  // namespace

// q: (B, H, 576) bf16 with a contiguous last dimension (strides q_b, q_h in
// elements), H <= 16; ring: one layer's latent ring (B, C, 576) bf16 with a
// contiguous last dimension (strides r_b, r_c); every base pointer and
// stride a multiple of 16 bytes (the wrapper checks); pos: (B,) int32, the
// current token's position, whose latent is already in slot pos % C; out:
// (B, H, 512) bf16 contiguous.
extern "C" int repro_mla_decode(const void* q, const void* ring, const void* pos,
                                void* out, int B, int H, int C, int64_t q_b,
                                int64_t q_h, int64_t r_b, int64_t r_c,
                                float scale, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (H < 1 || H > kH || C < 1) return (int)cudaErrorInvalidValue;
  auto kern = mla_latent_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  const int n_split = n_splits(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, 1, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n_split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, (const bf16*)q, (const bf16*)ring,
                         (const int*)pos, (bf16*)out, H, C, q_b, q_h, r_b, r_c,
                         scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
