// Paged attention over a block-table-indexed KV pool, for sm_90a.
//
// Replaces the TPU kernel quintnet_tpu/ops/paged_attention.py::_kernel
// (launched by paged_attention, pallas_call at :318) in all its variants:
// pools stored as float32, bfloat16, float8_e4m3 or int8; the scaled
// variant that multiplies each loaded row by its block's per-head scale;
// and the fresh-K/V override that reads the current run's exact float32
// K/V instead of the pool for positions [start, start + P).
//
// What it computes, per row s, query head h and query i < P:
//   o[s,h,i,:] = softmax_t( q[s,h,i,:] . K[s,t,:] / sqrt(D) ) @ V[s,t,:]
// over the row's positions t <= starts[s] + i, where
//   K[s,t,:] = fresh_k[s, kvh, t - start, :]            if fresh and 0 <= t - start < P
//            = float(k_pool[slot, kvh, :]) * k_scale[blk, kvh]   if scaled
//            = float(k_pool[slot, kvh, :])                       otherwise,
// blk = tables[s, t / bs], slot = blk * bs + t % bs, kvh = h / (Hq / Hkv);
// V likewise. q, o, the scales, the fresh run and all the math are f32;
// only the pools are narrow.
//
// Layout. The TPU kernel assembled the whole row in VMEM and did all of
// its math on the last step of an in-order grid. Here blocks run in
// parallel and in no order, and a whole-row f32 K+V (6 MB at T = 1024,
// 12 heads, D = 64) is far past a block's 227 KB of shared memory. So
// each block reads its own table row and start, walks live table slots
// and keeps the online softmax (running max, running sum, output
// accumulators) on chip; O is written once, by one block, with no atomics
// (two launches give bitwise-equal outputs). Table slots past min((start +
// last query) / bs, M - 1) are never read -- the same clamp as the TPU
// index map -- so only live blocks move and pad queries past the table
// stay in bounds. The TPU kernel's fresh-K/V override was a one-hot matmul
// (a way around a VMEM gather); here each position's source row (pool
// slot or fresh run) is resolved once into shared memory, so the override
// is a per-position choice of address. It covers all P columns, pad
// columns past the tail included, as the TPU kernel does: causality hides
// them from real queries. A scale multiplies the score (K) and the
// probability (V) of its position rather than each loaded value, and the
// running sum takes the unscaled probability; unscaled pools multiply by
// 1.0 in the same places, so fake_quant (all-one scales) and f32 stay
// bit-identical on both paths.
//
// Two paths, picked on the host from the query rows each kv head serves,
// R = P x (Hq / Hkv) (paged_attention_decode_path, no device sync):
//
// * decode (R <= kDecodeRows = 4: decode P = 1, GQA decode up to group 4, the
//   verify shape P = 4 without GQA): paged_decode_split_kernel below,
//   compiled for one query row (plain decode) and for kDecodeRows (the
//   4-row one scores 4 rows where 1 is live: 2-3x the one-row kernel's
//   time at decode on an H100, k4_decode_times.py --variant rows4).
// * prefill (wider; the serve prefills are P >= 16):
//   paged_prefill_3xtf32_kernel below, K1's tensor-core skeleton
//   (flash_attention.cu) with the block-table gather.
//
// Bound: memory on the decode shape, which moves the live K/V positions plus
// q and o and does ~4 * D flops per 2 * D stored values read (a narrow pool
// moves fewer bytes for the same flops): at 8 rows of contexts up to 1,024,
// 12 heads, D = 64 in f32 that is ~17 MB, ~5 us at 3.35 TB/s. A prefill of
// P queries does ~P/2 times more flops per byte: from P of a few hundred on
// it is bound by operations, for f32-accurate products by 3xTF32 on the
// tensor cores (495 / 3 = 165 TFLOP/s; P = 1,024 at 12 heads and D = 64 is
// 1.6 GFLOP, ~10 us).
//
// The prefill path replaces the TPU kernel at its prefill shape (a row of P
// tail queries). The first port's kernel for it scored with scalar FMAs from
// shared memory, restaged K/V for every 16 queries and every query head, and
// ran 2.1x slower than SDPA at P = 1,024 on an H100. Now:
//   * A block (128 threads) owns 64 rows (4 warps x 16), a row being a
//     (query head of the kv head's group, query) pair, r = i * G + g, so
//     under GQA one staged K/V tile serves the whole group. Row tiles run
//     longest causal range first.
//   * Keys stream through a two-stage ring in tiles of 64 positions (32 at
//     D > 64, for registers) up to the tile's last visible position. Each
//     tile's sources and scales are resolved into shared memory two tiles
//     ahead. The next tile is in flight by cp.async while the current one
//     computes: f32 rows (an f32 pool, the fresh run) straight into the
//     ring; a narrow pool's rows as stored, 16 bytes a lane (4 values where
//     D or the pools' alignment forbid 16 bytes), into a raw buffer, widened
//     to f32 into the ring once they land. (Holding them in registers across
//     the products instead spilled at D = 64 and 128: the products use all
//     255 registers.)
//   * S = q k^T and O += P V run in 3xTF32 on mma.sync.m16n8k8 (each f32
//     operand split big + small, three products a step; plain TF32 misses
//     the 1e-4 gate), with K1's fragment loaders and its online softmax on
//     the accumulator fragments (masked scores -1e30 in natural-log units;
//     only tiles that cross the causal diagonal or the live range's end
//     mask). P feeds P V from registers (acc_as_a).
//   * Filling the card: a serve prefill is one row (S = 1) of 12 heads, so
//     P = 1,024 makes 16 row tiles a head whose key ranges run from 1 to 16
//     tiles. From P alone (the host never reads starts) the key tiles of a
//     row tile are dealt to up to 4 splits, tile u to split u % n, enough
//     that a split of the longest tile at start 0 takes at most 4 of them
//     (P > 256 at D <= 64): the splits of a row tile form a thread-block
//     cluster, leave their partial (m, l, unnormalised o) in shared memory
//     and combine them through distributed shared memory in split order,
//     one writer per output, no atomics, bitwise-reproducible. P = 1,024
//     takes 0.10 ms instead of 0.12 unsplit, on an H100
//     (k4_decode_times.py --path prefill).
//   * Head dims: mma needs D in steps of 8 and the wrapper takes any
//     multiple of 4 up to 128, so the kernel is built for D rounded up to
//     8, 16, 32, 64 or 128, with zero columns past D, and writes D columns.
//   * Launch bounds of one block, so the compiler may use 255 registers
//     (K1-K3's rule); the o accumulator alone is 64 floats at D = 128.
//
// The decode path splits each row's context (flash-decoding):
//   * Grid (splits, Hkv, S), one thread block per (row, kv head, split); the
//     block serves every query row that reads its kv head (Hq / Hkv heads x
//     P queries), so under GQA each K/V position is loaded once, not once
//     per query head. The split count comes from the table width W = M x bs
//     alone (never from starts, which would need a copy to the host):
//     splits = ceil(W / 64) rounded up to a power of two, at most 8; W =
//     1,024 gives 8, so a decode step of 8 rows x 12 kv heads launches 768
//     blocks for the 132 SMs instead of 96. A row's live positions
//     [0, min(start + P, W)) are dealt to its splits in units of 16, unit u
//     to split u % splits, so every split of a row has work once the row
//     holds splits x 16 positions: a contiguous cut (split j taking
//     [j W / splits, (j + 1) W / splits)) left 5 of 8 splits idle at the
//     serve step's ~300-position rows, holding their SM slots until the
//     cluster's combine (f32 1.2x the tiled kernel's time there on an H100,
//     k4_decode_times.py). A split with no position does no work and reports
//     m = -inf, l = 0.
//   * The splits of one (row, kv head) form a thread-block cluster (Hopper,
//     cudaLaunchKernelEx). Each block leaves its partial (m, l, unnormalised
//     o per query row) in its shared memory; after cluster.sync() the blocks
//     read each other's partials through distributed shared memory and each
//     combines a share of the outputs, always in split order 0, 1, ..., so
//     two launches give bitwise-equal outputs. One launch, no workspace, no
//     atomics; a second cluster.sync() keeps every block's shared memory
//     alive until the others have read it.
//   * Inside a block (128 threads) K/V are read in the store type, 16 bytes
//     a lane (4 f32, 8 bf16, 16 fp8 or int8 values; 4 values a lane where D
//     does not allow 16 bytes or the pools are not 16-byte aligned), widened
//     and scaled in registers where the dot product and the P V update use
//     them: no f32 staging pass. L lanes (D / values per lane, rounded up to
//     a power of two) share one position, so a warp takes 32 / L positions at
//     a time and reduces a score over its L lanes with shuffles; the q rows
//     live in registers, as does each lane's share of o. Four positions'
//     loads of a lane are in flight before any is used.
//   * Positions come in chunks of 256: the chunk's per-position source (pool
//     block, or the fresh run's row) and scales are resolved once into shared
//     memory, so the fresh-K/V override is a per-position choice of source
//     row, not a per-element branch; then the scores of the chunk, one warp
//     per query row for the running max and sum, and P V. Three barriers a
//     chunk, and a decode split of 128 positions is one chunk. A scale
//     multiplies the score (K) and the probability (V) of its position
//     rather than each loaded value; unscaled pools multiply by 1.0 in the
//     same places, so fake_quant (all-one scales) and f32 stay bit-identical.
//   * Exponentials are exp2f on scores pre-scaled by log2(e) / sqrt(D).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kMaxHeadDim = 128;  // both paths

// ---------------------------------------------------------------------------
// decode path: split-KV, the splits of one (row, kv head) in one cluster

namespace cg = cooperative_groups;

constexpr int kDecodeRows = 4;     // query rows per kv head the decode path takes
constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr int kSplitMin = 64;      // table positions per split at least
constexpr int kSplitUnit = 16;     // positions dealt to a split at a time
constexpr int kDecChunk = 256;     // positions resolved and scored per step
constexpr int kInFlight = 4;       // positions a lane loads before using them
static_assert(kDecodeRows <= kDecWarps, "one warp per query row in the softmax");

// ceil(width / kSplitMin) rounded up to a power of two, at most kMaxSplits
int decode_splits(int width) {
  int n = 1;
  while (n < kMaxSplits && n * kSplitMin < width) n <<= 1;
  return n;
}

// VEC consecutive stored values (16, 8 or 4 bytes) as 32-bit words
template <typename T, int VEC>
struct Raw {
  static constexpr int kWords = VEC * (int)sizeof(T) / 4;
  uint32_t w[kWords];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_raw(Raw<T, VEC>& r, const T* p) {
  constexpr int W = Raw<T, VEC>::kWords;
  if constexpr (W == 4) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = x.x;
    r.w[1] = x.y;
    r.w[2] = x.z;
    r.w[3] = x.w;
  } else if constexpr (W == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = x.x;
    r.w[1] = x.y;
  } else {
    r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// one 32-bit word of stored values -> f32 (1 f32, 2 bf16, 4 fp8 or int8)
template <typename T>
__device__ __forceinline__ void widen_word(uint32_t w, float* f);

template <>
__device__ __forceinline__ void widen_word<float>(uint32_t w, float* f) {
  f[0] = __uint_as_float(w);
}

template <>
__device__ __forceinline__ void widen_word<__nv_bfloat16>(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

template <>
__device__ __forceinline__ void widen_word<__nv_fp8_e4m3>(uint32_t w, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_fp8_e4m3 e;
    e.__x = static_cast<__nv_fp8_storage_t>((w >> (8 * i)) & 0xffu);
    f[i] = static_cast<float>(e);
  }
}

template <>
__device__ __forceinline__ void widen_word<int8_t>(uint32_t w, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}

template <typename T, int VEC>
__device__ __forceinline__ void widen(const Raw<T, VEC>& r, float (&f)[VEC]) {
  constexpr int kPer = 4 / (int)sizeof(T);
#pragma unroll
  for (int i = 0; i < Raw<T, VEC>::kWords; ++i) widen_word<T>(r.w[i], f + i * kPer);
}

template <int VEC>
__device__ __forceinline__ void load_f32(float (&f)[VEC], const float* p) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    f[i] = x.x;
    f[i + 1] = x.y;
    f[i + 2] = x.z;
    f[i + 3] = x.w;
  }
}

// One block per (split, kv head, row): the rows (R >= rows = P x Hq / Hkv,
// row r = query r % P of head kvh * G + r / P) over this split's share of the
// row's live context (units of kSplitUnit positions dealt round-robin to the
// splits), then the cluster's fixed-order combine.
template <typename T, int R, int VEC>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_split_kernel(const float* __restrict__ q, const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool, const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale, const float* __restrict__ fresh_k,
                          const float* __restrict__ fresh_v, const int* __restrict__ tables,
                          const int* __restrict__ starts, float* __restrict__ out, int Hq,
                          int Hkv, int P, int D, int M, int bs, float scale_log2) {
  __shared__ int src_s[kDecChunk];                  // pool slot, or -1 - row of the fresh run
  __shared__ float sk_s[kDecChunk], sv_s[kDecChunk];  // the position's K and V scale
  __shared__ float sc_s[R][kDecChunk];              // scores (log2 units), then probabilities
  __shared__ float red_s[kDecWarps][R][kMaxHeadDim];
  // this split's partial, read by the whole cluster: running max (log2
  // units), running sum, unnormalised o
  __shared__ float part_m[R], part_l[R], corr_s[R];
  __shared__ float part_o[R][kMaxHeadDim];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank(), n_split = gridDim.x;  // one cluster spans x
  const int kvh = blockIdx.y, s = blockIdx.z;
  const int G = Hq / Hkv;
  const int rows = G * P;
  const int start = starts[s];
  const int* trow = tables + (size_t)s * M;
  // this split's positions: unit u of the live context [0, end) goes to
  // split u % n_split, so every split of a row gets an equal share (to a
  // unit) and a split past the row's last unit has none
  const int end = min(start + P, M * bs);
  const int round = kSplitUnit * n_split;
  const int n_mine = end / round * kSplitUnit +
                     min(max(end % round - split * kSplitUnit, 0), kSplitUnit);
  auto pos_of = [&](int j) {  // the split's j-th position
    return (j / kSplitUnit * n_split + split) * kSplitUnit + j % kSplitUnit;
  };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  // L lanes share a position, lane c of them holding values c*VEC .. c*VEC+VEC-1
  const int C = D / VEC;
  int L = 1;
  while (L < C) L <<= 1;
  const int c = lane & (L - 1);
  const int npw = 32 / L;
  const int gw = lane / L, groups = kDecWarps * npw, gid = warp * npw + gw;
  const bool lane_on = c < C;
  const size_t fresh_off = ((size_t)s * Hkv + kvh) * P * D + c * VEC;
  const size_t pool_off = (size_t)kvh * D + c * VEC;

  float qr[R][VEC], oacc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[r][e] = oacc[r][e] = 0.f;
    if (r < rows && lane_on)
      load_f32(qr[r], q + (((size_t)s * Hq + kvh * G + r / P) * P + r % P) * D + c * VEC);
  }
  if (tid < R) {
    part_m[tid] = -INFINITY;
    part_l[tid] = 0.f;
  }

  for (int c0 = 0; c0 < n_mine; c0 += kDecChunk) {
    const int n = min(kDecChunk, n_mine - c0);
    // each position's source row and scales, once
    for (int i = tid; i < n; i += kDecThreads) {
      const int t = pos_of(c0 + i), rel = t - start;
      if (fresh_k != nullptr && rel >= 0 && rel < P) {
        src_s[i] = -1 - rel;
        sk_s[i] = sv_s[i] = 1.f;
      } else {
        const int blk = trow[t / bs];
        src_s[i] = blk * bs + t % bs;
        sk_s[i] = k_scale != nullptr ? k_scale[(size_t)blk * Hkv + kvh] : 1.f;
        sv_s[i] = v_scale != nullptr ? v_scale[(size_t)blk * Hkv + kvh] : 1.f;
      }
    }
    __syncthreads();

    // scores of positions c0 + b + gid + groups * u, reduced over the L lanes
    for (int b = 0; b < n; b += groups * kInFlight) {
      Raw<T, VEC> raw[kInFlight];
      int src[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = b + gid + groups * u;
        src[u] = i < n ? src_s[i] : INT_MIN;
        if (lane_on && src[u] >= 0)
          load_raw(raw[u], k_pool + (size_t)src[u] * Hkv * D + pool_off);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = b + gid + groups * u;
        float kf[VEC];
        if (lane_on && src[u] >= 0) {
          widen(raw[u], kf);
        } else if (lane_on && src[u] != INT_MIN) {
          load_f32(kf, fresh_k + fresh_off + (size_t)(-1 - src[u]) * D);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[e] = 0.f;
        }
        float d[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          d[r] = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d[r] = fmaf(qr[r][e], kf[e], d[r]);
          for (int o = L / 2; o > 0; o >>= 1) d[r] += __shfl_xor_sync(0xffffffffu, d[r], o);
        }
        if (c == 0 && i < n) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < rows)
              sc_s[r][i] = pos_of(c0 + i) <= start + r % P ? d[r] * sk_s[i] * scale_log2
                                                           : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per query row
    if (warp < rows) {
      const int r = warp;
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sc_s[r][j]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = part_m[r];
      const float m_new = fmaxf(m_old, mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float x = sc_s[r][j];
        const float p = x == -INFINITY ? 0.f : exp2f(x - base);
        sc_s[r][j] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float cr = m_old == -INFINITY ? 0.f : exp2f(m_old - base);
        corr_s[r] = cr;
        part_l[r] = part_l[r] * cr + sum;
        part_m[r] = m_new;
      }
    }
    __syncthreads();

    // o = o corr + sum_t p_t v_t, the V scale folded into p
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        const float cr = corr_s[r];
#pragma unroll
        for (int e = 0; e < VEC; ++e) oacc[r][e] *= cr;
      }
    }
    for (int b = 0; b < n; b += groups * kInFlight) {
      Raw<T, VEC> raw[kInFlight];
      int src[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = b + gid + groups * u;
        src[u] = i < n ? src_s[i] : INT_MIN;
        if (lane_on && src[u] >= 0)
          load_raw(raw[u], v_pool + (size_t)src[u] * Hkv * D + pool_off);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = b + gid + groups * u;
        if (!lane_on || src[u] == INT_MIN) continue;
        float vf[VEC];
        if (src[u] >= 0)
          widen(raw[u], vf);
        else
          load_f32(vf, fresh_v + fresh_off + (size_t)(-1 - src[u]) * D);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) {
            const float p = sc_s[r][i] * sv_s[i];
#pragma unroll
            for (int e = 0; e < VEC; ++e) oacc[r][e] = fmaf(p, vf[e], oacc[r][e]);
          }
        }
      }
    }
    __syncthreads();  // this chunk's readers are done before the next is resolved
  }

  // o over the position groups of a warp (shuffles), then over the warps in
  // warp order
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      for (int o = L; o < 32; o <<= 1) oacc[r][e] += __shfl_xor_sync(0xffffffffu, oacc[r][e], o);
  if (gw == 0 && lane_on) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < rows)
#pragma unroll
        for (int e = 0; e < VEC; ++e) red_s[warp][r][c * VEC + e] = oacc[r][e];
  }
  __syncthreads();
  for (int x = tid; x < rows * D; x += kDecThreads) {
    const int r = x / D, d = x - r * D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) acc += red_s[w][r][d];
    part_o[r][d] = acc;
  }

  // the cluster's partials combined in split order; each block writes a
  // share. All of an output's remote reads are issued before any is used.
  cluster.sync();
  for (int x = split * kDecThreads + tid; x < rows * D; x += n_split * kDecThreads) {
    const int r = x / D, d = x - r * D;
    float mj[kMaxSplits], lj[kMaxSplits], oj[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      if (j < n_split) {
        mj[j] = *cluster.map_shared_rank(&part_m[r], j);
        lj[j] = *cluster.map_shared_rank(&part_l[r], j);
        oj[j] = *cluster.map_shared_rank(&part_o[r][d], j);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < n_split) mx = fmaxf(mx, mj[j]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      if (j < n_split) {
        const float w = mj[j] == -INFINITY ? 0.f : exp2f(mj[j] - mx);
        num = fmaf(w, oj[j], num);
        den = fmaf(w, lj[j], den);
      }
    }
    out[(((size_t)s * Hq + kvh * G + r / P) * P + r % P) * D + d] = num / den;
  }
  cluster.sync();  // every block's partial stays readable until the combine is done
}

template <typename T, int R, int VEC>
int launch_decode(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                  const void* v_scale, const void* fresh_k, const void* fresh_v,
                  const void* tables, const void* starts, void* out, int S, int Hq, int Hkv,
                  int P, int D, int M, int block_size, void* stream) {
  const int width = M * block_size;
  const int n_split = decode_splits(width);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, Hkv, S);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, paged_decode_split_kernel<T, R, VEC>, static_cast<const float*>(q),
      static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const float*>(fresh_k), static_cast<const float*>(fresh_v),
      static_cast<const int*>(tables), static_cast<const int*>(starts), static_cast<float*>(out),
      Hq, Hkv, P, D, M, block_size, 1.4426950408889634f / sqrtf((float)D));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// 16-byte loads where D and the pools' alignment allow them, else 4 values a
// lane; one query row (plain decode) or up to kDecodeRows
template <typename T>
int launch_decode_any(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                      const void* v_scale, const void* fresh_k, const void* fresh_v,
                      const void* tables, const void* starts, void* out, int S, int Hq, int Hkv,
                      int P, int D, int M, int block_size, void* stream) {
  constexpr int kWide = 16 / (int)sizeof(T);
  const bool wide = D % kWide == 0 &&
                    ((reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool)) %
                     16) == 0;
  const bool one = P * (Hq / Hkv) == 1;
#define QN_DECODE(R, VEC)                                                                      \
  return launch_decode<T, R, VEC>(q, k_pool, v_pool, k_scale, v_scale, fresh_k, fresh_v, tables, \
                                  starts, out, S, Hq, Hkv, P, D, M, block_size, stream)
  if (wide) {
    if (one) QN_DECODE(1, kWide);
    QN_DECODE(kDecodeRows, kWide);
  }
  if (one) QN_DECODE(1, 4);
  QN_DECODE(kDecodeRows, 4);
#undef QN_DECODE
}

// ---------------------------------------------------------------------------
// prefill path: 3xTF32 on the tensor cores (K1's skeleton over the block table)

constexpr int kPreRows = 64;       // query rows a block owns: 4 warps x 16
constexpr int kNoKey = INT_MIN;    // a key position past the tile's live range
constexpr int kPreSplits = 4;      // key splits of a row tile at most (one cluster)
constexpr int kPreSplitTiles = 4;  // key tiles a split takes before P asks for another

// key positions a stage holds: 64, 32 at DP = 128 to stay within 255
// registers (K1's rule)
template <int DP>
__host__ __device__ constexpr int prefill_keys() {
  return DP == 128 ? 32 : 64;
}

template <typename T, int DP>
struct PrefillSmem {
  static constexpr int LD = DP + kPad;
  static constexpr int BK = prefill_keys<DP>();
  static constexpr int kStage = 2 * BK * LD;  // k, v (floats)
  // a narrow pool's K and V rows of the tile in flight, as stored
  static constexpr int kRawBytes = sizeof(T) < 4 ? 2 * BK * DP * (int)sizeof(T) : 0;
  // q [64][LD]; two stages; three slots of each position's source and
  // scales; the raw rows
  static constexpr size_t bytes =
      4 * ((size_t)kPreRows * LD + 2 * (size_t)kStage + 9 * BK) + kRawBytes;
};

// Key splits of a row tile, from P alone (the host never reads starts):
// enough that a split of the longest tile at start 0 takes at most
// kPreSplitTiles key tiles, at most kPreSplits
template <int DP>
int prefill_splits(int P) {
  const int key_tiles = (P + prefill_keys<DP>() - 1) / prefill_keys<DP>();
  const int n = (key_tiles + kPreSplitTiles - 1) / kPreSplitTiles;
  return n < kPreSplits ? n : kPreSplits;
}

// One cluster of n_split blocks per (tile of 64 query rows, kv head, row
// s). The tile's rows are (query head of the group, query) pairs, row r =
// query r / G of head kvh * G + r % G, so under GQA a staged K/V tile
// serves the whole group. Keys stream in stages of BK positions up to the
// tile's last visible one, key tile u to split u % n_split; with more than
// one split each block leaves its partial (m, l, unnormalised o) in shared
// memory and the cluster combines them in split order. DP is D rounded up
// to 8, 16, 32, 64 or 128 (columns past D are zero).
template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads, 1)
paged_prefill_3xtf32_kernel(const float* __restrict__ q, const T* __restrict__ k_pool,
                            const T* __restrict__ v_pool, const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale, const float* __restrict__ fresh_k,
                            const float* __restrict__ fresh_v, const int* __restrict__ tables,
                            const int* __restrict__ starts, float* __restrict__ out, int Hq,
                            int Hkv, int P, int D, int M, int bs, int wide, int n_split,
                            float scale) {
  using L = PrefillSmem<T, DP>;
  constexpr int LD = L::LD, BK = L::BK, NT = BK / 8;
  constexpr bool kNarrow = sizeof(T) < 4;
  extern __shared__ float smem[];
  float* q_s = smem;                                            // [64][LD]
  float* ring = q_s + kPreRows * LD;                            // 2 stages: k, v [BK][LD]
  int* src_s = reinterpret_cast<int*>(ring + 2 * L::kStage);    // [3][BK]
  float* sk_s = reinterpret_cast<float*>(src_s + 3 * BK);       // [3][BK]
  float* sv_s = sk_s + 3 * BK;                                  // [3][BK]
  T* raw_s = reinterpret_cast<T*>(sv_s + 3 * BK);               // [2][BK][DP], narrow pools

  cg::cluster_group cluster = cg::this_cluster();
  const int G = Hq / Hkv, RT = G * P;
  const int tiles = (RT + kPreRows - 1) / kPreRows;
  // one cluster spans x: n_split blocks, one per split of the row tile
  const int split = (int)cluster.block_rank();
  const int r0 = (tiles - 1 - (int)blockIdx.x / n_split) * kPreRows;  // longest rows first
  const int kvh = blockIdx.y, s = blockIdx.z;
  const int start = starts[s];
  const int* trow = tables + (size_t)s * M;
  // keys up to the tile's last query, never past the table (the TPU index
  // map's clamp): table slots past min((start + last) / bs, M - 1) are not read
  const int i_lo = r0 / G, i_hi = (min(r0 + kPreRows, RT) - 1) / G;
  const int n_keys = min(start + i_hi + 1, M * bs);
  // this split's key tiles: its u-th is split + u * n_split
  const int nk = (n_keys + BK - 1) / BK;
  const int my_nk = nk > split ? (nk - split + n_split - 1) / n_split : 0;
  auto key_tile = [&](int u) { return split + u * n_split; };
  const int tid = threadIdx.x, warp = tid / 32, g = (tid & 31) / 4, t = tid & 3;
  const int qw = warp * 16;  // the warp's first row in the tile
  const size_t fresh_off = ((size_t)s * Hkv + kvh) * P * D;
  auto q_row = [&](int r) {  // offset of tile row r (< RT) in q and out
    return (((size_t)s * Hq + kvh * G + r % G) * P + r / G) * D;
  };

  // each position's source: pool slot, -1 - its row in the fresh run, or
  // kNoKey past the live range; and its K and V scale (1 when unscaled)
  auto resolve = [&](int kt, int slot) {
    for (int j = tid; j < BK; j += kMmaThreads) {
      const int tk = kt * BK + j, rel = tk - start;
      int src = kNoKey;
      float ks = 1.f, vs = 1.f;
      if (tk < n_keys) {
        if (fresh_k != nullptr && rel >= 0 && rel < P) {
          src = -1 - rel;
        } else {
          const int blk = trow[tk / bs];
          src = blk * bs + tk % bs;
          if (k_scale != nullptr) {
            ks = k_scale[(size_t)blk * Hkv + kvh];
            vs = v_scale[(size_t)blk * Hkv + kvh];
          }
        }
      }
      src_s[slot * BK + j] = src;
      sk_s[slot * BK + j] = ks;
      sv_s[slot * BK + j] = vs;
    }
  };

  // a key tile's rows in flight by cp.async: f32 rows (an f32 pool, the
  // fresh run) and empty ones (zero) straight into the stage; a narrow
  // pool's rows as stored into raw_s, 16 bytes a lane (4 values where D or
  // the pools' alignment forbid 16 bytes), for widen()
  constexpr int kWideVals = 16 / (int)sizeof(T);
  auto issue = [&](int kt, int stage, int slot) {
    float* kd = ring + stage * L::kStage;
    const int* src = src_s + slot * BK;
    const int k0 = kt * BK;
    constexpr int kCpr = DP / 4;  // 16-byte f32 chunks a row, those past D skipped
    // with a narrow pool only a tile holding fresh or empty positions has f32 rows
    const bool other = (fresh_k != nullptr && k0 < start + P && k0 + BK > start) ||
                       k0 + BK > n_keys;
    if (!kNarrow || other) {
      for (int i = tid; i < 2 * BK * kCpr; i += kMmaThreads) {
        const int kv = i / (BK * kCpr), jc = i - kv * BK * kCpr;
        const int j = jc / kCpr, col = (jc - j * kCpr) * 4;
        if (col >= D) continue;
        const int sj = src[j];
        float* dst = kd + kv * BK * LD + j * LD + col;
        if (sj >= 0) {
          if constexpr (!kNarrow)
            cp_async16(dst, (kv ? v_pool : k_pool) + ((size_t)sj * Hkv + kvh) * D + col, 16);
        } else if (sj != kNoKey) {
          cp_async16(dst, (kv ? fresh_v : fresh_k) + fresh_off + (size_t)(-1 - sj) * D + col, 16);
        } else {
          cp_async16(dst, q, 0);
        }
      }
    }
    if constexpr (kNarrow) {
      const int vals = wide ? kWideVals : 4;  // values a lane
      const int cpr = DP / vals;
      for (int i = tid; i < 2 * BK * cpr; i += kMmaThreads) {
        const int kv = i / (BK * cpr), jc = i - kv * BK * cpr;
        const int j = jc / cpr, col = (jc - j * cpr) * vals;
        const int sj = src[j];
        if (col >= D || sj < 0) continue;
        T* dst = raw_s + (kv * BK + j) * DP + col;
        const T* from = (kv ? v_pool : k_pool) + ((size_t)sj * Hkv + kvh) * D + col;
        if (wide)
          cp_async16(dst, from, 16);
        else if constexpr (sizeof(T) == 2)
          cp_async8(dst, from);
        else
          cp_async4(dst, from, 4);
      }
    }
  };

  // a narrow pool's rows of the tile, from raw_s widened to f32 into the
  // stage: 16 bytes a lane (8 where a row is narrower), values past D left
  auto widen = [&](int stage, int slot) {
    if constexpr (kNarrow) {
      constexpr int kPer = 4 / (int)sizeof(T);  // values a 32-bit word
      constexpr int kVals = DP < kWideVals ? DP : kWideVals;
      constexpr int kWords = kVals / kPer, kCw = DP / kVals;
      float* kd = ring + stage * L::kStage;
      const int* src = src_s + slot * BK;
      for (int i = tid; i < 2 * BK * kCw; i += kMmaThreads) {
        const int kv = i / (BK * kCw), jc = i - kv * BK * kCw;
        const int j = jc / kCw, col = (jc - j * kCw) * kVals;
        if (col >= D || src[j] < 0) continue;
        const T* from = raw_s + (kv * BK + j) * DP + col;
        uint32_t w[kWords];
        if constexpr (kWords == 4) {
          const uint4 x = *reinterpret_cast<const uint4*>(from);
          w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
        } else {
          const uint2 x = *reinterpret_cast<const uint2*>(from);
          w[0] = x.x, w[1] = x.y;
        }
        float f[kVals];
#pragma unroll
        for (int e = 0; e < kWords; ++e) widen_word<T>(w[e], f + e * kPer);
        float* dst = kd + kv * BK * LD + j * LD + col;
#pragma unroll
        for (int e = 0; e < kVals; e += 4)
          if (col + e < D)
            *reinterpret_cast<float4*>(dst + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      }
    }
  };

  // columns D .. DP-1 of both stages stay zero (no load writes them)
  if (D < DP) {
    for (int i = tid; i < 2 * 2 * BK * (DP - D); i += kMmaThreads) {
      const int row = i / (DP - D);
      ring[row * LD + D + (i - row * (DP - D))] = 0.f;
    }
  }
  // the tile's q rows (zero past the last row and past D), then the first
  // key tile
  for (int i = tid; i < kPreRows * (DP / 4); i += kMmaThreads) {
    const int r = i / (DP / 4), col = (i - r * (DP / 4)) * 4;
    const bool ok = r0 + r < RT && col < D;
    cp_async16(q_s + r * LD + col, ok ? q + q_row(r0 + r) + col : q, ok ? 16 : 0);
  }
  if (my_nk > 0) resolve(key_tile(0), 0);
  if (my_nk > 1) resolve(key_tile(1), 1);
  __syncthreads();
  if (my_nk > 0) issue(key_tile(0), 0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (my_nk > 0) widen(0, 0);

  // rows qw + g and qw + g + 8: their query positions, running max (natural
  // log units), this thread's part of the running sum, the output accumulator
  int pos_r[2];
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) pos_r[h] = start + (r0 + qw + g + 8 * h) / G;
  float o_acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;

  for (int u = 0; u < my_nk; ++u) {
    const int st = u & 1;
    // tile u is in its stage (and widened); the other stage's readers are done
    __syncthreads();
    if (u + 1 < my_nk) {  // the next tile loads while this one computes
      issue(key_tile(u + 1), st ^ 1, (u + 1) % 3);
      cp_async_commit();
      if (u + 2 < my_nk) resolve(key_tile(u + 2), (u + 2) % 3);
    }
    const int k0 = key_tile(u) * BK;
    const float* ks = ring + st * L::kStage;
    const float* vs = ks + BK * LD;
    const float* skr = sk_s + (u % 3) * BK;
    const float* svr = sv_s + (u % 3) * BK;
    float sc[NT][4];  // rows qw + g (+8), key columns
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll 2
    for (int c0 = 0; c0 < DP; c0 += 8) {
      const Frag<4> qa = frag_a<DP>(q_s, qw, c0);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        Frag<2> kb[2];
        frag_b_t2<DP>(ks, 8 * j, c0, kb[0], kb[1]);
        mma_3xtf32(sc[j], qa, kb[0]);
        mma_3xtf32(sc[j + 1], qa, kb[1]);
      }
    }
    // score = q.k x (K scale) / sqrt(D); masked past a row's position and
    // past the live range, only on tiles that cross either
    const bool needs_mask = k0 + BK - 1 > start + i_lo || k0 + BK > n_keys;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = 8 * j + 2 * t + (e & 1);
        float x = sc[j][e] * skr[kl] * scale;
        if (needs_mask && (k0 + kl > pos_r[e >> 1] || k0 + kl >= n_keys)) x = kNegInf;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // online softmax: a row's scores of this tile sit on the 4 lanes of a quad
    float corr[2], neg_m2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      corr[h] = ex2((m_r[h] - m_new) * kLog2e);
      neg_m2[h] = -m_new * kLog2e;
      m_r[h] = m_new;
      l_r[h] *= corr[h];
    }
    // l sums the probabilities; P V takes them times the V scale
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[j][e];
        const float p = x > 0.5f * kNegInf ? ex2(fmaf(x, kLog2e, neg_m2[e >> 1])) : 0.f;
        l_r[e >> 1] += p;
        sc[j][e] = p * svr[8 * j + 2 * t + (e & 1)];
      }
    }
    // o = o corr + p v over this tile's keys: p feeds the product from
    // registers, the tile's NT steps are summed in the tensor core
    Frag<4> pa[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) pa[j] = acc_as_a(sc[j]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      float ot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_3xtf32_tc(ot, pa[j], frag_b_n<DP>(vs, 8 * j, 8 * n, g, t));
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[n][e] = fmaf(o_acc[n][e], corr[e >> 1], ot[e]);
    }
    if (u + 1 < my_nk) {  // the next tile landed: every thread's copies, then widened
      cp_async_wait<0>();
      __syncthreads();
      widen(st ^ 1, (u + 1) % 3);
    }
  }

  // l over the quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
  if (n_split == 1) {
    // every real row sees position 0, so l > 0: o / l into the real rows'
    // first D columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = 1.f / fmaxf(l_r[h], 1e-30f);
      const int r = r0 + qw + g + 8 * h;
      if (r >= RT) continue;
      float* dst = out + q_row(r);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        if (8 * n + 2 * t < D)
          *reinterpret_cast<float2*>(dst + 8 * n + 2 * t) =
              make_float2(o_acc[n][2 * h] * inv, o_acc[n][2 * h + 1] * inv);
    }
    return;
  }

  // this split's partial, read by the whole cluster: unnormalised o over q's
  // rows, running max and sum (a split without key tiles: -1e30, 0, 0)
  float* part_o = q_s;  // [64][LD]
  float* part_m = sk_s;  // [64]
  float* part_l = sv_s;  // [64]
  __syncthreads();  // every warp is done with q_s and the slots
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qw + g + 8 * h;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      *reinterpret_cast<float2*>(part_o + r * LD + 8 * n + 2 * t) =
          make_float2(o_acc[n][2 * h], o_acc[n][2 * h + 1]);
    if (t == 0) {
      part_m[r] = m_r[h];
      part_l[r] = l_r[h];
    }
  }
  // each block combines a share of the rows, the splits in order 0, 1, ...;
  // a row's remote reads are all issued before any is used
  cluster.sync();
  const int share = (kPreRows + n_split - 1) / n_split;
  for (int x = tid; x < share * D; x += kMmaThreads) {
    const int rl = split * share + x / D, d = x % D;
    if (rl >= kPreRows || r0 + rl >= RT) continue;
    float mj[kPreSplits], lj[kPreSplits], oj[kPreSplits];
#pragma unroll
    for (int j = 0; j < kPreSplits; ++j) {
      if (j < n_split) {
        mj[j] = *cluster.map_shared_rank(&part_m[rl], j);
        lj[j] = *cluster.map_shared_rank(&part_l[rl], j);
        oj[j] = *cluster.map_shared_rank(&part_o[rl * LD + d], j);
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kPreSplits; ++j)
      if (j < n_split) mx = fmaxf(mx, mj[j]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int j = 0; j < kPreSplits; ++j) {
      if (j < n_split) {
        const float w = ex2((mj[j] - mx) * kLog2e);
        num = fmaf(w, oj[j], num);
        den = fmaf(w, lj[j], den);
      }
    }
    out[q_row(r0 + rl) + d] = num / den;
  }
  cluster.sync();  // every block's partial stays readable until the combine is done
}

template <typename T, int DP>
int launch_prefill(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                   const void* v_scale, const void* fresh_k, const void* fresh_v,
                   const void* tables, const void* starts, void* out, int S, int Hq, int Hkv,
                   int P, int D, int M, int block_size, void* stream) {
  const size_t smem = PrefillSmem<T, DP>::bytes;
  const cudaError_t e = allow_smem(paged_prefill_3xtf32_kernel<T, DP>, smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int kWideVals = 16 / (int)sizeof(T);
  const bool wide = D % kWideVals == 0 &&
                    ((reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool)) %
                     16) == 0;
  const int n_split = prefill_splits<DP>(P);
  const dim3 grid((P * (Hq / Hkv) + kPreRows - 1) / kPreRows * n_split, Hkv, S);
  const float scale = 1.0f / sqrtf((float)D);
  if (n_split == 1) {  // no cluster to launch
    paged_prefill_3xtf32_kernel<T, DP><<<grid, kMmaThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const float*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), static_cast<const float*>(fresh_k),
        static_cast<const float*>(fresh_v), static_cast<const int*>(tables),
        static_cast<const int*>(starts), static_cast<float*>(out), Hq, Hkv, P, D, M, block_size,
        (int)wide, 1, scale);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_prefill_3xtf32_kernel<T, DP>, static_cast<const float*>(q),
      static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const float*>(fresh_k), static_cast<const float*>(fresh_v),
      static_cast<const int*>(tables), static_cast<const int*>(starts), static_cast<float*>(out),
      Hq, Hkv, P, D, M, block_size, (int)wide, n_split, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// D rounded up to the widths the kernel is built for (columns past D zero)
template <typename T>
int launch_prefill_any(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                       const void* v_scale, const void* fresh_k, const void* fresh_v,
                       const void* tables, const void* starts, void* out, int S, int Hq, int Hkv,
                       int P, int D, int M, int block_size, void* stream) {
#define QN_PREFILL(DP)                                                                       \
  return launch_prefill<T, DP>(q, k_pool, v_pool, k_scale, v_scale, fresh_k, fresh_v, tables, \
                               starts, out, S, Hq, Hkv, P, D, M, block_size, stream)
  if (D <= 8) QN_PREFILL(8);
  if (D <= 16) QN_PREFILL(16);
  if (D <= 32) QN_PREFILL(32);
  if (D <= 64) QN_PREFILL(64);
  QN_PREFILL(128);
#undef QN_PREFILL
}

bool takes_decode_path(int Hq, int Hkv, int P) {
  return Hkv > 0 && P * (Hq / Hkv) <= kDecodeRows;
}

template <typename T>
int launch_any(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
               const void* v_scale, const void* fresh_k, const void* fresh_v,
               const void* tables, const void* starts, void* out, int S, int Hq, int Hkv, int P,
               int D, int M, int block_size, void* stream) {
  if (takes_decode_path(Hq, Hkv, P))
    return launch_decode_any<T>(q, k_pool, v_pool, k_scale, v_scale, fresh_k, fresh_v, tables,
                                starts, out, S, Hq, Hkv, P, D, M, block_size, stream);
  return launch_prefill_any<T>(q, k_pool, v_pool, k_scale, v_scale, fresh_k, fresh_v, tables,
                               starts, out, S, Hq, Hkv, P, D, M, block_size, stream);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = launched).
// store_type: 0 float32, 1 bfloat16, 2 float8_e4m3, 3 int8 (the pools' dtype).
// Shapes: q/out [S, Hq, P, D] f32; k_pool/v_pool [N, Hkv, D] with
// N % block_size == 0; k_scale/v_scale [N / block_size, Hkv] f32 or null (both
// or neither); fresh_k/fresh_v [S, Hkv, P, D] f32 or null (both or neither);
// tables [S, M]; starts [S]. All contiguous; the caller validates them.
int paged_attention_run(int store_type, const void* q, const void* k_pool,
                        const void* v_pool, const void* k_scale,
                        const void* v_scale, const void* fresh_k,
                        const void* fresh_v, const void* tables,
                        const void* starts, void* out, int S, int Hq, int Hkv,
                        int P, int D, int M, int block_size, void* stream) {
  if (S <= 0 || P <= 0) return 0;
  switch (store_type) {
    case 0:
      return launch_any<float>(q, k_pool, v_pool, k_scale, v_scale, fresh_k, fresh_v, tables,
                               starts, out, S, Hq, Hkv, P, D, M, block_size, stream);
    case 1:
      return launch_any<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale, fresh_k, fresh_v,
                                       tables, starts, out, S, Hq, Hkv, P, D, M, block_size,
                                       stream);
    case 2:
      return launch_any<__nv_fp8_e4m3>(q, k_pool, v_pool, k_scale, v_scale, fresh_k, fresh_v,
                                       tables, starts, out, S, Hq, Hkv, P, D, M, block_size,
                                       stream);
    case 3:
      return launch_any<int8_t>(q, k_pool, v_pool, k_scale, v_scale, fresh_k, fresh_v, tables,
                                starts, out, S, Hq, Hkv, P, D, M, block_size, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Limits the wrapper checks before launching.
int paged_attention_max_head_dim(void) { return kMaxHeadDim; }

// 1 if a call of these shapes takes the decode path (paged_attention_run's
// own rule), else 0. The rule reads shapes only, so a caller may keep the
// answer per shape.
int paged_attention_decode_path(int Hq, int Hkv, int P) { return takes_decode_path(Hq, Hkv, P); }

}  // extern "C"
