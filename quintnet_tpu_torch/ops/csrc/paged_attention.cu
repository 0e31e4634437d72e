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
// accumulators) on chip; O is written once. Table slots past min((start
// + last query) / bs, M - 1) are never read -- the same clamp as the TPU
// index map -- so only live blocks move and pad queries past the table
// stay in bounds.
//
// In the prefill kernel the store type is a template parameter of the
// staging loop only: each thread loads 4 values of one key row (float4, 8
// bytes of bf16, 4 bytes of fp8 or int8), widens them to f32 in registers,
// multiplies by the block's scale and stores them to shared memory. The TPU kernel's
// override was a one-hot matmul (a way around a VMEM gather); here it is
// a branch on the load address. It covers all P columns, pad columns
// past the tail included, as the TPU kernel does: causality hides them
// from real queries.
//
// Two paths, picked on the host from the query rows each kv head serves,
// R = P x (Hq / Hkv) (paged_attention_decode_path, no device sync):
//
// * decode (R <= kDecodeRows = 4: decode P = 1, GQA decode up to group 4, the
//   verify shape P = 4 without GQA): paged_decode_split_kernel below,
//   compiled for one query row (plain decode) and for kDecodeRows (the
//   4-row one scores 4 rows where 1 is live: 2-3x the one-row kernel's
//   time at decode on an H100, k4_decode_times.py --variant rows4).
// * prefill (wider; the serve prefills are P >= 16): paged_attention_kernel
//   below, one block per (row, query head, tile of <= 16 queries) walking its
//   whole context in chunks of 64 positions staged in shared memory as f32.
//
// Bound: memory on the decode shape, which moves the live K/V positions plus
// q and o and does ~4 * D flops per 2 * D stored values read (a narrow pool
// moves fewer bytes for the same flops): at 8 rows of contexts up to 1,024,
// 12 heads, D = 64 in f32 that is ~17 MB, ~5 us at 3.35 TB/s. A long prefill
// (P in the hundreds) does ~P/2 times more flops per byte and is bound by
// f32 operations instead; its tiles re-read K/V from L2 once per 16 queries.
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
// The prefill path is plain CUDA-core f32; its redesign is later work.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;       // key positions staged per step
constexpr int kMaxQueries = 16;  // queries per thread block
constexpr int kMaxAcc = 16;      // output entries per thread: tile * D <= kThreads * kMaxAcc

// 4 consecutive stored values -> f32, one load of 4 * sizeof(T) bytes
template <typename T>
__device__ __forceinline__ float4 load4(const T* p);

template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

template <>
__device__ __forceinline__ float4 load4<__nv_fp8_e4m3>(const __nv_fp8_e4m3* p) {
  const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_fp8_e4m3 e;
    e.__x = static_cast<__nv_fp8_storage_t>((raw >> (8 * i)) & 0xffu);
    f[i] = static_cast<float>(e);
  }
  return make_float4(f[0], f[1], f[2], f[3]);
}

template <>
__device__ __forceinline__ float4 load4<int8_t>(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const float* __restrict__ k_scale,   // [nb, Hkv] or null
                       const float* __restrict__ v_scale,
                       const float* __restrict__ fresh_k,   // [S, Hkv, P, D] or null
                       const float* __restrict__ fresh_v,
                       const int* __restrict__ tables,
                       const int* __restrict__ starts,
                       float* __restrict__ out,
                       int Hq, int Hkv, int P, int D, int M, int bs,
                       int tile_q, float scale) {
  extern __shared__ float smem[];
  const int ldk = D + 1;                         // odd stride: no bank conflicts
  float* qs = smem;                              // [kMaxQueries][D]
  float* ks = qs + kMaxQueries * D;              // [kChunk][D + 1]
  float* vs = ks + kChunk * ldk;                 // [kChunk][D]
  float* ps = vs + kChunk * D;                   // [kMaxQueries][kChunk]
  float* row_m = ps + kMaxQueries * kChunk;      // running max
  float* row_l = row_m + kMaxQueries;            // running sum
  float* row_c = row_l + kMaxQueries;            // this chunk's rescale

  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.x * tile_q;
  const int nq = min(tile_q, P - q0);
  const int start = starts[s];
  const int* trow = tables + (size_t)s * M;
  const int last_blk = min((start + q0 + nq - 1) / bs, M - 1);
  const int n_keys = (last_blk + 1) * bs;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float* fk_row = fresh_k ? fresh_k + ((size_t)s * Hkv + kvh) * P * D : nullptr;
  const float* fv_row = fresh_v ? fresh_v + ((size_t)s * Hkv + kvh) * P * D : nullptr;

  const float* qbase = q + (((size_t)s * Hq + h) * P + q0) * D;
  for (int i = tid; i < nq * D; i += kThreads) qs[i] = qbase[i];
  if (tid < kMaxQueries) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  float acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.f;
  const int n_out = nq * D;
  const int vecs = D / 4;

  for (int k0 = 0; k0 < n_keys; k0 += kChunk) {
    const int nk = min(kChunk, n_keys - k0);
    __syncthreads();  // the previous chunk's readers of ks/vs/ps are done

    // stage this chunk's K and V rows as f32: 4 values per thread per load,
    // one key row per D/4 threads
    for (int i = tid; i < nk * vecs; i += kThreads) {
      const int kj = i / vecs;
      const int d4 = (i - kj * vecs) * 4;
      const int t = k0 + kj;
      const int rel = t - start;
      float4 kv, vv;
      if (fk_row != nullptr && rel >= 0 && rel < P) {
        kv = *reinterpret_cast<const float4*>(fk_row + (size_t)rel * D + d4);
        vv = *reinterpret_cast<const float4*>(fv_row + (size_t)rel * D + d4);
      } else {
        const int blk = trow[t / bs];
        const size_t off = (((size_t)blk * bs + t % bs) * Hkv + kvh) * D + d4;
        kv = load4<T>(k_pool + off);
        vv = load4<T>(v_pool + off);
        if (k_scale != nullptr) {
          kv = scale4(kv, k_scale[(size_t)blk * Hkv + kvh]);
          vv = scale4(vv, v_scale[(size_t)blk * Hkv + kvh]);
        }
      }
      float* kd = ks + kj * ldk + d4;
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      *reinterpret_cast<float4*>(vs + kj * D + d4) = vv;
    }
    __syncthreads();

    // scores, causally masked: position t is visible to query i iff t <= start + i
    for (int e = tid; e < nq * kChunk; e += kThreads) {
      const int qi = e / kChunk;
      const int kj = e - qi * kChunk;
      float sc = -INFINITY;
      if (kj < nk && k0 + kj <= start + q0 + qi) {
        const float* qr = qs + qi * D;
        const float* kr = ks + kj * ldk;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot * scale;
      }
      ps[e] = sc;
    }
    __syncthreads();

    // online-softmax update, one warp per query row
    for (int qi = warp; qi < nq; qi += kThreads / 32) {
      float* pr = ps + qi * kChunk;
      float mx = -INFINITY;
      for (int j = lane; j < kChunk; j += 32) mx = fmaxf(mx, pr[j]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = row_m[qi];
      const float m_new = fmaxf(m_old, mx);
      const float base = (m_new == -INFINITY) ? 0.f : m_new;
      float sum = 0.f;
      for (int j = lane; j < kChunk; j += 32) {
        const float p = (pr[j] == -INFINITY) ? 0.f : expf(pr[j] - base);
        pr[j] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float c = (m_old == -INFINITY) ? 0.f : expf(m_old - base);
        row_c[qi] = c;
        row_l[qi] = row_l[qi] * c + sum;
        row_m[qi] = m_new;
      }
    }
    __syncthreads();

    // rescale and accumulate probs @ V; each thread owns fixed output entries
#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int e = tid + r * kThreads;
      if (e < n_out) {
        const int qi = e / D;
        const int d = e - qi * D;
        const float* pr = ps + qi * kChunk;
        float a = acc[r] * row_c[qi];
        for (int kj = 0; kj < nk; ++kj) a = fmaf(pr[kj], vs[kj * D + d], a);
        acc[r] = a;
      }
    }
  }

  // every row sees position 0, so row_l > 0 for every real query
  float* obase = out + (((size_t)s * Hq + h) * P + q0) * D;
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int e = tid + r * kThreads;
    if (e < n_out) obase[e] = acc[r] / row_l[e / D];
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kMaxQueries * D + (size_t)kChunk * (D + 1) +
                          (size_t)kChunk * D + (size_t)kMaxQueries * kChunk +
                          3 * kMaxQueries);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* fresh_k,
           const void* fresh_v, const void* tables, const void* starts,
           void* out, int S, int Hq, int Hkv, int P, int D, int M,
           int block_size, void* stream) {
  const int tile_q = P < kMaxQueries ? P : kMaxQueries;
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P + tile_q - 1) / tile_q, Hq, S);
  paged_attention_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const float*>(fresh_k),
      static_cast<const float*>(fresh_v), static_cast<const int*>(tables),
      static_cast<const int*>(starts), static_cast<float*>(out), Hq, Hkv, P, D,
      M, block_size, tile_q, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

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
constexpr int kMaxHeadDim = kThreads * kMaxAcc / kMaxQueries;  // both paths
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
  return launch<T>(q, k_pool, v_pool, k_scale, v_scale, fresh_k, fresh_v, tables, starts, out, S,
                   Hq, Hkv, P, D, M, block_size, stream);
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
