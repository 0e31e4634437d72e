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
// one thread block owns one (row, query head, tile of <= 16 queries),
// reads its own table row and start, walks the live table slots in
// chunks of 64 positions staged in shared memory as f32, and keeps the
// online softmax (running max, running sum, output accumulators) on
// chip. O is written once. Table slots past min((start + last query) /
// bs, M - 1) are never read -- the same clamp as the TPU index map -- so
// only live blocks move and pad queries past the table stay in bounds.
//
// The store type is a template parameter of the staging loop only: each
// thread loads 4 values of one key row (float4, 8 bytes of bf16, 4 bytes
// of fp8 or int8), widens them to f32 in registers, multiplies by the
// block's scale and stores them to shared memory. The TPU kernel's
// override was a one-hot matmul (a way around a VMEM gather); here it is
// a branch on the load address. It covers all P columns, pad columns
// past the tail included, as the TPU kernel does: causality hides them
// from real queries.
//
// Bound: memory on the decode shape (P = 1), which moves the live K/V
// blocks plus q and o and does ~4 * D flops per 2 * D stored values read
// (a narrow pool moves fewer bytes for the same flops). A long prefill
// (P in the hundreds) does ~P/2 times more flops per byte and is bound by
// f32 operations instead; its tiles re-read K/V from L2 once per 16
// queries. This version is plain CUDA-core f32; wgmma, TMA staging and
// split-KV are later work.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
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
      return launch<float>(q, k_pool, v_pool, k_scale, v_scale, fresh_k,
                           fresh_v, tables, starts, out, S, Hq, Hkv, P, D, M,
                           block_size, stream);
    case 1:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale,
                                   fresh_k, fresh_v, tables, starts, out, S,
                                   Hq, Hkv, P, D, M, block_size, stream);
    case 2:
      return launch<__nv_fp8_e4m3>(q, k_pool, v_pool, k_scale, v_scale,
                                   fresh_k, fresh_v, tables, starts, out, S,
                                   Hq, Hkv, P, D, M, block_size, stream);
    case 3:
      return launch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, fresh_k,
                            fresh_v, tables, starts, out, S, Hq, Hkv, P, D, M,
                            block_size, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Limits the wrapper checks before launching.
int paged_attention_max_head_dim(void) { return kThreads * kMaxAcc / kMaxQueries; }

}  // extern "C"
