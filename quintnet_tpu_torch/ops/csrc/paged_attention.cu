// Paged attention over a block-table-indexed KV pool, float32, for sm_90a.
//
// Replaces the TPU kernel quintnet_tpu/ops/paged_attention.py::_kernel
// (launched by paged_attention, pallas_call at :318) in its passthrough
// variant: no int8 scales, no fresh-K/V override.
//
// What it computes, per row s, query head h and query i < P:
//   o[s,h,i,:] = softmax_t( q[s,h,i,:] . K[s,t,:] / sqrt(D) ) @ V[s,t,:]
// over the row's positions t <= starts[s] + i, where position t lives in
// pool slot tables[s, t / bs] * bs + t % bs and kv head h / (Hq / Hkv).
//
// Layout. The TPU kernel assembled the whole row in VMEM and did all of
// its math on the last step of an in-order grid. Here blocks run in
// parallel and in no order, and a whole-row f32 K+V (6 MB at T = 1024,
// 12 heads, D = 64) is far past a block's 227 KB of shared memory. So
// one thread block owns one (row, query head, tile of <= 16 queries),
// reads its own table row and start, walks the live table slots in
// chunks of 64 positions staged in shared memory, and keeps the online
// softmax (running max, running sum, output accumulators) on chip. O is
// written once. Table slots past min((start + last query) / bs, M - 1)
// are never read -- the same clamp as the TPU index map -- so only live
// blocks move and pad queries past the table stay in bounds.
//
// Bound: memory on the decode shape (P = 1), which moves the live K/V
// blocks plus q and o and does ~4 * D flops per 8 * D bytes read. A long
// prefill (P in the hundreds) does ~P/2 times more flops per byte and is
// bound by f32 operations instead; its tiles re-read K/V from L2 once
// per 16 queries. This first version is plain CUDA-core f32; wgmma, TMA
// staging, split-KV for long single rows and narrow pools are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;       // key positions staged per step
constexpr int kMaxQueries = 16;  // queries per thread block
constexpr int kMaxAcc = 16;      // output entries per thread: tile * D <= kThreads * kMaxAcc

__global__ void __launch_bounds__(kThreads)
paged_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k_pool,
                           const float* __restrict__ v_pool,
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

    // stage this chunk's K and V rows: 16-byte loads, one key row per D/4 threads
    for (int i = tid; i < nk * vecs; i += kThreads) {
      const int kj = i / vecs;
      const int d4 = (i - kj * vecs) * 4;
      const int t = k0 + kj;
      const int blk = trow[t / bs];
      const size_t off = (((size_t)blk * bs + t % bs) * Hkv + kvh) * D + d4;
      const float4 kv = *reinterpret_cast<const float4*>(k_pool + off);
      const float4 vv = *reinterpret_cast<const float4*>(v_pool + off);
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

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = launched).
// Shapes: q/out [S, Hq, P, D]; k_pool/v_pool [N, Hkv, D] with N % block_size == 0;
// tables [S, M]; starts [S]. All contiguous; the caller validates them.
int paged_attention_f32(const void* q, const void* k_pool, const void* v_pool,
                        const void* tables, const void* starts, void* out,
                        int S, int Hq, int Hkv, int P, int D, int M,
                        int block_size, void* stream) {
  if (S <= 0 || P <= 0) return 0;
  const int tile_q = P < kMaxQueries ? P : kMaxQueries;
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P + tile_q - 1) / tile_q, Hq, S);
  paged_attention_f32_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(starts), static_cast<float*>(out), Hq, Hkv, P, D,
      M, block_size, tile_q, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Limits the wrapper checks before launching.
int paged_attention_max_head_dim(void) { return kThreads * kMaxAcc / kMaxQueries; }

}  // extern "C"
