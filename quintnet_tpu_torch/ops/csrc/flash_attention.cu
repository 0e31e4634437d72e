// Flash attention, float32, for sm_90a: the forward and the two backward kernels.
//
// Replaces the TPU kernels of quintnet_tpu/ops/pallas_attention.py:
//   flash_fwd      <- _fwd_kernel      (:97,  pallas_call :211)
//   flash_bwd_dkv  <- _bwd_dkv_kernel  (:259, pallas_call :385)
//   flash_bwd_dq   <- _bwd_dq_kernel   (:304, pallas_call :423)
//
// What they compute, per (batch b, head h) on [S, D] rows q, k, v with
// scale = 1/sqrt(D) and the visible set V(i) of query i (j <= i when causal,
// seg[b, j] == seg[b, i] when segment ids are given):
//   forward:  lse_i = log sum_{j in V(i)} exp(scale q_i.k_j)
//             o_i   = sum_{j in V(i)} exp(scale q_i.k_j - lse_i) v_j
//   backward: p_ij  = exp(scale q_i.k_j - lse_i)       (0 outside V(i))
//             ds_ij = p_ij (do_i.v_j - delta_i) scale,  delta_i = do_i.o_i
//             dv_j = sum_i p_ij do_i,  dk_j = sum_i ds_ij q_i,  dq_i = sum_j ds_ij k_j
// delta is computed outside the kernels, as in the JAX package (:352).
//
// Layout. The TPU kernels carried their accumulators in VMEM scratch from one
// step of an in-order grid to the next. Here one thread block owns one tile
// of 64 rows of one (b, h) and runs the other dimension as a loop inside the
// block, so nothing carries between blocks:
//   flash_fwd      block per (b*h, q tile): loops over k tiles, keeps the
//                  online softmax (row max m, row sum l, O accumulator) in
//                  registers, writes O and lse = m + log l once;
//   flash_bwd_dkv  block per (b*h, k tile): loops over q tiles, dk and dv in
//                  registers, written once;
//   flash_bwd_dq   block per (b*h, q tile): loops over k tiles, dq in registers.
// The dK/dV and dQ split is kept from the TPU version (which had no atomics
// across grid cells): each gradient is written by exactly one block, with no
// atomics, so the gradients are the same from run to run.
//
// Causal tiles past the diagonal are never visited (the loop bounds play the
// part of _block_live); the causal, ragged-edge and segment masks are applied
// only on tiles that need them (_block_needs_mask); with segment ids a tile
// whose q and k id ranges are disjoint is skipped (_segment_overlap). Masked
// scores hold the finite -1e30 (NEG_INF, :49) and their probabilities are set
// to 0 explicitly, so a tile with no visible entry for a row adds nothing
// (the guard at :145-155). Rows and columns past S (a ragged last tile) are
// zero-filled on load and masked.
//
// Work per tile: every thread of 256 (16 x 16) owns a 4 x 4 block of the
// 64 x 64 score tile (rows ty + 16i, columns tx + 16j) and 4 rows x D/16
// columns of each 64 x D accumulator. Operands sit row-major in shared
// memory with a row stride of D + 4 floats, so the 4-wide loads of a warp
// hit distinct banks.
//
// Bound: operations. Per (b, h) the forward does 2 matmuls of S^2 D
// multiply-adds, the dK/dV kernel 4 (s, dp, dv, dk) and the dQ kernel 3
// (s, dp, dq), halved by causality, while each moves a few S x D slabs once:
// at S = 512, D = 64 that is 64-85 f32 operations per byte, above the
// H100's ~20 (67 TFLOP/s on the f32 CUDA cores over 3.35 TB/s). This first
// version runs on those CUDA cores; wgmma with bf16/TF32 tiles, TMA staging
// and a fused backward are later work.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // rows of q and of k per tile
constexpr int kPad = 4;        // row padding in floats: 16-byte rows, staggered banks
constexpr int kLdP = kTile + kPad;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// shared-memory helpers

// rows row0 .. row0+63 of a [S, D] slab into smem [64][D + kPad]; rows past S are 0
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int row0, int S) {
  constexpr int V = D / 4;
  for (int i = threadIdx.x; i < kTile * V; i += kThreads) {
    const int r = i / V;
    const int c = (i - r * V) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * (D + kPad) + c) = val;
  }
}

// a per-row f32 vector (lse, delta) for rows row0 .. row0+63; 0 past S
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int row0,
                                         int S) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) dst[i] = row0 + i < S ? src[row0 + i] : 0.f;
}

__device__ __forceinline__ void load_seg(int* dst, const int* __restrict__ src, int row0, int S) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) dst[i] = row0 + i < S ? src[row0 + i] : -1;
}

// [lo, hi] of the segment ids of the tile's n_valid rows; every warp computes
// the same answer, so the result is uniform across the block
__device__ __forceinline__ void seg_range(const int* seg, int n_valid, int& lo, int& hi) {
  const int lane = threadIdx.x & 31;
  const int a = lane < n_valid ? seg[lane] : INT_MAX;
  const int b = lane + 32 < n_valid ? seg[lane + 32] : INT_MAX;
  const int c = lane < n_valid ? seg[lane] : INT_MIN;
  const int d = lane + 32 < n_valid ? seg[lane + 32] : INT_MIN;
  lo = min(a, b);
  hi = max(c, d);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// acc[i][j] += A[ty + 16i] . B[tx + 16j] over D; A and B smem [64][D + kPad]
template <int D>
__device__ __forceinline__ void tile_qk(const float* a, const float* b, int ty, int tx,
                                        float (&acc)[4][4]) {
  constexpr int LD = D + kPad;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// the D/16 head-dim columns thread tx owns
template <int D>
__device__ __forceinline__ int col_of(int tx, int k) {
  if constexpr (D == 32) {
    return tx * 2 + k;
  } else {
    return (k / 4) * 64 + tx * 4 + (k % 4);
  }
}

template <int D>
__device__ __forceinline__ void load_cols(const float* row, int tx, float (&out)[D / 16]) {
  if constexpr (D == 32) {
    const float2 t = *reinterpret_cast<const float2*>(row + tx * 2);
    out[0] = t.x;
    out[1] = t.y;
  } else {
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const float4 t = *reinterpret_cast<const float4*>(row + g * 64 + tx * 4);
      out[4 * g + 0] = t.x;
      out[4 * g + 1] = t.y;
      out[4 * g + 2] = t.z;
      out[4 * g + 3] = t.w;
    }
  }
}

// acc[i][k] += sum_x P[ty + 16i][x] * B[x][col_of(k)]; P smem [64][kLdP], B smem [64][D + kPad]
template <int D>
__device__ __forceinline__ void tile_pv(const float* p, const float* b, int ty, int tx,
                                        float (&acc)[4][D / 16]) {
  constexpr int LD = D + kPad;
#pragma unroll 2
  for (int x = 0; x < kTile; x += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * kLdP + x);
    float bv[4][D / 16];
#pragma unroll
    for (int xx = 0; xx < 4; ++xx) load_cols<D>(b + (x + xx) * LD, tx, bv[xx]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        float s = acc[i][k];
        s = fmaf(pv[i].x, bv[0][k], s);
        s = fmaf(pv[i].y, bv[1][k], s);
        s = fmaf(pv[i].z, bv[2][k], s);
        s = fmaf(pv[i].w, bv[3][k], s);
        acc[i][k] = s;
      }
    }
  }
}

// 4 rows x D/16 columns of a [S, D] output, rows past S skipped
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int row0, int S, int ty,
                                           int tx, const float (&acc)[4][D / 16], float scale_row[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= S) continue;
    float* out = dst + (size_t)r * D;
#pragma unroll
    for (int k = 0; k < D / 16; ++k) out[col_of<D>(tx, k)] = acc[i][k] * scale_row[i];
  }
}

// the mask of score (q row r, k row c), both absolute
__device__ __forceinline__ bool visible(int r, int c, int S, bool causal, const int* seg_q,
                                        const int* seg_k, int ri, int cj) {
  bool ok = r < S && c < S && (!causal || c <= r);
  if (seg_q != nullptr) ok = ok && seg_q[ri] == seg_k[cj];
  return ok;
}

// ---------------------------------------------------------------------------
// K1: forward

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg,
                     float* __restrict__ o, float* __restrict__ lse, int H, int S, int causal,
                     float scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + kPad;
  float* q_s = smem;                    // [64][LD]
  float* k_s = q_s + kTile * LD;        // [64][LD]
  float* v_s = k_s + kTile * LD;        // [64][LD]
  float* p_s = v_s + kTile * LD;        // [64][kLdP]
  int* segq_s = reinterpret_cast<int*>(p_s + kTile * kLdP);
  int* segk_s = segq_s + kTile;

  const int nt = (S + kTile - 1) / kTile;
  const int qt = nt - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int q0 = qt * kTile;
  const size_t base = (size_t)bh * S * D;
  const int* seg_b = seg != nullptr ? seg + (size_t)(bh / H) * S : nullptr;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_rows<D>(q_s, q + base, q0, S);
  int q_lo = 0, q_hi = 0;
  if (seg_b != nullptr) load_seg(segq_s, seg_b, q0, S);
  __syncthreads();
  if (seg_b != nullptr) seg_range(segq_s, min(kTile, S - q0), q_lo, q_hi);

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  const int kt_end = causal ? qt + 1 : nt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers of k_s, v_s, p_s are done
    load_rows<D>(k_s, k + base, k0, S);
    load_rows<D>(v_s, v + base, k0, S);
    if (seg_b != nullptr) load_seg(segk_s, seg_b, k0, S);
    __syncthreads();
    if (seg_b != nullptr) {
      int k_lo, k_hi;
      seg_range(segk_s, min(kTile, S - k0), k_lo, k_hi);
      if (k_hi < q_lo || k_lo > q_hi) continue;  // uniform: no shared pair of ids
    }

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_qk<D>(q_s, k_s, ty, tx, s);

    const bool needs_mask = (causal && kt == qt) || k0 + kTile > S || seg_b != nullptr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (needs_mask &&
            !visible(q0 + ty + 16 * i, k0 + tx + 16 * j, S, causal,
                     seg_b != nullptr ? segq_s : nullptr, segk_s, ty + 16 * i, tx + 16 * j))
          x = kNegInf;
        s[i][j] = x;
      }
    }

    // online softmax: a row's 64 scores sit on the 16 lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > 0.5f * kNegInf ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[(ty + 16 * i) * kLdP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    tile_pv<D>(p_s, v_s, ty, tx, acc);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / li;
    const int r = q0 + ty + 16 * i;
    if (tx == 0 && r < S) lse[(size_t)bh * S + r] = m[i] + logf(li);
  }
  store_rows<D>(o + base, q0, S, ty, tx, acc, inv);
}

// ---------------------------------------------------------------------------
// the recomputed probabilities and score gradients of one (q tile, k tile):
// p = exp(scale s - lse) and ds = p (dp - delta) scale, 0 where masked

__device__ __forceinline__ void probs_and_dscores(float (&s)[4][4], float (&dp)[4][4],
                                                  const float* lse_s, const float* delta_s,
                                                  bool needs_mask, int q0, int k0, int S,
                                                  bool causal, const int* segq_s,
                                                  const int* segk_s, int ty, int tx,
                                                  float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ri = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cj = tx + 16 * j;
      float p = expf(s[i][j] * scale - lse_s[ri]);
      if (needs_mask && !visible(q0 + ri, k0 + cj, S, causal, segq_s, segk_s, ri, cj)) p = 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_s[ri]) * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dK and dV

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ seg, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int S, int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + kPad;
  float* k_s = smem;                    // [64][LD]
  float* v_s = k_s + kTile * LD;        // [64][LD]
  float* q_s = v_s + kTile * LD;        // [64][LD]
  float* do_s = q_s + kTile * LD;       // [64][LD]
  float* pt_s = do_s + kTile * LD;      // [64 k][kLdP q]: p transposed
  float* dst_s = pt_s + kTile * kLdP;   // [64 k][kLdP q]: ds transposed
  float* lse_s = dst_s + kTile * kLdP;  // [64]
  float* delta_s = lse_s + kTile;       // [64]
  int* segq_s = reinterpret_cast<int*>(delta_s + kTile);
  int* segk_s = segq_s + kTile;

  const int nt = (S + kTile - 1) / kTile;
  const int kt = blockIdx.x;  // k tile kt meets nt - kt causal q tiles
  const int bh = blockIdx.y;
  const int k0 = kt * kTile;
  const size_t base = (size_t)bh * S * D;
  const size_t rbase = (size_t)bh * S;
  const int* seg_b = seg != nullptr ? seg + (size_t)(bh / H) * S : nullptr;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_rows<D>(k_s, k + base, k0, S);
  load_rows<D>(v_s, v + base, k0, S);
  int k_lo = 0, k_hi = 0;
  if (seg_b != nullptr) load_seg(segk_s, seg_b, k0, S);
  __syncthreads();
  if (seg_b != nullptr) seg_range(segk_s, min(kTile, S - k0), k_lo, k_hi);

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int qt = causal ? kt : 0; qt < nt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_rows<D>(q_s, q + base, q0, S);
    load_rows<D>(do_s, dout + base, q0, S);
    load_vec(lse_s, lse + rbase, q0, S);
    load_vec(delta_s, delta + rbase, q0, S);
    if (seg_b != nullptr) load_seg(segq_s, seg_b, q0, S);
    __syncthreads();
    if (seg_b != nullptr) {
      int q_lo, q_hi;
      seg_range(segq_s, min(kTile, S - q0), q_lo, q_hi);
      if (k_hi < q_lo || k_lo > q_hi) continue;
    }

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_qk<D>(q_s, k_s, ty, tx, s);
    tile_qk<D>(do_s, v_s, ty, tx, dp);
    const bool needs_mask =
        (causal && qt == kt) || q0 + kTile > S || k0 + kTile > S || seg_b != nullptr;
    probs_and_dscores(s, dp, lse_s, delta_s, needs_mask, q0, k0, S, causal,
                      seg_b != nullptr ? segq_s : nullptr, segk_s, ty, tx, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pt_s[(tx + 16 * j) * kLdP + ty + 16 * i] = s[i][j];
        dst_s[(tx + 16 * j) * kLdP + ty + 16 * i] = dp[i][j];
      }
    }
    __syncthreads();
    tile_pv<D>(pt_s, do_s, ty, tx, dv_acc);   // dv += p^T do
    tile_pv<D>(dst_s, q_s, ty, tx, dk_acc);   // dk += ds^T q
  }

  float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(dk + base, k0, S, ty, tx, dk_acc, one);
  store_rows<D>(dv + base, k0, S, ty, tx, dv_acc, one);
}

// ---------------------------------------------------------------------------
// K3: dQ

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ seg, float* __restrict__ dq, int H, int S,
                        int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + kPad;
  float* q_s = smem;                    // [64][LD]
  float* do_s = q_s + kTile * LD;       // [64][LD]
  float* k_s = do_s + kTile * LD;       // [64][LD]
  float* v_s = k_s + kTile * LD;        // [64][LD]
  float* ds_s = v_s + kTile * LD;       // [64 q][kLdP k]
  float* lse_s = ds_s + kTile * kLdP;   // [64]
  float* delta_s = lse_s + kTile;       // [64]
  int* segq_s = reinterpret_cast<int*>(delta_s + kTile);
  int* segk_s = segq_s + kTile;

  const int nt = (S + kTile - 1) / kTile;
  const int qt = nt - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int q0 = qt * kTile;
  const size_t base = (size_t)bh * S * D;
  const size_t rbase = (size_t)bh * S;
  const int* seg_b = seg != nullptr ? seg + (size_t)(bh / H) * S : nullptr;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_rows<D>(q_s, q + base, q0, S);
  load_rows<D>(do_s, dout + base, q0, S);
  load_vec(lse_s, lse + rbase, q0, S);
  load_vec(delta_s, delta + rbase, q0, S);
  int q_lo = 0, q_hi = 0;
  if (seg_b != nullptr) load_seg(segq_s, seg_b, q0, S);
  __syncthreads();
  if (seg_b != nullptr) seg_range(segq_s, min(kTile, S - q0), q_lo, q_hi);

  float dq_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dq_acc[i][c] = 0.f;

  const int kt_end = causal ? qt + 1 : nt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_rows<D>(k_s, k + base, k0, S);
    load_rows<D>(v_s, v + base, k0, S);
    if (seg_b != nullptr) load_seg(segk_s, seg_b, k0, S);
    __syncthreads();
    if (seg_b != nullptr) {
      int k_lo, k_hi;
      seg_range(segk_s, min(kTile, S - k0), k_lo, k_hi);
      if (k_hi < q_lo || k_lo > q_hi) continue;
    }

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_qk<D>(q_s, k_s, ty, tx, s);
    tile_qk<D>(do_s, v_s, ty, tx, dp);
    const bool needs_mask =
        (causal && kt == qt) || q0 + kTile > S || k0 + kTile > S || seg_b != nullptr;
    probs_and_dscores(s, dp, lse_s, delta_s, needs_mask, q0, k0, S, causal,
                      seg_b != nullptr ? segq_s : nullptr, segk_s, ty, tx, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ds_s[(ty + 16 * i) * kLdP + tx + 16 * j] = dp[i][j];
    __syncthreads();
    tile_pv<D>(ds_s, k_s, ty, tx, dq_acc);  // dq += ds k
  }

  float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(dq + base, q0, S, ty, tx, dq_acc, one);
}

// ---------------------------------------------------------------------------
// launch helpers

constexpr size_t fwd_smem(int D) {
  return sizeof(float) * (3 * (size_t)kTile * (D + kPad) + (size_t)kTile * kLdP) +
         2 * sizeof(int) * kTile;
}
constexpr size_t dkv_smem(int D) {
  return sizeof(float) * (4 * (size_t)kTile * (D + kPad) + 2 * (size_t)kTile * kLdP + 2 * kTile) +
         2 * sizeof(int) * kTile;
}
constexpr size_t dq_smem(int D) {
  return sizeof(float) * (4 * (size_t)kTile * (D + kPad) + (size_t)kTile * kLdP + 2 * kTile) +
         2 * sizeof(int) * kTile;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse,
               int B, int H, int S, int causal, cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  cudaError_t e = allow_smem(flash_fwd_f32_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<float*>(o), static_cast<float*>(lse), H, S,
      causal, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* seg, void* dk, void* dv, int B, int H, int S,
               int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem(D);
  cudaError_t e = allow_smem(flash_bwd_dkv_f32_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), static_cast<float*>(dk),
      static_cast<float*>(dv), H, S, causal, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* seg, void* dq, int B, int H, int S, int causal,
              cudaStream_t stream) {
  const size_t smem = dq_smem(D);
  cudaError_t e = allow_smem(flash_bwd_dq_f32_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_bwd_dq_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), static_cast<float*>(dq), H,
      S, causal, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() as an int
// (0 = launched). Shapes: q, k, v, o, do, dq, dk, dv [B, H, S, D]; lse, delta
// [B, H, S] f32; seg [B, S] int32 or null. All contiguous and 16-byte aligned,
// D in {32, 64, 128}; the caller validates them.

int flash_fwd_f32(const void* q, const void* k, const void* v, const void* seg, void* o,
                  void* lse, int B, int H, int S, int D, int causal, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_fwd<32>(q, k, v, seg, o, lse, B, H, S, causal, st);
    case 64: return launch_fwd<64>(q, k, v, seg, o, lse, B, H, S, causal, st);
    case 128: return launch_fwd<128>(q, k, v, seg, o, lse, B, H, S, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int flash_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* seg, void* dk, void* dv,
                      int B, int H, int S, int D, int causal, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, seg, dk, dv, B, H, S, causal, st);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, seg, dk, dv, B, H, S, causal, st);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, seg, dk, dv, B, H, S, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* seg, void* dq, int B, int H,
                     int S, int D, int causal, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_dq<32>(q, k, v, dout, lse, delta, seg, dq, B, H, S, causal, st);
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, seg, dq, B, H, S, causal, st);
    case 128: return launch_dq<128>(q, k, v, dout, lse, delta, seg, dq, B, H, S, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
