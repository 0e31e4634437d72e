// Flash attention for sm_90a: the forward and the two backward kernels, in
// float32 (3xTF32 on the tensor cores) and in bf16 (bf16 tensor-core tiles,
// f32 accumulators; the section "bf16" below).
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
// across grid cells): each gradient element is written by exactly one block,
// with no atomics, so two runs on the same inputs give bitwise-equal
// gradients. The price: s and dp are recomputed in both backward kernels,
// 7 products where one fused backward needs 5.
//
// Causal tiles past the diagonal are never visited (the loop bounds play the
// part of _block_live); the causal, ragged-edge and segment masks are applied
// only on tiles that need them (_block_needs_mask); with segment ids a tile
// whose q and k id ranges are disjoint is skipped (_segment_overlap). Masked
// scores hold the finite -1e30 (kNegInf) in the forward, and every masked
// probability is set to 0 explicitly, so a tile with no visible entry for a
// row adds nothing. Rows past S (a ragged last tile) are zero-filled on load
// and masked.
//
// All three kernels run every product on the tensor cores at f32 accuracy
// (3xTF32, the scheme of CUTLASS's OpMultiplyAddFastF32): each f32 operand x
// is split into big = tf32(x) (rounded to nearest, as cvt.rna) and small =
// tf32(x - big), and big*big + big*small + small*big is accumulated in f32
// by mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32. Plain TF32 would lose ~3
// digits (5.9e-4 relative on dq, 3.9e-4 on o at S = 512); 3xTF32 stays near
// f32.
//   * Why mma.sync and not wgmma: wgmma's tf32 form reads both operands
//     K-major from shared memory, and three of the backward's five products
//     (p^T do, ds^T q, ds k) and the forward's p v want their B operand the
//     other way round, which would need transposed copies staged in shared
//     memory, and p and ds would have to go through shared memory too.
//     mma.sync takes its fragments from registers, so each thread loads them
//     in the orientation the product needs.
//   * Orientation: K1 and K3 compute s = q k^T for their 64 queries, K2
//     computes s^T = k q^T and dp^T = v do^T for its 64 keys, so p^T and
//     ds^T come out with key rows. The probabilities and score gradients
//     then feed the next product (o, dv, dk, dq) as its A operand straight
//     from the accumulator registers: the depth index of each 8-deep step is
//     permuted (fragment k = t reads column 2t, k = t + 4 column 2t + 1) so
//     that the accumulator layout IS the A-fragment layout, with no warp
//     shuffle and no copy of p or ds in shared memory. The B operand's rows
//     follow the same permutation.
//   * Loads: operands that sit row-major in shared memory (q, k, v, do as A;
//     k in K1, q, do in K2 as B of s, s^T and dp^T) come in by ldmatrix.x4,
//     four 8 x 4 f32 blocks a warp instruction; the B operands read down a
//     column (and k, v in K3, where ldmatrix measured no faster) by scalar
//     loads. Rows are padded to D + 4 floats and every pattern is free of
//     bank conflicts.
//   * Where to split: per fragment load, in registers, with integer adds and
//     masks. Splitting once at staging time into big and small tiles was
//     measured slower on the card (twice the shared memory and loads, fewer
//     blocks per SM, one more barrier a tile).
//   * Rounding: the tensor core truncates its sums, so long chains of steps
//     summed inside it drift one way (see mma_3xtf32); s and dp add each
//     8-deep step to f32 registers with round-to-nearest, o, dk, dv and dq
//     each streamed tile.
//   * Staging: a two-stage ring in shared memory, filled by 16-byte
//     cp.async.cg (4-byte cp.async for lse, delta and segment ids), so the
//     next streamed tile (k, v, k ids in K1 and K3; q, do, lse, delta, q ids
//     in K2) loads while the current one computes; rows past S are
//     zero-filled.
//   * Tiles: 128 threads (4 warps x 16 owned rows), 64 owned rows; K1 and K3
//     stream 64 key rows a stage (32 at D = 128), K2 32 query rows (64 at D =
//     32). Launch bounds of one block, so the compiler may use all 255
//     registers (measured faster than capping them for more blocks, in K2
//     and K3). At the train shape (B = 32, H = 12, S = 512) each kernel
//     launches 3,072 blocks. K2 runs the longest causal key tiles first (kt
//     = 0), K1 and K3 the longest query tiles (qt = nt - 1 first).
//   * K1's online softmax runs on the accumulator fragments: a row's 8
//     scores of an m16n8 tile sit on the 4 lanes of a quad, so the row max
//     takes two __shfl_xor_sync steps; each thread keeps its own part of the
//     row sum l, reduced over the quad once at the end. Then p feeds o += p v
//     from registers, with no barrier between the softmax and the product.
//     K1 reloads its q fragments from shared memory for every k tile, as K3
//     does. Holding them split in registers for the whole loop (64 more
//     registers a thread at D = 64) measured slower on the card.
//   * exp is ex2.approx on a pre-scaled argument (~2 ulp).
//
// Bound: operations. Per (b, h) the forward does 2 matmuls of S^2 D
// multiply-adds, the dK/dV kernel 4 (s, dp, dv, dk) and the dQ kernel 3
// (s, dp, dq), halved by causality, while each moves a few S x D slabs once:
// at S = 512, D = 64 that is 64-85 f32 operations per byte. For f32-accurate
// products the card's least time is set by 3xTF32 on the tensor cores:
// 495 / 3 = 165 TFLOP/s (at 3.35 TB/s, ~49 operations per byte).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

// the mask of score (q row r, k row c), both absolute
__device__ __forceinline__ bool visible(int r, int c, int S, bool causal, const int* seg_q,
                                        const int* seg_k, int ri, int cj) {
  bool ok = r < S && c < S && (!causal || c <= r);
  if (seg_q != nullptr) ok = ok && seg_q[ri] == seg_k[cj];
  return ok;
}

// ---------------------------------------------------------------------------
// tiles (the tensor-core and cp.async helpers are in mma_tf32.cuh)

constexpr int kOwn = 64;  // rows of the tile a block owns (keys in K2, queries in K3)

// rows of the tile each kernel streams through its ring, from the chip runs at
// D = 64: K2 keeps dk, dv, s^T and dp^T of 16 keys in registers and is fastest
// with 32 query rows a stage, K3 (dq only) with 64 key rows; at D = 128 both
// take 32 to stay within 255 registers. K1 (o only) streams as K3 does.
template <int D>
constexpr int dkv_rows() {
  return D == 32 ? 64 : 32;
}
template <int D>
constexpr int dq_rows() {
  return D == 128 ? 32 : 64;
}

// rows row0 .. row0+ROWS-1 of a [S, D] slab into smem [ROWS][D + kPad], in
// flight; rows past S are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void cp_rows(float* dst, const float* __restrict__ src, int row0,
                                        int S) {
  constexpr int V = D / 4;
  for (int i = threadIdx.x; i < ROWS * V; i += kMmaThreads) {
    const int r = i / V;
    const int c = (i - r * V) * 4;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * (D + kPad) + c, src + (size_t)(ok ? row0 + r : 0) * D + c, ok ? 16 : 0);
  }
}

// a per-row vector (lse, delta, segment ids) for rows row0 .. row0+ROWS-1, in
// flight; 0 past S (those rows are masked)
template <int ROWS, typename T>
__device__ __forceinline__ void cp_vec(T* dst, const T* __restrict__ src, int row0, int S) {
  for (int i = threadIdx.x; i < ROWS; i += kMmaThreads) {
    const bool ok = row0 + i < S;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok ? 4 : 0);
  }
}

// [lo, hi] of the segment ids of a tile's n_valid rows, uniform across the block
template <int ROWS>
__device__ __forceinline__ void seg_range_rows(const int* seg, int n_valid, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  for (int i = threadIdx.x & 31; i < ROWS && i < n_valid; i += 32) {
    lo = min(lo, seg[i]);
    hi = max(hi, seg[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// the 16 rows r0.. of a warp's [16, D] accumulator into a [S, D] output
template <int D>
__device__ __forceinline__ void store_acc(float* __restrict__ dst, int r0, int S, int g, int t,
                                          const float (&acc)[D / 8][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dst + (size_t)r * D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}
// ---------------------------------------------------------------------------
// K1: forward. A block owns 64 queries (16 per warp) and streams the k tiles
// through a two-stage cp.async ring: s = q k^T, the online softmax on the
// accumulator fragments (row max m, row sum l), then o += p v with p taken
// from registers. O and lse = m + log l are written once.

template <int D>
struct FwdSmem {
  static constexpr int LD = D + kPad;
  static constexpr int BK = dq_rows<D>();
  static constexpr int kStage = 2 * BK * LD + BK;  // k, v; seg (4 bytes each)
  static constexpr size_t bytes = 4 * ((size_t)kOwn * LD + kOwn + 2 * (size_t)kStage);
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_fwd_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ seg,
                        float* __restrict__ o, float* __restrict__ lse, int H, int S, int causal,
                        float scale) {
  using L = FwdSmem<D>;
  constexpr int LD = L::LD, BK = L::BK, NT = BK / 8;
  extern __shared__ float smem[];
  float* q_s = smem;                                        // [64][LD]
  int* segq_s = reinterpret_cast<int*>(q_s + kOwn * LD);    // [64]
  float* ring = reinterpret_cast<float*>(segq_s + kOwn);    // 2 stages
  // stage st: k, v [BK][LD]; seg [BK]
  auto tile = [&](int st, int i) { return ring + st * L::kStage + i * BK * LD; };
  auto segk_s = [&](int st) { return reinterpret_cast<int*>(tile(st, 2)); };

  const int nt_own = (S + kOwn - 1) / kOwn;
  const int qt = nt_own - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int q0 = qt * kOwn;
  const size_t base = (size_t)bh * S * D;
  const int* seg_b = seg != nullptr ? seg + (size_t)(bh / H) * S : nullptr;
  const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) / 4, t = threadIdx.x & 3;
  const int qw = warp * 16;  // the warp's first query row in the tile

  auto stage_load = [&](int st, int kt) {
    const int k0 = kt * BK;
    cp_rows<D, BK>(tile(st, 0), k + base, k0, S);
    cp_rows<D, BK>(tile(st, 1), v + base, k0, S);
    if (seg_b != nullptr) cp_vec<BK>(segk_s(st), seg_b, k0, S);
  };

  // causal: the k tiles up to the last real query of the tile
  const int q_end = min(q0 + kOwn, S);
  const int nk = causal ? (q_end + BK - 1) / BK : (S + BK - 1) / BK;
  cp_rows<D, kOwn>(q_s, q + base, q0, S);
  if (seg_b != nullptr) cp_vec<kOwn>(segq_s, seg_b, q0, S);
  stage_load(0, 0);
  cp_async_commit();

  // rows qw + g and qw + g + 8: running max (natural log units), this
  // thread's part of the running sum, and the output accumulator
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float o_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;

  int q_lo = 0, q_hi = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {  // the next tile loads while this one computes
      stage_load(st ^ 1, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0 && seg_b != nullptr) seg_range_rows<kOwn>(segq_s, min(kOwn, S - q0), q_lo, q_hi);
    const int k0 = kt * BK;
    bool live = true;
    if (seg_b != nullptr) {
      int k_lo, k_hi;
      seg_range_rows<BK>(segk_s(st), min(BK, S - k0), k_lo, k_hi);
      live = !(k_hi < q_lo || k_lo > q_hi);  // uniform: no shared pair of ids
    }
    if (live) {
      const float* ks = tile(st, 0);
      const float* vs = tile(st, 1);
      float s[NT][4];  // query rows qw + g (+8), key columns
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
      for (int c0 = 0; c0 < D; c0 += 8) {
        const Frag<4> qa = frag_a<D>(q_s, qw, c0);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          Frag<2> kb[2];
          frag_b_t2<D>(ks, 8 * j, c0, kb[0], kb[1]);
          mma_3xtf32(s[j], qa, kb[0]);
          mma_3xtf32(s[j + 1], qa, kb[1]);
        }
      }
      // scale; masked scores at kNegInf
      const bool needs_mask =
          (causal && k0 + BK - 1 > q0) || k0 + BK > S || q0 + kOwn > S || seg_b != nullptr;
      const int* sk = seg_b != nullptr ? segk_s(st) : nullptr;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = qw + g + 8 * (e >> 1);
          const int kl = 8 * j + 2 * t + (e & 1);
          float x = s[j][e] * scale;
          if (needs_mask &&
              !visible(q0 + ql, k0 + kl, S, causal, seg_b != nullptr ? segq_s : nullptr, sk, ql, kl))
            x = kNegInf;
          s[j][e] = x;
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
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
          const float p = x > 0.5f * kNegInf ? ex2(fmaf(x, kLog2e, neg_m2[e >> 1])) : 0.f;
          s[j][e] = p;
          l_r[e >> 1] += p;
        }
      }
      // o = o corr + p v over this tile's keys: p feeds the product from
      // registers, the tile's NT steps are summed in the tensor core
      Frag<4> pa[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) pa[j] = acc_as_a(s[j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        float ot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_3xtf32_tc(ot, pa[j], frag_b_n<D>(vs, 8 * j, 8 * n, g, t));
#pragma unroll
        for (int e = 0; e < 4; ++e) o_acc[n][e] = fmaf(o_acc[n][e], corr[e >> 1], ot[e]);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  // l over the quad; o / l and lse = m + log l, rows past S skipped
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    const float li = fmaxf(l_r[h], 1e-30f);
    const float inv = 1.f / li;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o_acc[n][2 * h] *= inv;
      o_acc[n][2 * h + 1] *= inv;
    }
    const int r = q0 + qw + g + 8 * h;
    if (t == 0 && r < S) lse[(size_t)bh * S + r] = m_r[h] + logf(li);
  }
  store_acc<D>(o + base, q0 + qw, S, g, t, o_acc);
}

// ---------------------------------------------------------------------------
// K2: dK and dV. A block owns 64 keys (16 per warp) and streams the q tiles
// through a two-stage cp.async ring; it computes in its own key-row
// orientation: s^T = k q^T and dp^T = v do^T, so p^T and ds^T come out with
// key rows and feed dv += p^T do and dk += ds^T q as the A operand.

template <int D>
struct DkvSmem {
  static constexpr int LD = D + kPad;
  static constexpr int BQ = dkv_rows<D>();
  static constexpr int kStage = 2 * BQ * LD + 3 * BQ;  // q, do; lse, delta, seg (4 bytes each)
  static constexpr size_t bytes = 4 * ((size_t)2 * kOwn * LD + kOwn + 2 * (size_t)kStage);
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_bwd_dkv_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const int* __restrict__ seg, float* __restrict__ dk,
                            float* __restrict__ dv, int H, int S, int causal, float scale) {
  using L = DkvSmem<D>;
  constexpr int LD = L::LD, BQ = L::BQ, NT = BQ / 8;
  extern __shared__ float smem[];
  float* k_s = smem;                                        // [64][LD]
  float* v_s = k_s + kOwn * LD;                             // [64][LD]
  int* segk_s = reinterpret_cast<int*>(v_s + kOwn * LD);    // [64]
  float* ring = reinterpret_cast<float*>(segk_s + kOwn);    // 2 stages
  // stage st: q, do [BQ][LD]; lse, delta, seg [BQ]
  auto tile = [&](int st, int i) { return ring + st * L::kStage + i * BQ * LD; };
  auto lse_s = [&](int st) { return tile(st, 2); };
  auto delta_s = [&](int st) { return tile(st, 2) + BQ; };
  auto segq_s = [&](int st) { return reinterpret_cast<int*>(tile(st, 2) + 2 * BQ); };

  const int kt = blockIdx.x;  // k tile kt meets the most causal q tiles at kt = 0
  const int bh = blockIdx.y;
  const int k0 = kt * kOwn;
  const size_t base = (size_t)bh * S * D;
  const size_t rbase = (size_t)bh * S;
  const int* seg_b = seg != nullptr ? seg + (size_t)(bh / H) * S : nullptr;
  const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) / 4, t = threadIdx.x & 3;
  const int kw = warp * 16;  // the warp's first key row in the tile

  auto stage_load = [&](int st, int qt) {
    const int q0 = qt * BQ;
    cp_rows<D, BQ>(tile(st, 0), q + base, q0, S);
    cp_rows<D, BQ>(tile(st, 1), dout + base, q0, S);
    cp_vec<BQ>(lse_s(st), lse + rbase, q0, S);
    cp_vec<BQ>(delta_s(st), delta + rbase, q0, S);
    if (seg_b != nullptr) cp_vec<BQ>(segq_s(st), seg_b, q0, S);
  };

  const int nq = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;  // the first q tile with a query >= k0
  cp_rows<D, kOwn>(k_s, k + base, k0, S);
  cp_rows<D, kOwn>(v_s, v + base, k0, S);
  if (seg_b != nullptr) cp_vec<kOwn>(segk_s, seg_b, k0, S);
  stage_load(0, qt0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  int k_lo = 0, k_hi = 0;
  for (int qt = qt0; qt < nq; ++qt) {
    const int st = (qt - qt0) & 1;
    if (qt + 1 < nq) {  // the next tile loads while this one computes
      stage_load(st ^ 1, qt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qt * BQ;
    bool live = true;
    if (seg_b != nullptr) {
      if (qt == qt0) seg_range_rows<kOwn>(segk_s, min(kOwn, S - k0), k_lo, k_hi);
      int q_lo, q_hi;
      seg_range_rows<BQ>(segq_s(st), min(BQ, S - q0), q_lo, q_hi);
      live = !(k_hi < q_lo || k_lo > q_hi);  // uniform: no shared pair of ids
    }
    if (live) {
      const float* qs = tile(st, 0);
      const float* dos = tile(st, 1);
      float s[NT][4], dp[NT][4];  // s^T and dp^T: key rows kw + g (+8), query columns
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
      for (int c0 = 0; c0 < D; c0 += 8) {
        const Frag<4> ka = frag_a<D>(k_s, kw, c0);
        const Frag<4> va = frag_a<D>(v_s, kw, c0);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          Frag<2> qb[2], db[2];
          frag_b_t2<D>(qs, 8 * j, c0, qb[0], qb[1]);
          frag_b_t2<D>(dos, 8 * j, c0, db[0], db[1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma_3xtf32(s[j + h], ka, qb[h]);
            mma_3xtf32(dp[j + h], va, db[h]);
          }
        }
      }
      // p^T = exp(scale s^T - lse), ds^T = p^T (dp^T - delta) scale; 0 where masked
      const bool needs_mask =
          (causal && k0 + kOwn - 1 > q0) || q0 + BQ > S || k0 + kOwn > S || seg_b != nullptr;
      const float* ls = lse_s(st);
      const float* dl = delta_s(st);
      const int* sq = seg_b != nullptr ? segq_s(st) : nullptr;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = kw + g + 8 * (e >> 1);
          const int ql = 8 * j + 2 * t + (e & 1);
          float p = ex2(fmaf(s[j][e], scale * kLog2e, -ls[ql] * kLog2e));
          if (needs_mask && !visible(q0 + ql, k0 + kl, S, causal, sq, segk_s, ql, kl)) p = 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl[ql]) * scale;
        }
      }
      // dv += p^T do, dk += ds^T q over this tile's queries: p^T and ds^T
      // feed the products from registers, the tile's NT steps are summed in
      // the tensor core and added to dk and dv with round-to-nearest
      Frag<4> pa[NT], dsa[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        pa[j] = acc_as_a(s[j]);
        dsa[j] = acc_as_a(dp[j]);
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        float dvt[4] = {0.f, 0.f, 0.f, 0.f}, dkt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_3xtf32_tc(dvt, pa[j], frag_b_n<D>(dos, 8 * j, 8 * n, g, t));
          mma_3xtf32_tc(dkt, dsa[j], frag_b_n<D>(qs, 8 * j, 8 * n, g, t));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv_acc[n][e] += dvt[e];
          dk_acc[n][e] += dkt[e];
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  store_acc<D>(dk + base, k0 + kw, S, g, t, dk_acc);
  store_acc<D>(dv + base, k0 + kw, S, g, t, dv_acc);
}

// ---------------------------------------------------------------------------
// K3: dQ. A block owns 64 queries (16 per warp; lse and delta of its rows in
// registers) and streams the k tiles through a two-stage cp.async ring:
// s = q k^T, dp = do v^T, then dq += ds k with ds taken from registers.

template <int D>
struct DqSmem {
  static constexpr int LD = D + kPad;
  static constexpr int BK = dq_rows<D>();
  static constexpr int kStage = 2 * BK * LD + BK;  // k, v; seg (4 bytes each)
  static constexpr size_t bytes = 4 * ((size_t)2 * kOwn * LD + 3 * kOwn + 2 * (size_t)kStage);
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_bwd_dq_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const int* __restrict__ seg, float* __restrict__ dq, int H, int S,
                           int causal, float scale) {
  using L = DqSmem<D>;
  constexpr int LD = L::LD, BK = L::BK, NT = BK / 8;
  extern __shared__ float smem[];
  float* q_s = smem;                                        // [64][LD]
  float* do_s = q_s + kOwn * LD;                            // [64][LD]
  float* lse_s = do_s + kOwn * LD;                          // [64]
  float* delta_s = lse_s + kOwn;                            // [64]
  int* segq_s = reinterpret_cast<int*>(delta_s + kOwn);     // [64]
  float* ring = reinterpret_cast<float*>(segq_s + kOwn);    // 2 stages
  // stage st: k, v [BK][LD]; seg [BK]
  auto tile = [&](int st, int i) { return ring + st * L::kStage + i * BK * LD; };
  auto segk_s = [&](int st) { return reinterpret_cast<int*>(tile(st, 2)); };

  const int nt_own = (S + kOwn - 1) / kOwn;
  const int qt = nt_own - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int q0 = qt * kOwn;
  const size_t base = (size_t)bh * S * D;
  const size_t rbase = (size_t)bh * S;
  const int* seg_b = seg != nullptr ? seg + (size_t)(bh / H) * S : nullptr;
  const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) / 4, t = threadIdx.x & 3;
  const int qw = warp * 16;  // the warp's first query row in the tile

  auto stage_load = [&](int st, int kt) {
    const int k0 = kt * BK;
    cp_rows<D, BK>(tile(st, 0), k + base, k0, S);
    cp_rows<D, BK>(tile(st, 1), v + base, k0, S);
    if (seg_b != nullptr) cp_vec<BK>(segk_s(st), seg_b, k0, S);
  };

  // causal: the k tiles up to the last real query of the tile
  const int q_end = min(q0 + kOwn, S);
  const int nk = causal ? (q_end + BK - 1) / BK : (S + BK - 1) / BK;
  cp_rows<D, kOwn>(q_s, q + base, q0, S);
  cp_rows<D, kOwn>(do_s, dout + base, q0, S);
  cp_vec<kOwn>(lse_s, lse + rbase, q0, S);
  cp_vec<kOwn>(delta_s, delta + rbase, q0, S);
  if (seg_b != nullptr) cp_vec<kOwn>(segq_s, seg_b, q0, S);
  stage_load(0, 0);
  cp_async_commit();

  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  float lse2[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};  // lse2 = lse log2(e)
  int q_lo = 0, q_hi = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {  // the next tile loads while this one computes
      stage_load(st ^ 1, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lse2[h] = lse_s[qw + g + 8 * h] * kLog2e;
        delta_r[h] = delta_s[qw + g + 8 * h];
      }
      if (seg_b != nullptr) seg_range_rows<kOwn>(segq_s, min(kOwn, S - q0), q_lo, q_hi);
    }
    const int k0 = kt * BK;
    bool live = true;
    if (seg_b != nullptr) {
      int k_lo, k_hi;
      seg_range_rows<BK>(segk_s(st), min(BK, S - k0), k_lo, k_hi);
      live = !(k_hi < q_lo || k_lo > q_hi);  // uniform: no shared pair of ids
    }
    if (live) {
      const float* ks = tile(st, 0);
      const float* vs = tile(st, 1);
      float s[NT][4], dp[NT][4];  // query rows qw + g (+8), key columns
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
      for (int c0 = 0; c0 < D; c0 += 8) {
        const Frag<4> qa = frag_a<D>(q_s, qw, c0);
        const Frag<4> da = frag_a<D>(do_s, qw, c0);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_3xtf32(s[j], qa, frag_b_t<D>(ks, 8 * j, c0, g, t));
          mma_3xtf32(dp[j], da, frag_b_t<D>(vs, 8 * j, c0, g, t));
        }
      }
      // ds = p (dp - delta) scale with p = exp(scale s - lse); 0 where masked
      const bool needs_mask =
          (causal && k0 + BK - 1 > q0) || k0 + BK > S || q0 + kOwn > S || seg_b != nullptr;
      const int* sk = seg_b != nullptr ? segk_s(st) : nullptr;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = qw + g + 8 * (e >> 1);
          const int kl = 8 * j + 2 * t + (e & 1);
          float p = ex2(fmaf(s[j][e], scale * kLog2e, -lse2[e >> 1]));
          if (needs_mask &&
              !visible(q0 + ql, k0 + kl, S, causal, seg_b != nullptr ? segq_s : nullptr, sk, ql, kl))
            p = 0.f;
          dp[j][e] = p * (dp[j][e] - delta_r[e >> 1]) * scale;
        }
      }
      // dq += ds k over this tile's keys, summed in the tensor core per tile
      Frag<4> dsa[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) dsa[j] = acc_as_a(dp[j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        float dqt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_3xtf32_tc(dqt, dsa[j], frag_b_n<D>(ks, 8 * j, 8 * n, g, t));
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_acc[n][e] += dqt[e];
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  store_acc<D>(dq + base, q0 + qw, S, g, t, dq_acc);
}

// ---------------------------------------------------------------------------
// bf16: K1-K3 on bf16 q, k, v, do (o, dq, dk, dv written in bf16; lse and
// delta f32), bf16 products with f32 accumulators, as the Pallas kernels
// feed the MXU in the input dtype with preferred_element_type=f32. Scores,
// softmax statistics, lse, p and ds stay f32 until the points where the
// Pallas kernels cast them: p is rounded to bf16 (cvt.rn) before p v (:161)
// and p^T do (:292), ds before ds^T q (:295) and ds k (:336), each output
// once at the end. The masks, loop bounds, tile skipping and the one-writer
// rule are the f32 kernels'.
//
//   flash_fwd_bf16_kernel     <- _fwd_kernel     (pallas_attention.py:97)
//   flash_bwd_dkv_bf16_kernel <- _bwd_dkv_kernel (pallas_attention.py:259)
//   flash_bwd_dq_bf16_kernel  <- _bwd_dq_kernel  (pallas_attention.py:304)
//
// Bound: at the train shape (B = 32, H = 12, S = 512, D = 64, causal) a
// kernel does 2-4 products of S^2 D / 2 multiply-adds per (b, h) while it
// moves 3-6 S x D bf16 slabs once: 85-128 operations per byte, below the
// card's ~295 for bf16 (989 TFLOP/s over 3.35 TB/s), so the least time is
// set by the bytes. A block's loop is short there (1-8 tiles of 64), so
// what the kernels must hide is the latency of each tile's loads and of the
// block's own prologue (its owned rows and first stage) and epilogue.
//
// All three are built for Hopper (wgmma_bf16.cuh). Times below: NVIDIA
// H100 80GB HBM3 at 700 W, the train shape, CUDA graphs of 20 calls
// (chip_smoke.py; PERF.md has the runs).
//   * Warp specialisation. A block is one consumer warpgroup, which owns 64
//     rows (queries in K1 and K3, keys in K2) and runs every product as wgmma,
//     and one producer warp, which keeps TMA loads of the streamed tiles in
//     flight through a ring of stages (3; 2 for K1 and K3 at D = 128). Each
//     stage has a full mbarrier (TMA bytes plus the producer warp's 32
//     arrivals, after it stored the stage's short rows: segment ids, lse,
//     delta) and an empty one (one arrival per consumer warp once the warp's
//     products have read the stage). Blocks of 160 threads fit 3 (K1, K3) or 2
//     (K2) to an SM at D <= 64, so one block's prologue, softmax and epilogue
//     overlap the others' products. Alternatives measured on earlier versions
//     of K1 and K2 in development chip runs (same card, chip_smoke._graph_ms):
//     a producer warpgroup with setmaxnreg (24 / 232 registers): ptxas
//     allocates one budget for the whole kernel, so at two blocks an SM it
//     capped the consumer at 128 registers and K2 spilled (K1 0.125 ms, K2
//     0.20), and at one block an SM only one consumer ran (0.165, 0.23); two
//     consumer warpgroups sharing each stage (128 rows a block): 288 threads
//     allocate registers as 384, so one block an SM (K1 0.070, K2 0.143); two
//     64-row tiles per warpgroup in K1: spills at the 168-register cap (0.097);
//     the next tile's q k^T issued during the softmax (double s accumulators):
//     0.087. This form: K1 0.061, K2 0.117 (the mma.sync kernels they replace:
//     0.092, 0.174).
//   * The masks cost one compare a score: each row (K1, K3) or key (K2) carries
//     the limit that causality and the ragged edge set, and segment ids are
//     read as int2 pairs. The first version tested visible() per score; ptxas
//     turned that into predicated code on every tile, masked or not, which took
//     2,300 of the 4,400 cycles a tile (clock64 spans of an instrumented
//     development build).
//   * TMA. q, k, v, do are read through 3-D tensor maps [B*H, S, D] (rows
//     past S zero-filled by the hardware: a 2-D map over B*H*S rows would
//     read the next head's rows), with the swizzle the wgmma descriptors
//     name. The short f32 and int rows (lse, delta, segment ids: no 16-byte
//     alignment at odd S) go by plain loads of the producer warp into the
//     stage.
//   * K1: s = q k^T as wgmma m64n64k16 with q (loaded once) and k K-major in
//     shared memory; the online softmax on the accumulator registers (the
//     m16n8 layout per 8 columns, so the quad shuffles are those of the f32
//     kernel; maxima and sums in 4 partial chains a row); the scale goes into
//     the exponent; p rounded to bf16 by cvt.rn.bf16x2 becomes the register A
//     operand of o += p v (m64nDk16, v MN-major through the descriptor's
//     transpose). Key tiles of kFwdKeyTileBf16 = 64, which the plain
//     version's default block_k follows (p is rounded against the same
//     running max).
//   * K2: the block's k and v stay in shared memory (one TMA load); q, do,
//     lse, delta and the query segment ids stream through the ring, 64 query
//     rows a stage (32 at D = 128). s^T = k q^T and dp^T = v do^T as wgmma
//     with k and v as A; p^T and ds^T go from the accumulators to bf16
//     register A operands of dv += p^T do and dk += ds^T q (do and q
//     MN-major). lse and delta are read as float2, once per 8 columns.
//   * K3: the block's q and do are loaded once (TMA, beside the first stage),
//     and its rows' lse and delta once into registers (two rows a thread) while
//     those loads fly; k, v and the key segment ids stream through the ring, 64
//     key rows a stage at every D (kDqKeyTileBf16). s = q k^T and dp = do v^T
//     as wgmma m64n64k16 (q, do, k, v K-major), issued before one wait; p =
//     exp(scale s - lse) straight from the stored lse (one ex2 of an FMA: no
//     running max) and ds = p (dp scale - delta scale) on the accumulators; ds
//     rounded to bf16 becomes the register A operand of dq += ds k (m64nDk16),
//     k being the same stage read MN-major through the descriptor's transpose,
//     so no tile is copied. dq stays in f32 accumulators across the loop and is
//     written once. Forms measured in development chip runs
//     (chip_smoke._graph_ms; train shape / S = 4,096, B = 1): 2 blocks an SM
//     0.074-0.076 / 0.115-0.117 ms (3 stages; 2 stages 0.076 / 0.111, 4 stages
//     0.074 / 0.110), this form at 3 blocks an SM (128 registers, no spill)
//     0.064-0.066 / 0.115-0.120 (2 stages the same within the spread); the dq
//     product of tile kt left in flight while tile kt + 1's s and dp are
//     issued: ptxas serialises the wgmma (C7518, the accumulators in flight
//     across the loop's branches), 0.089 / 0.147 at 2 blocks and 0.072 / 0.137
//     at 3. The mma.sync kernel it replaces: 0.132 / 0.230. At D = 128 three
//     blocks an SM cap the registers at 128 and spill, so two.
//   * What still limits K1 and K2 (clock64 spans of an instrumented development
//     build, per K1 block of 4.5 tiles at the train shape: 12.5k cycles): the
//     softmax on the accumulators (4.1k), waiting for q (1.7k) and for stages
//     (0.9k), the two products (2.5k, latency: the tensor pipe is idle during
//     the softmax unless another block fills it) and the epilogue (1.7k).
//     Halving the softmax's instructions moved nothing, so it is latency, not
//     instruction throughput.
//   * Each output element still has one writer (no atomics), so launches are
//     bitwise repeatable.
//   * Waits on an mbarrier trap after kMbarMaxPolls polls: a protocol fault
//     fails the launch instead of hanging the card.

constexpr int kFwdKeyTileBf16 = 64;  // K1's key tile (flash_kernels.FWD_KEY_TILE_BF16)
constexpr int kWsThreads = kWarpgroup + 32;  // consumer warpgroup + producer warp
constexpr int kDqKeyTileBf16 = 64;  // K3's key tile

// K1 bf16: shared memory (byte offsets from a 1,024-byte boundary)
template <int D>
struct FwdBf16 {
  static constexpr int BK = kFwdKeyTileBf16;
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kBlocksPerSm = D == 128 ? 2 : 3;
  static constexpr int kTileQ = kOwn * D * 2;  // q
  static constexpr int kTileK = BK * D * 2;    // k or v
  static constexpr int kQ = 0;
  static constexpr int kRing = kTileQ;  // stage st: k at kRing + 2 st kTileK, v after it
  static constexpr int kSeg = kRing + kStages * 2 * kTileK;  // key segment ids [kStages][BK]
  static constexpr int kBar = kSeg + kStages * BK * 4;       // full, empty [kStages]; q
  static constexpr size_t bytes = kBar + (2 * kStages + 1) * 8 + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, FwdBf16<D>::kBlocksPerSm)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, const int* __restrict__ seg,
                      uint16_t* __restrict__ o, float* __restrict__ lse, int H, int S, int causal,
                      float scale) {
  using L = FwdBf16<D>;
  constexpr int BK = L::BK, NT = BK / 8, KS = D / 16, ST = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  int* segk_all = reinterpret_cast<int*>(sm + L::kSeg);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int nt = (S + kOwn - 1) / kOwn;
  const int qt = nt - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int q0 = qt * kOwn;
  const int* seg_b = seg != nullptr ? seg + (size_t)(bh / H) * S : nullptr;
  // causal: the k tiles up to the last real query of the tile
  const int nk = causal ? (min(q0 + kOwn, S) + BK - 1) / BK : (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], 4);  // one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroup) {
    // producer warp: q once, then k, v (and the key segment ids) of tile kt
    // into stage kt % ST once the consumer has released it
    const int lane = threadIdx.x - kWarpgroup;
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, L::kTileQ);
      tma_rows<D, kOwn>(sm + L::kQ, &q_map, qbar, q0, bh);
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % ST;
      mbar_wait(&empty[st], ((kt / ST) & 1) ^ 1);
      const int k0 = kt * BK;
      if (seg_b != nullptr)
        for (int i = lane; i < BK; i += 32) segk_all[st * BK + i] = k0 + i < S ? seg_b[k0 + i] : 0;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], 2 * L::kTileK);
        unsigned char* kv = sm + L::kRing + st * 2 * L::kTileK;
        tma_rows<D, BK>(kv, &k_map, &full[st], k0, bh);
        tma_rows<D, BK>(kv + L::kTileK, &v_map, &full[st], k0, bh);
      } else {
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // consumer warpgroup: warp w owns query rows 16w .. 16w + 15 of the tile
    const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) / 4, t = threadIdx.x & 3;
    // row h (q0 + 16w + g + 8h) sees the keys c < lim[h] (causality and the
    // ragged edge; none for a row past S) whose segment id is segq[h]
    int lim[2], segq[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * warp + g + 8 * h;
      lim[h] = row >= S ? -1 : causal ? min(row + 1, S) : S;
      if (seg_b != nullptr && row < S) segq[h] = seg_b[row];
    }
    int q_lo = 0, q_hi = 0;
    if (seg_b != nullptr) seg_range_rows<kOwn>(seg_b + q0, min(kOwn, S - q0), q_lo, q_hi);
    const uint32_t q_s = smem_u32(sm + L::kQ);
    float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
    float o_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
    mbar_wait(qbar, 0);
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % ST;
      mbar_wait(&full[st], (kt / ST) & 1);
      const int k0 = kt * BK;
      const int* sk = segk_all + st * BK;
      bool live = true;
      if (seg_b != nullptr) {
        int k_lo, k_hi;
        seg_range_rows<BK>(sk, min(BK, S - k0), k_lo, k_hi);
        live = !(k_hi < q_lo || k_lo > q_hi);
      }
      if (live) {
        const uint32_t k_s = smem_u32(sm + L::kRing + st * 2 * L::kTileK);
        const uint32_t v_s = k_s + L::kTileK;
        float s[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_ss<BK>(s, desc_k<D, kOwn>(q_s, kk), desc_k<D, BK>(k_s, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        // scores stay q.k: the scale goes into the exponent below
        const bool needs_mask =
            (causal && k0 + BK - 1 > q0) || k0 + BK > S || q0 + kOwn > S || seg_b != nullptr;
        if (needs_mask) {  // one compare a score (and the ids): no per-element branches
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            int2 sv = make_int2(0, 0);
            if (seg_b != nullptr) sv = *reinterpret_cast<const int2*>(sk + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              bool ok = k0 + 8 * j + 2 * t + (e & 1) < lim[e >> 1];
              if (seg_b != nullptr) ok = ok && segq[e >> 1] == ((e & 1) ? sv.y : sv.x);
              s[4 * j + e] = ok ? s[4 * j + e] : kNegInf;
            }
          }
        }
        // row maxima over 4 partial chains a row (i = 4j + e: row e / 2)
        float pm[2][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) pm[i >> 2][i & 3] = kNegInf;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          pm[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)] =
              fmaxf(pm[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)], s[i]);
        float corr[2], neg_m2[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = fmaxf(fmaxf(pm[h][0], pm[h][1]), fmaxf(pm[h][2], pm[h][3]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // the running max in scaled units; a row that has seen no visible
          // key keeps kNegInf, as the plain version does
          mx = mx > 0.5f * kNegInf ? mx * scale : kNegInf;
          const float m_new = fmaxf(m_r[h], mx);
          corr[h] = ex2((m_r[h] - m_new) * kLog2e);
          neg_m2[h] = -m_new * kLog2e;
          m_r[h] = m_new;
        }
        // p in f32 (the row sum takes it unrounded, in 4 partial sums a row),
        // then o = o corr + p v. Without a masked score every row's max is
        // finite and no p needs the guard.
        const float scale2 = scale * kLog2e;
        float ps[2][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) ps[i >> 2][i & 3] = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const float x = s[i];
          float p = ex2(fmaf(x, scale2, neg_m2[(i >> 1) & 1]));
          if (needs_mask) p = x > 0.5f * kNegInf ? p : 0.f;
          s[i] = p;
          ps[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)] += p;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          l_r[h] = l_r[h] * corr[h] + ((ps[h][0] + ps[h][1]) + (ps[h][2] + ps[h][3]));
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o_acc[i] *= corr[(i >> 1) & 1];
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int m = 0; m < BK / 16; ++m) acc_as_a16(s, m, pa[m]);
        fence_regs(o_acc);  // the rescale and the packing land before the fence
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int m = 0; m < BK / 16; ++m) wgmma_rs<D>(o_acc, pa[m], desc_mn<D, BK>(v_s, m), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o_acc);
        fence_regs(pa);
      }
      __syncwarp();  // the warp's reads of the stage are done
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
      l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
      const float li = fmaxf(l_r[h], 1e-30f);
      const float inv = 1.f / li;
      const int row = q0 + 16 * warp + g + 8 * h;
      if (row < S) {
        uint16_t* orow = o + ((size_t)bh * S + row) * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
              pack_bf16(o_acc[4 * n + 2 * h] * inv, o_acc[4 * n + 2 * h + 1] * inv);
        if (t == 0) lse[(size_t)bh * S + row] = m_r[h] + logf(li);
      }
    }
  }
}

// K2 bf16: shared memory (byte offsets from a 1,024-byte boundary). Query
// rows a stage: 64, 32 at D = 128 (dk and dv take 128 accumulator
// registers there).
template <int D>
struct DkvBf16 {
  static constexpr int BQ = D == 128 ? 32 : 64;
  static constexpr int kStages = 3;
  static constexpr int kBlocksPerSm = D == 128 ? 1 : 2;
  static constexpr int kTileOwn = kOwn * D * 2;  // k or v
  static constexpr int kTileQ = BQ * D * 2;      // q or do
  static constexpr int kK = 0, kV = kTileOwn;
  static constexpr int kRing = 2 * kTileOwn;  // stage st: q at kRing + 2 st kTileQ, do after it
  static constexpr int kVec = kRing + kStages * 2 * kTileQ;  // stage st: lse, delta, seg [BQ]
  static constexpr int kBar = kVec + kStages * 3 * BQ * 4;   // full, empty [kStages]; k, v
  static constexpr size_t bytes = kBar + (2 * kStages + 1) * 8 + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, DkvBf16<D>::kBlocksPerSm)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ seg, uint16_t* __restrict__ dk,
                          uint16_t* __restrict__ dv, int H, int S, int causal, float scale) {
  using L = DkvBf16<D>;
  constexpr int BQ = L::BQ, NT = BQ / 8, KS = D / 16, ST = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + ST;
  uint64_t* kvbar = empty + ST;
  // stage st's lse, delta [BQ] f32 and query segment ids [BQ]
  auto vec = [&](int st) { return reinterpret_cast<float*>(sm + L::kVec) + st * 3 * BQ; };

  const int kt = blockIdx.x;  // longest causal key tiles first
  const int bh = blockIdx.y;
  const int k0 = kt * kOwn;
  const size_t rbase = (size_t)bh * S;
  const int* seg_b = seg != nullptr ? seg + (size_t)(bh / H) * S : nullptr;
  const int nq = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], 4);  // one arrival a consumer warp
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroup) {
    // producer warp: k and v once, then q, do, lse, delta (and the query
    // segment ids) of tile qt into stage (qt - qt0) % ST
    {
      const int lane = threadIdx.x - kWarpgroup;
      if (lane == 0) {
        mbar_arrive_expect_tx(kvbar, 2 * L::kTileOwn);
        tma_rows<D, kOwn>(sm + L::kK, &k_map, kvbar, k0, bh);
        tma_rows<D, kOwn>(sm + L::kV, &v_map, kvbar, k0, bh);
      }
      for (int qt = qt0; qt < nq; ++qt) {
        const int i = qt - qt0, st = i % ST;
        mbar_wait(&empty[st], ((i / ST) & 1) ^ 1);
        const int q0 = qt * BQ;
        float* ls = vec(st);
        int* sq = reinterpret_cast<int*>(ls + 2 * BQ);
        for (int r = lane; r < BQ; r += 32) {
          const bool ok = q0 + r < S;
          ls[r] = ok ? lse[rbase + q0 + r] : 0.f;
          ls[BQ + r] = ok ? delta[rbase + q0 + r] : 0.f;
          if (seg_b != nullptr) sq[r] = ok ? seg_b[q0 + r] : 0;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], 2 * L::kTileQ);
          unsigned char* qd = sm + L::kRing + st * 2 * L::kTileQ;
          tma_rows<D, BQ>(qd, &q_map, &full[st], q0, bh);
          tma_rows<D, BQ>(qd + L::kTileQ, &do_map, &full[st], q0, bh);
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    // consumer warpgroup: warp w owns key rows 16w .. 16w + 15 of the tile
    const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) / 4, t = threadIdx.x & 3;
    const int kw = warp * 16;
    // key row h (k0 + kw + g + 8h) is seen by the queries r >= lo[h]
    // (causality; none for a key past S) whose segment id is segk[h]
    int lo[2], segk[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = k0 + kw + g + 8 * h;
      lo[h] = c >= S ? INT_MAX : causal ? c : 0;
      if (seg_b != nullptr && c < S) segk[h] = seg_b[c];
    }
    int k_lo = 0, k_hi = 0;
    if (seg_b != nullptr) seg_range_rows<kOwn>(seg_b + k0, min(kOwn, S - k0), k_lo, k_hi);
    const uint32_t k_s = smem_u32(sm + L::kK), v_s = smem_u32(sm + L::kV);
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kvbar, 0);
    for (int qt = qt0; qt < nq; ++qt) {
      const int i = qt - qt0, st = i % ST;
      mbar_wait(&full[st], (i / ST) & 1);
      const int q0 = qt * BQ;
      const float* ls = vec(st);
      const float* dl = ls + BQ;
      const int* sq = reinterpret_cast<const int*>(ls + 2 * BQ);
      bool live = true;
      if (seg_b != nullptr) {
        int q_lo, q_hi;
        seg_range_rows<BQ>(sq, min(BQ, S - q0), q_lo, q_hi);
        live = !(k_hi < q_lo || k_lo > q_hi);
      }
      if (live) {
        const uint32_t q_s = smem_u32(sm + L::kRing + st * 2 * L::kTileQ);
        const uint32_t do_s = q_s + L::kTileQ;
        // s^T and dp^T: key rows kw + g (+8), query columns
        float s[BQ / 2], dp[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_ss<BQ>(s, desc_k<D, kOwn>(k_s, kk), desc_k<D, BQ>(q_s, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_ss<BQ>(dp, desc_k<D, kOwn>(v_s, kk), desc_k<D, BQ>(do_s, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        const bool needs_mask =
            (causal && k0 + kOwn - 1 > q0) || q0 + BQ > S || k0 + kOwn > S || seg_b != nullptr;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 lv = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
          const float2 dv2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
          const float2 dsc = make_float2(-dv2.x * scale, -dv2.y * scale);  // ds = p (dp scale - delta scale)
          int2 sv = make_int2(0, 0);
          if (needs_mask && seg_b != nullptr) sv = *reinterpret_cast<const int2*>(sq + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = q0 + 8 * j + 2 * t + (e & 1);
            float p = ex2(fmaf(s[4 * j + e], scale * kLog2e, -((e & 1) ? lv.y : lv.x) * kLog2e));
            if (needs_mask) {  // one compare a score (and the ids): no per-element branches
              bool ok = r >= lo[e >> 1] && r < S;
              if (seg_b != nullptr) ok = ok && segk[e >> 1] == ((e & 1) ? sv.y : sv.x);
              p = ok ? p : 0.f;
            }
            s[4 * j + e] = p;
            dp[4 * j + e] = p * fmaf(dp[4 * j + e], scale, (e & 1) ? dsc.y : dsc.x);
          }
        }
        // dv += p^T do, dk += ds^T q: p^T and ds^T rounded to bf16 as A
        uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
        for (int m = 0; m < BQ / 16; ++m) {
          acc_as_a16(s, m, pa[m]);
          acc_as_a16(dp, m, dsa[m]);
        }
        fence_regs(pa);  // the packing lands before the fence
        fence_regs(dsa);
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int m = 0; m < BQ / 16; ++m) wgmma_rs<D>(dv_acc, pa[m], desc_mn<D, BQ>(do_s, m), 1);
#pragma unroll
        for (int m = 0; m < BQ / 16; ++m) wgmma_rs<D>(dk_acc, dsa[m], desc_mn<D, BQ>(q_s, m), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pa);
        fence_regs(dsa);
      }
      __syncwarp();  // the warp's reads of the stage are done
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = k0 + kw + g + 8 * h;
      if (c >= S) continue;
      uint16_t* dkr = dk + ((size_t)bh * S + c) * D;
      uint16_t* dvr = dv + ((size_t)bh * S + c) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dkr + 8 * n + 2 * t) =
            pack_bf16(dk_acc[4 * n + 2 * h], dk_acc[4 * n + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dvr + 8 * n + 2 * t) =
            pack_bf16(dv_acc[4 * n + 2 * h], dv_acc[4 * n + 2 * h + 1]);
      }
    }
  }
}

// K3 bf16: shared memory (byte offsets from a 1,024-byte boundary). Key
// rows a stage: 64 (kDqKeyTileBf16).
template <int D>
struct DqBf16 {
  static constexpr int BK = kDqKeyTileBf16;
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kBlocksPerSm = D == 128 ? 2 : 3;
  static constexpr int kTileOwn = kOwn * D * 2;  // q or do
  static constexpr int kTileK = BK * D * 2;      // k or v
  static constexpr int kQ = 0, kDo = kTileOwn;
  static constexpr int kRing = 2 * kTileOwn;  // stage st: k at kRing + 2 st kTileK, v after it
  static constexpr int kSeg = kRing + kStages * 2 * kTileK;  // key segment ids [kStages][BK]
  static constexpr int kBar = kSeg + kStages * BK * 4;       // full, empty [kStages]; q and do
  static constexpr size_t bytes = kBar + (2 * kStages + 1) * 8 + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, DqBf16<D>::kBlocksPerSm)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ seg, uint16_t* __restrict__ dq, int H, int S,
                         int causal, float scale) {
  using L = DqBf16<D>;
  constexpr int BK = L::BK, NT = BK / 8, KS = D / 16, ST = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  int* segk_all = reinterpret_cast<int*>(sm + L::kSeg);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int nt = (S + kOwn - 1) / kOwn;
  const int qt = nt - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int q0 = qt * kOwn;
  const size_t rbase = (size_t)bh * S;
  const int* seg_b = seg != nullptr ? seg + (size_t)(bh / H) * S : nullptr;
  // causal: the k tiles up to the last real query of the tile
  const int nk = causal ? (min(q0 + kOwn, S) + BK - 1) / BK : (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], 4);  // one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroup) {
    // producer warp: q and do once, then k, v (and the key segment ids) of
    // tile kt into stage kt % ST once the consumer has released it; all in
    // flight together at the start
    const int lane = threadIdx.x - kWarpgroup;
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, 2 * L::kTileOwn);
      tma_rows<D, kOwn>(sm + L::kQ, &q_map, qbar, q0, bh);
      tma_rows<D, kOwn>(sm + L::kDo, &do_map, qbar, q0, bh);
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % ST;
      mbar_wait(&empty[st], ((kt / ST) & 1) ^ 1);
      const int k0 = kt * BK;
      if (seg_b != nullptr)
        for (int i = lane; i < BK; i += 32) segk_all[st * BK + i] = k0 + i < S ? seg_b[k0 + i] : 0;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], 2 * L::kTileK);
        unsigned char* kv = sm + L::kRing + st * 2 * L::kTileK;
        tma_rows<D, BK>(kv, &k_map, &full[st], k0, bh);
        tma_rows<D, BK>(kv + L::kTileK, &v_map, &full[st], k0, bh);
      } else {
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // consumer warpgroup: warp w owns query rows 16w .. 16w + 15 of the tile
    const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) / 4, t = threadIdx.x & 3;
    // row h (q0 + 16w + g + 8h) sees the keys c < lim[h] (causality and the
    // ragged edge; none for a row past S) whose segment id is segq[h]; its
    // lse (in base-2 units) and -delta scale are read once, while the first
    // loads are in flight
    int lim[2], segq[2] = {0, 0};
    float lse2[2], dsc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * warp + g + 8 * h;
      const bool ok = row < S;
      lim[h] = !ok ? -1 : causal ? min(row + 1, S) : S;
      lse2[h] = ok ? lse[rbase + row] * kLog2e : 0.f;
      dsc[h] = ok ? -delta[rbase + row] * scale : 0.f;
      if (seg_b != nullptr && ok) segq[h] = seg_b[row];
    }
    int q_lo = 0, q_hi = 0;
    if (seg_b != nullptr) seg_range_rows<kOwn>(seg_b + q0, min(kOwn, S - q0), q_lo, q_hi);
    const uint32_t q_s = smem_u32(sm + L::kQ), do_s = smem_u32(sm + L::kDo);
    const float scale2 = scale * kLog2e;
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    mbar_wait(qbar, 0);
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % ST;
      mbar_wait(&full[st], (kt / ST) & 1);
      const int k0 = kt * BK;
      const int* sk = segk_all + st * BK;
      bool live = true;
      if (seg_b != nullptr) {
        int k_lo, k_hi;
        seg_range_rows<BK>(sk, min(BK, S - k0), k_lo, k_hi);
        live = !(k_hi < q_lo || k_lo > q_hi);
      }
      if (live) {
        const uint32_t k_s = smem_u32(sm + L::kRing + st * 2 * L::kTileK);
        const uint32_t v_s = k_s + L::kTileK;
        // s = q k^T and dp = do v^T: query rows, key columns
        float s[BK / 2], dp[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_ss<BK>(s, desc_k<D, kOwn>(q_s, kk), desc_k<D, BK>(k_s, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_ss<BK>(dp, desc_k<D, kOwn>(do_s, kk), desc_k<D, BK>(v_s, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // p = exp(scale s - lse) from the stored lse (no running max), then
        // ds = p (dp scale - delta scale) in place of dp
        const bool needs_mask =
            (causal && k0 + BK - 1 > q0) || k0 + BK > S || q0 + kOwn > S || seg_b != nullptr;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          int2 sv = make_int2(0, 0);
          if (needs_mask && seg_b != nullptr) sv = *reinterpret_cast<const int2*>(sk + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(s[4 * j + e], scale2, -lse2[e >> 1]));
            if (needs_mask) {  // one compare a score (and the ids): no per-element branches
              bool ok = k0 + 8 * j + 2 * t + (e & 1) < lim[e >> 1];
              if (seg_b != nullptr) ok = ok && segq[e >> 1] == ((e & 1) ? sv.y : sv.x);
              p = ok ? p : 0.f;
            }
            dp[4 * j + e] = p * fmaf(dp[4 * j + e], scale, dsc[e >> 1]);
          }
        }
        // dq += ds k: ds rounded to bf16 as the register A operand, k the
        // same stage read MN-major
        uint32_t dsa[BK / 16][4];
#pragma unroll
        for (int m = 0; m < BK / 16; ++m) acc_as_a16(dp, m, dsa[m]);
        fence_regs(dsa);  // the packing lands before the fence
        fence_regs(dq_acc);
        wgmma_fence();
#pragma unroll
        for (int m = 0; m < BK / 16; ++m) wgmma_rs<D>(dq_acc, dsa[m], desc_mn<D, BK>(k_s, m), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_acc);
        fence_regs(dsa);
      }
      __syncwarp();  // the warp's reads of the stage are done
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * warp + g + 8 * h;
      if (row >= S) continue;
      uint16_t* dqr = dq + (rbase + row) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dqr + 8 * n + 2 * t) =
            pack_bf16(dq_acc[4 * n + 2 * h], dq_acc[4 * n + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch helpers

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse,
               int B, int H, int S, int causal, cudaStream_t stream) {
  const size_t smem = FwdSmem<D>::bytes;
  cudaError_t e = allow_smem(flash_fwd_3xtf32_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kOwn - 1) / kOwn, B * H);
  flash_fwd_3xtf32_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<float*>(o), static_cast<float*>(lse), H, S,
      causal, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* seg, void* dk, void* dv, int B, int H, int S,
               int causal, cudaStream_t stream) {
  const size_t smem = DkvSmem<D>::bytes;
  cudaError_t e = allow_smem(flash_bwd_dkv_3xtf32_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kOwn - 1) / kOwn, B * H);
  flash_bwd_dkv_3xtf32_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
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
  const size_t smem = DqSmem<D>::bytes;
  cudaError_t e = allow_smem(flash_bwd_dq_3xtf32_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kOwn - 1) / kOwn, B * H);
  flash_bwd_dq_3xtf32_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), static_cast<float*>(dq), H,
      S, causal, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd_bf16(const void* q, const void* k, const void* v, const void* seg, void* o,
                    void* lse, int B, int H, int S, int causal, cudaStream_t stream) {
  using L = FwdBf16<D>;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t e = bf16_rows_map(&q_map, q, B * H, S, D, kOwn);
  if (e == cudaSuccess) e = bf16_rows_map(&k_map, k, B * H, S, D, L::BK);
  if (e == cudaSuccess) e = bf16_rows_map(&v_map, v, B * H, S, D, L::BK);
  if (e == cudaSuccess) e = allow_smem(flash_fwd_bf16_kernel<D>, L::bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kOwn - 1) / kOwn, B * H);
  flash_fwd_bf16_kernel<D><<<grid, kWsThreads, L::bytes, stream>>>(
      q_map, k_map, v_map, static_cast<const int*>(seg), static_cast<uint16_t*>(o),
      static_cast<float*>(lse), H, S, causal, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, const void* seg, void* dk, void* dv, int B,
                    int H, int S, int causal, cudaStream_t stream) {
  using L = DkvBf16<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t e = bf16_rows_map(&q_map, q, B * H, S, D, L::BQ);
  if (e == cudaSuccess) e = bf16_rows_map(&do_map, dout, B * H, S, D, L::BQ);
  if (e == cudaSuccess) e = bf16_rows_map(&k_map, k, B * H, S, D, kOwn);
  if (e == cudaSuccess) e = bf16_rows_map(&v_map, v, B * H, S, D, kOwn);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dkv_bf16_kernel<D>, L::bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kOwn - 1) / kOwn, B * H);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kWsThreads, L::bytes, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), H, S, causal, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* seg, void* dq, int B, int H,
                   int S, int causal, cudaStream_t stream) {
  using L = DqBf16<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t e = bf16_rows_map(&q_map, q, B * H, S, D, kOwn);
  if (e == cudaSuccess) e = bf16_rows_map(&do_map, dout, B * H, S, D, kOwn);
  if (e == cudaSuccess) e = bf16_rows_map(&k_map, k, B * H, S, D, L::BK);
  if (e == cudaSuccess) e = bf16_rows_map(&v_map, v, B * H, S, D, L::BK);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dq_bf16_kernel<D>, L::bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kOwn - 1) / kOwn, B * H);
  flash_bwd_dq_bf16_kernel<D><<<grid, kWsThreads, L::bytes, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), static_cast<uint16_t*>(dq),
      H, S, causal, 1.0f / sqrtf((float)D));
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

// bf16: q, k, v, do, o, dq, dk, dv bf16; lse, delta f32; otherwise as above
int flash_fwd_bf16(const void* q, const void* k, const void* v, const void* seg, void* o,
                   void* lse, int B, int H, int S, int D, int causal, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_fwd_bf16<32>(q, k, v, seg, o, lse, B, H, S, causal, st);
    case 64: return launch_fwd_bf16<64>(q, k, v, seg, o, lse, B, H, S, causal, st);
    case 128: return launch_fwd_bf16<128>(q, k, v, seg, o, lse, B, H, S, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* seg, void* dk, void* dv,
                       int B, int H, int S, int D, int causal, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dkv_bf16<32>(q, k, v, dout, lse, delta, seg, dk, dv, B, H, S, causal, st);
    case 64:
      return launch_dkv_bf16<64>(q, k, v, dout, lse, delta, seg, dk, dv, B, H, S, causal, st);
    case 128:
      return launch_dkv_bf16<128>(q, k, v, dout, lse, delta, seg, dk, dv, B, H, S, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* seg, void* dq, int B, int H,
                      int S, int D, int causal, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_dq_bf16<32>(q, k, v, dout, lse, delta, seg, dq, B, H, S, causal, st);
    case 64: return launch_dq_bf16<64>(q, k, v, dout, lse, delta, seg, dq, B, H, S, causal, st);
    case 128: return launch_dq_bf16<128>(q, k, v, dout, lse, delta, seg, dq, B, H, S, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1 bf16's key tile: the wrapper checks it against the plain version's
// default block_k (flash_kernels.FWD_KEY_TILE_BF16)
int flash_fwd_bf16_key_tile() { return kFwdKeyTileBf16; }

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
