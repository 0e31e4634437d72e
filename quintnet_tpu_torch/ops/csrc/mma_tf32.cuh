// Tensor-core (3xTF32 on mma.sync.m16n8k8) and cp.async helpers for sm_90a,
// shared by flash_attention.cu (K1-K3) and paged_attention.cu (K4's prefill
// path). Each .cu file is built into its own library, so everything here
// lives in an anonymous namespace of the including file.
//
// 3xTF32 (the scheme of CUTLASS's OpMultiplyAddFastF32): each f32 operand x
// is split into big = tf32(x) (rounded to nearest, as cvt.rna) and small =
// tf32(x - big), and big*big + big*small + small*big is accumulated in f32.
// Fragments are loaded from row-major shared-memory tiles whose rows are
// padded to DP + kPad floats (DP a multiple of 8): with (DP + kPad) / 4 odd,
// the 8 rows an ldmatrix phase reads start on 8 distinct 16-byte bank
// groups, and the scalar loads put a warp's 32 lanes on 32 distinct banks.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPad = 4;            // row padding in floats: 16-byte rows, staggered banks
constexpr float kNegInf = -1e30f;  // masked scores, natural-log units
constexpr int kMmaThreads = 128;   // 4 warps, 16 rows of the block's own tile each
constexpr float kLog2e = 1.4426950408889634f;

// f32 -> tf32 with round-to-nearest, ties away (cvt.rna.tf32.f32) on the
// integer pipe: the bit pattern of an f32 whose low 13 mantissa bits are 0
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to ~2^-23 relative: big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

template <int N>
struct Frag {  // an operand fragment, split
  uint32_t big[N], small[N];
};

template <int N>
__device__ __forceinline__ Frag<N> split_frag(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], f.big[i], f.small[i]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b for one 8-deep step at f32 accuracy (CUTLASS's
// OpMultiplyAddFastF32): the two small cross terms, then big x big; small x
// small (~2^-22 relative) is dropped. The sum stays in the tensor core.
__device__ __forceinline__ void mma_3xtf32_tc(float (&c)[4], const Frag<4>& a, const Frag<2>& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// The tensor core truncates its sums (round toward zero), so a long chain of
// steps summed inside it drifts in one direction: on the card, s and dp
// summed over D = 64 that way put dq of a row that sees a single key 1.5e-6
// off, three times what fresh fragments give (dp - delta cancels there). So
// every step of s and dp goes into a fresh fragment, added to the running
// sum on the CUDA cores with round-to-nearest; dk, dv and dq sum one
// streamed tile (4-8 steps) in the tensor core and add it the same way.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Frag<4>& a, const Frag<2>& b) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32_tc(d, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, ~2 ulp
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ldmatrix.x4: four 8 x 4 f32 blocks (8 x 8 of b16 each) of a row-major smem
// tile into four registers; lane l gives the row address of block l / 8
__device__ __forceinline__ void ldmatrix_x4(const float* row, uint32_t (&r)[4]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Fragment loads from row-major smem tiles with a row stride of D + kPad
// floats (272 bytes at D = 64: 4 mod 32 banks). g = lane / 4, t = lane % 4.
// Each pattern below is free of bank conflicts: the 8 rows an ldmatrix phase
// reads start on 8 distinct 16-byte bank groups, and the scalar loads put the
// 32 lanes of a warp on 32 distinct banks.
//
// A (16 x 8, row-major): rows r0.. of the tile, columns c0..c0+7, in one
// ldmatrix.x4 (blocks: rows r0 / r0 + 8 x columns c0 / c0 + 4 -> a0 a1 a2 a3)
template <int D>
__device__ __forceinline__ Frag<4> frag_a(const float* s, int r0, int c0) {
  constexpr int LD = D + kPad;
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  ldmatrix_x4(s + (r0 + (l & 7) + 8 * ((l >> 3) & 1)) * LD + c0 + 4 * (l >> 4), r);
  const float x[4] = {__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
                      __uint_as_float(r[3])};
  return split_frag(x);
}

// B (8 x 8) of x . y^T: B[k][n] = y[n0 + n][c0 + k] (the rows of y are the
// product's columns): banks 4g + t
template <int D>
__device__ __forceinline__ Frag<2> frag_b_t(const float* s, int n0, int c0, int g, int t) {
  constexpr int LD = D + kPad;
  const float* p = s + (n0 + g) * LD + c0 + t;
  const float x[2] = {p[0], p[4]};
  return split_frag(x);
}

// the same for column tiles n0 and n0 + 8 at once, in one ldmatrix.x4
// (blocks: rows n0 / n0 + 8 x columns c0 / c0 + 4)
template <int D>
__device__ __forceinline__ void frag_b_t2(const float* s, int n0, int c0, Frag<2>& b0,
                                          Frag<2>& b1) {
  constexpr int LD = D + kPad;
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  ldmatrix_x4(s + (n0 + (l & 7) + 8 * (l >> 4)) * LD + c0 + 4 * ((l >> 3) & 1), r);
  const float x0[2] = {__uint_as_float(r[0]), __uint_as_float(r[1])};
  const float x1[2] = {__uint_as_float(r[2]), __uint_as_float(r[3])};
  b0 = split_frag(x0);
  b1 = split_frag(x1);
}

// B (8 x 8) of p . y: B[k][n] = y[k0 + k][n0 + n], with the depth index
// permuted (fragment k = t reads row 2t, k = t + 4 reads row 2t + 1) so that
// it matches an A operand taken straight from an accumulator (acc_as_a):
// banks 8t + g and 8t + 4 + g
template <int D>
__device__ __forceinline__ Frag<2> frag_b_n(const float* s, int k0, int n0, int g, int t) {
  constexpr int LD = D + kPad;
  const float* p = s + (k0 + 2 * t) * LD + n0 + g;
  const float x[2] = {p[0], p[LD]};
  return split_frag(x);
}

// The accumulator of an m16n8 product holds (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1); read under the depth permutation of frag_b_n these are
// exactly the A fragment's (g, k), (g+8, k), (g, k+4), (g+8, k+4). So the
// probabilities and score gradients feed the next product from registers,
// with no shuffle and no trip through shared memory.
__device__ __forceinline__ Frag<4> acc_as_a(const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  return split_frag(x);
}

// cp.async: 16 bytes (L2 only), 4 or 8 bytes; src_bytes = 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// lets `kernel` use `bytes` of dynamic shared memory (past the 48 KB default)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
