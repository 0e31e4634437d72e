// bf16 tensor-core helpers (mma.sync.m16n8k16, bf16 operands, f32
// accumulators) for sm_90a, used by the bf16 kernels of flash_attention.cu.
// Like mma_tf32.cuh (whose cp.async helpers these kernels share), everything
// lives in an anonymous namespace of the including file.
//
// Elements are handled as raw 16-bit patterns (uint16_t): they move by
// cp.async and ldmatrix, and the only conversion is f32 -> bf16 by
// cvt.rn.bf16x2.f32 (round to nearest, ties to even: what torch's
// .to(torch.bfloat16) and JAX's astype do).
//
// Tiles are row-major in shared memory with rows of D + kPadH elements:
// with (D + kPadH) / 8 odd, the 8 rows an ldmatrix phase reads start on 8
// distinct 16-byte bank groups.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4; a register
// holds two bf16, the lower column or depth index in its low half):
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16 x 8):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// so the accumulators of two adjacent n8 tiles are, pair by pair, the A
// fragment of a 16-deep step (acc_pair_as_a): probabilities and score
// gradients feed the next product from registers.

#pragma once

#include <cstdint>

#include "mma_tf32.cuh"

namespace {

constexpr int kPadH = 8;  // row padding in bf16 elements: 16 bytes

// two f32 -> one register of two bf16 (round to nearest even), lo in the
// low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// c += a b over one 16-deep step, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix.x4: four 8 x 8 b16 blocks; lane l gives the row address of block
// l / 8. Plain: lane 4g + t gets (row g, columns 2t, 2t+1) of each block;
// .trans: (rows 2t, 2t+1, column g).
__device__ __forceinline__ void ldsm_x4(const uint16_t* row, uint32_t (&r)[4]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(const uint16_t* row, uint32_t (&r)[4]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// A (16 x 16): rows r0.. of a tile, columns c0..c0+15 (blocks: rows r0 /
// r0 + 8 x columns c0 / c0 + 8 -> a0 a1 a2 a3)
template <int LD>
__device__ __forceinline__ void frag_a16(const uint16_t* s, int r0, int c0, uint32_t (&a)[4]) {
  const int l = threadIdx.x & 31;
  ldsm_x4(s + (r0 + (l & 7) + 8 * ((l >> 3) & 1)) * LD + c0 + 8 * (l >> 4), a);
}

// B of x . y^T (the rows of y are the product's columns) for the column
// tiles n0 and n0 + 8 over depth c0..c0+15: b[0], b[1] for n0 and b[2],
// b[3] for n0 + 8 (blocks: rows n0 / n0 + 8 x columns c0 / c0 + 8)
template <int LD>
__device__ __forceinline__ void frag_bt16(const uint16_t* s, int n0, int c0, uint32_t (&b)[4]) {
  const int l = threadIdx.x & 31;
  ldsm_x4(s + (n0 + (l & 7) + 8 * (l >> 4)) * LD + c0 + 8 * ((l >> 3) & 1), b);
}

// B of p . y (the rows of y are the depth) over depth rows k0..k0+15 for the
// column tiles n0 and n0 + 8, transposed on load: b[0], b[1] for n0 and
// b[2], b[3] for n0 + 8 (blocks: rows k0 / k0 + 8 x columns n0 / n0 + 8)
template <int LD>
__device__ __forceinline__ void frag_bn16(const uint16_t* s, int k0, int n0, uint32_t (&b)[4]) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(s + (k0 + (l & 7) + 8 * ((l >> 3) & 1)) * LD + n0 + 8 * (l >> 4), b);
}

// the accumulators of the n8 tiles 2m and 2m + 1 as the A fragment of the
// next product's 16-deep step m, rounded to bf16
__device__ __forceinline__ void acc_pair_as_a(const float (&c0)[4], const float (&c1)[4],
                                              uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

}  // namespace
