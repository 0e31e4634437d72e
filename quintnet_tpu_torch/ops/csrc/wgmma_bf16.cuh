// Hopper building blocks for the bf16 flash kernels of flash_attention.cu
// (sm_90a only): warpgroup matrix products (wgmma) on bf16 tiles with f32
// accumulators, their shared-memory matrix descriptors, mbarriers, TMA
// tensor loads, and the host-side encoding of the tensor maps. Like
// mma_tf32.cuh, everything lives in an anonymous namespace of the including
// file.
//
// Tiles. A bf16 tile of ROWS rows x D columns (D in {32, 64, 128}) lies in
// shared memory as D / 64 column blocks of [ROWS][64] (D >= 64: rows of
// 128 bytes, 128-byte swizzle) or one block of [ROWS][32] (D = 32: rows of
// 64 bytes, 64-byte swizzle), each block starting on a 1,024-byte boundary.
// The swizzle is the one TMA writes (CU_TENSOR_MAP_SWIZZLE_128B / _64B:
// 16-byte chunk c of row r lands at chunk c ^ (r % 8), resp. c ^ ((r / 2) %
// 4)) and the one the descriptors name, so a tile goes from TMA to wgmma
// untouched and the 8 rows a tensor-core read visits hit distinct banks.
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"; byte fields >> 4):
// start address bits 0-13, leading byte offset (LBO) 16-29, stride byte
// offset (SBO) 32-45, swizzle mode 62-63 (1 = 128 B, 2 = 64 B).
//   K-major (the product's depth runs along the row, as q and k in q k^T):
//     SBO = 8 rows x row bytes (the next 8-row group along M or N); LBO is
//     unused under a swizzle (1). A 16-deep step is 32 bytes further along
//     the row; at D = 128 steps 4-7 lie in the second column block.
//   MN-major (the depth runs down the rows, as v in p v: N along D):
//     SBO = 8 rows x row bytes (the next 8 rows of depth), LBO = the next
//     column block along N (ROWS x 128 bytes at D = 128); a 16-deep step is
//     16 rows further down. wgmma transposes such a B operand on the way in
//     (imm-trans-b = 1, legal for 16-bit types).
//
// Accumulators of wgmma.m64nNk16 (warp w of the warpgroup owns rows 16w ..
// 16w + 15; g = lane / 4, t = lane % 4): d[4j + e] is row 16w + g + 8 (e /
// 2), column 8j + 2t + (e % 2), the m16n8 layout of mma.sync per 8
// columns. A from registers has the m16n8k16 A layout per warp, so the
// accumulators of columns 16m .. 16m + 15 packed in pairs are the A
// operand of depth step m (acc_as_a16): probabilities and score gradients
// feed the next product straight from registers.

#pragma once

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>

namespace {

constexpr int kWarpgroup = 128;  // threads of one warpgroup
// a wait on an mbarrier that has not completed after this many polls means
// a protocol fault: trap (the launch fails) instead of hanging the card
constexpr uint32_t kMbarMaxPolls = 1u << 24;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1,024-byte boundary at or after p (swizzled tiles start there)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == kMbarMaxPolls) __trap();
  }
}

// ---- TMA -----------------------------------------------------------------

// one box of a 3-D tensor map at (c0, c1, c2) into shared memory, counted
// on `bar` as transaction bytes
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// bf16 tile geometry of D columns (see the head of this file)
template <int D>
struct SwTile {
  static_assert(D == 32 || D == 64 || D == 128, "head dim");
  static constexpr int kCols = D < 64 ? D : 64;    // columns of one block
  static constexpr int kRowBytes = 2 * kCols;      // 64 or 128: the swizzle span
  static constexpr int kBlocks = D / kCols;        // column blocks
  static constexpr int kGroup = 8 * kRowBytes;     // bytes of 8 rows (SBO)
};

// rows row0 .. row0 + ROWS - 1 of head bh of a [B*H, S, D] bf16 tensor map
// into the tile at dst, one box per column block (rows past S zero-filled)
template <int D, int ROWS>
__device__ __forceinline__ void tma_rows(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row0, int bh) {
  using T = SwTile<D>;
#pragma unroll
  for (int c = 0; c < T::kBlocks; ++c)
    tma_load_3d(dst + c * ROWS * T::kRowBytes, map, bar, c * T::kCols, row0, bh);
}

// ---- descriptors -----------------------------------------------------------

template <int D>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t mode = SwTile<D>::kRowBytes == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (mode << 62);
}

// depth step kk (columns 16kk .. 16kk + 15) of a K-major ROWS x D tile at
// shared address base
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int kk) {
  using T = SwTile<D>;
  constexpr int steps = T::kCols / 16;  // depth steps per column block
  return gmma_desc<D>(base + (kk / steps) * ROWS * T::kRowBytes + (kk % steps) * 32, 16,
                      T::kGroup);
}

// depth step m (rows 16m .. 16m + 15) of an MN-major ROWS x D tile at
// shared address base, all D columns as N
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int m) {
  using T = SwTile<D>;
  return gmma_desc<D>(base + m * 16 * T::kRowBytes, ROWS * T::kRowBytes, T::kGroup);
}

// ---- bf16 values --------------------------------------------------------------

// Elements are handled as raw 16-bit patterns (uint16_t); the only
// conversion is f32 -> bf16 by cvt.rn.bf16x2.f32 (round to nearest, ties to
// even: what torch's .to(torch.bfloat16) and JAX's astype do). Two f32 ->
// one register of two bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Registers that a wgmma reads or writes must be written before the
// wgmma_fence that precedes it, and must not be touched or reused by the
// compiler before the wgmma_wait that follows it: on both sides each is
// passed through an empty asm that claims to read and write it, which the
// compiler keeps in order with the fence and the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (+)= a b over one 16-deep step, m64nNk16, bf16 in, f32 accumulators
// (d = a b when scale_d == 0). _ss: a and b K-major in shared memory
// (descriptors). _rs: a from registers (A layout above), b MN-major in
// shared memory.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// the accumulators of columns 16m .. 16m + 15 as the A operand of depth
// step m, rounded to bf16 (cvt.rn)
template <int R>
__device__ __forceinline__ void acc_as_a16(const float (&c)[R], int m, uint32_t (&a)[4]) {
  a[0] = pack_bf16(c[8 * m + 0], c[8 * m + 1]);
  a[1] = pack_bf16(c[8 * m + 2], c[8 * m + 3]);
  a[2] = pack_bf16(c[8 * m + 4], c[8 * m + 5]);
  a[3] = pack_bf16(c[8 * m + 6], c[8 * m + 7]);
}

// ---- tensor maps (host) -------------------------------------------------------

using TensorMapEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                          const cuuint64_t*, const cuuint64_t*,
                                          const cuuint32_t*, const cuuint32_t*,
                                          CUtensorMapInterleave, CUtensorMapSwizzle,
                                          CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime's entry
// point query so that the library needs no -lcuda; null if it is missing
inline TensorMapEncodeTiled tensor_map_encoder() {
  static const TensorMapEncodeTiled fn = []() -> TensorMapEncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<TensorMapEncodeTiled>(p);
  }();
  return fn;
}

// A [BH, S, D] bf16 tensor (contiguous, 16-byte aligned) as a 3-D tensor
// map whose box is `rows` rows x one column block (SwTile<D>), swizzled as
// the tiles are. Three dimensions, so a box that runs past row S of one
// head is zero-filled by the hardware instead of reading the next head.
inline cudaError_t bf16_rows_map(CUtensorMap* map, const void* ptr, int BH, int S, int D,
                                 int rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const int cols = D < 64 ? D : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
