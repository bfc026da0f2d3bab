// Pieces the flash-attention kernels for Hopper share (flash_attn_fwd.cu: K1,
// K5; flash_attn_bwd.cu: K3a, K3b; flash_attn_int8.cu: K6): head width 64,
// tiles of 128 rows of 128 bytes loaded by TMA with the 128-byte swizzle, the
// two bf16 wgmma products K1 and K3 are built from, the bf16 packing of an
// accumulator into the next product's register A operand, and the host-side
// tensor-map encoding (bf16 and bytes).
// Header only; a change here rebuilds every source under csrc/.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace flash {

using namespace hopper;

constexpr int D = 64;                   // head width
constexpr int ROW_BYTES = D * 2;        // one head's row, bf16: one swizzle row
constexpr int TILE = 128;               // rows of a streamed tile
constexpr int TILE_BYTES = TILE * ROW_BYTES;
constexpr int MAX_DEVICES = 64;         // devices whose launch settings are cached

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = A B^T for a 64-row slab A (64 x D) against a tile B of TILE rows (TILE
// x D), both K-major in shared memory: D / 16 k-steps, each 32 bytes further
// into the swizzled rows; committed as one wgmma group. S is m64n128's
// accumulator (see wgmma_m64n128k16_ss).
__device__ __forceinline__ void issue_scores(float (&s)[64], uint64_t a_desc, uint64_t b_desc) {
  wgmma_m64n128k16_ss<false>(s, a_desc, b_desc);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) wgmma_m64n128k16_ss<true>(s, a_desc + 2 * kk, b_desc + 2 * kk);
  wgmma_commit();
}

// O (64 x D) += P B for P (64 x TILE, bf16 A-fragments in registers, see
// pack_p) and a tile B of TILE rows of D, read MN-major: TILE / 16 k-steps of
// 16 rows of 128 bytes; committed as one wgmma group.
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[TILE / 16][4],
                                         uint64_t b_desc) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) wgmma_m64n64k16_rs(o, p[kk], b_desc + kk * (16 * ROW_BYTES >> 4));
  wgmma_commit();
}

// An f32 m64n128 accumulator to bf16 A-fragments, one per k-step of 16
// columns: accumulator n8-blocks 2kk and 2kk + 1.
__device__ __forceinline__ void pack_p(uint32_t (&p)[TILE / 16][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  }
}

// Raises the dynamic shared-memory limit of KERNEL to `bytes` on device dev,
// once per kernel and device (the attribute holds per device).
template <auto KERNEL>
cudaError_t allow_smem(int bytes, int dev) {
  static bool done[MAX_DEVICES] = {};
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

// libcuda's cuTensorMapEncodeTiled, looked up at run time (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Tensor map of a bf16 tensor of `outer` blocks of `rows` rows of `row_elems`
// elements, read in boxes of D elements by `box_rows` rows of one block,
// with the 128-byte swizzle. Rows past `rows` arrive as zeros from within the
// same block. Returns the CUresult.
inline int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int row_elems, int rows,
                  int outer, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)row_elems, (cuuint64_t)rows, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)row_elems * 2, (cuuint64_t)row_elems * rows * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return static_cast<int>(fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// Tensor map of a byte tensor of `outer` blocks of `rows` rows of
// `row_bytes` bytes, read in boxes of `box_cols` bytes by `box_rows` rows
// of one block, with the given swizzle (box_cols at most its span). Returns
// the CUresult.
inline int encode_u8(EncodeTiled fn, CUtensorMap* map, const void* ptr, int row_bytes, int rows,
                     int outer, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)row_bytes, (cuuint64_t)rows, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)row_bytes, (cuuint64_t)row_bytes * rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return static_cast<int>(fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims,
                             strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace flash
