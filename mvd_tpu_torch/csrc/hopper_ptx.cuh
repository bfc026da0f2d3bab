// Hopper (sm_90a) building blocks in raw PTX: mbarriers, TMA tensor loads,
// wgmma descriptors and instructions, register reallocation. Header only;
// included by the kernels that use them (through flash_common.cuh). A change here
// rebuilds every source under csrc/ (kernels/_build.py compares the mtimes
// of the headers too).

#pragma once

#include <cuda.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// One arrival that also announces `bytes` to come from TMA.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Box of a 3-D tensor map at coordinates (c0 innermost, c1, c2) into shared
// memory at `dst`; completion is counted in bytes on `bar`. Elements outside
// the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory at `src` into
// shared memory at `dst`, both 16-byte aligned; completion is counted in
// bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---------------------------------------------------------------------------
// register reallocation between warpgroups
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Matrix descriptor of an operand in shared memory laid out as TMA's
// 128-byte swizzle writes it: rows of 128 bytes, 8-row groups 1024 bytes
// apart (the stride byte offset). The leading byte offset is unused for a
// K-major operand and for an MN-major one that spans one 64-element atom.
// The tile must start on a 1024-byte boundary; a k-step inside the 128-byte
// row (K-major) adds its byte offset / 16 to the descriptor.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The same for an operand laid out by TMA's 64-byte swizzle: rows of 64
// bytes, 8-row groups 512 bytes apart; the tile starts on a 512-byte
// boundary, and a k-step inside the 64-byte row adds its byte offset / 16.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wgmma instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

#define HOPPER_RW(x) "+f"(x)
#define HOPPER_WO(x) "=f"(x)
#define HOPPER_RWI(x) "+r"(x)
#define HOPPER_WOI(x) "=r"(x)
#define HOPPER_D8(C, d, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), \
    C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define HOPPER_D32(C, d) HOPPER_D8(C, d, 0), HOPPER_D8(C, d, 8), HOPPER_D8(C, d, 16), \
    HOPPER_D8(C, d, 24)
#define HOPPER_D64(C, d) HOPPER_D32(C, d), HOPPER_D8(C, d, 32), HOPPER_D8(C, d, 40), \
    HOPPER_D8(C, d, 48), HOPPER_D8(C, d, 56)
#define HOPPER_R32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_R64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D(64x128, f32) (+)= A(64x16) B(16x128), bf16, both K-major in shared
// memory. ACC = false overwrites D (scale-d 0) and needs no prior value.
// Accumulator layout: warp w of the warpgroup holds rows 16w + g and
// 16w + g + 8 (g = lane / 4); d[4j], d[4j+1] are row 16w + g, columns
// 8j + 2t, 8j + 2t + 1 (t = lane % 4); d[4j+2], d[4j+3] the same columns of
// row 16w + g + 8.
template <bool ACC>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b) {
  if constexpr (ACC) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_D64(HOPPER_RW, d) : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_D64(HOPPER_WO, d) : "l"(a), "l"(b), "r"(0));
  }
}

// D(64x64, f32) += A(64x16, bf16, registers) B(16x64, bf16, shared memory,
// MN-major: B's 64 columns contiguous in each of its 16 rows). A's fragment
// per warp is mma.m16n8k16's: a[0] row g, k 2t..2t+1; a[1] row g + 8;
// a[2] row g, k 2t+8..2t+9; a[3] row g + 8, k 2t+8..; so the accumulator of
// a product, packed to bf16 pairs, is the A operand of the next.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D32(HOPPER_RW, d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64x128, s32) (+)= A(64x32) B(32x128), s8, both K-major in shared memory
// (8-bit operands have no transpose). Integer sums are exact. Accumulator
// layout as wgmma_m64n128k16_ss's.
template <bool ACC>
__device__ __forceinline__ void wgmma_m64n128k32_s8_ss(int (&d)[64], uint64_t a, uint64_t b) {
  if constexpr (ACC) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " HOPPER_R64
        ", %64, %65, p;\n}\n"
        : HOPPER_D64(HOPPER_RWI, d) : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " HOPPER_R64
        ", %64, %65, p;\n}\n"
        : HOPPER_D64(HOPPER_WOI, d) : "l"(a), "l"(b), "r"(0));
  }
}

// D(64x64, s32) += A(64x32, s8, registers) B(32x64, s8, shared memory,
// K-major). A's fragment per warp is mma.m16n8k32's: a[0] row g, k 4t..4t+3
// (byte i is k 4t + i); a[1] row g + 8; a[2] row g, k 16+4t..; a[3] row
// g + 8, k 16+4t...
__device__ __forceinline__ void wgmma_m64n64k32_s8_rs(int (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " HOPPER_R32
      ", {%32, %33, %34, %35}, %36, p;\n}\n"
      : HOPPER_D32(HOPPER_RWI, d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace hopper
