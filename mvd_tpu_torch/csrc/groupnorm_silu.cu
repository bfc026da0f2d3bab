// K2: GroupNorm(+SiLU) forward for Hopper (sm_90a) on NHWC bf16, f32 stats.
//
// Replaces the TPU kernel mvd_tpu/kernels/groupnorm_silu.py:_gn_silu_kernel
// (called by _pallas_gn_silu). Same function: per-channel sum and sum of
// squares in f32, folded to G groups; mean = sum/n, var = sumsq/n - mean^2,
// rstd = rsqrt(var + eps); y = x * (rstd*gamma) + (beta - mean*rstd*gamma),
// then an optional SiLU, stored in bf16.
//
// Bound on the H100: bytes. The function reads x once and writes y once;
// the statistics pass reads x a second time, so the kernel moves 1.5x the
// bytes of the bound. The TPU design ran one program per batch row (B = 4
// programs, which would fill 4 of 132 SMs); here the work is split so that
// every SM is busy at every main-path shape:
//  1. gn_stats: a (row chunk, batch) grid. Each thread owns 8 adjacent
//     channels (one 16-byte load per row) and sums a strided set of rows in
//     registers; the block folds them per channel in shared memory, then per
//     group, and adds its group partials to a (B, G, 2) f32 buffer with one
//     atomic per group and moment;
//  2. gn_apply: the same (row chunk, batch) layout of threads; each thread
//     works out a = rstd*gamma, b = beta - mean*a for its 8 channels from
//     the (B, G, 2) sums once, then y = x*a + b (+ SiLU) in f32 over a few
//     rows with 16-byte loads and stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerThread = 16;
constexpr int kStatThreads = 256;
constexpr int kApplyRows = 4;

__global__ void gn_stats(const __nv_bfloat16* __restrict__ x, float* __restrict__ stats,
                         int HW, int C, int G, int rows_par, int rows_per_block) {
  extern __shared__ float sh[];  // [2 * C]: per-channel sum, then sum of squares
  const int lanes = C / 8;
  const int b = blockIdx.y;
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(row_begin + rows_per_block, HW);
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x % lanes, rp = threadIdx.x / lanes;
  if (rp < rows_par) {
    float s[8], q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
    const __nv_bfloat16* xb = x + (size_t)b * HW * C + lane * 8;
    for (int r = row_begin + rp; r < row_end; r += rows_par) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xb + (size_t)r * C);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        s[2 * j] += f.x;
        q[2 * j] += f.x * f.x;
        s[2 * j + 1] += f.y;
        q[2 * j + 1] += f.y * f.y;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      atomicAdd(&sh[lane * 8 + j], s[j]);
      atomicAdd(&sh[C + lane * 8 + j], q[j]);
    }
  }
  __syncthreads();

  const int cpg = C / G;
  for (int gi = threadIdx.x; gi < G; gi += blockDim.x) {
    float a = 0.f, a2 = 0.f;
    for (int c = gi * cpg; c < (gi + 1) * cpg; ++c) {
      a += sh[c];
      a2 += sh[C + c];
    }
    atomicAdd(&stats[(b * G + gi) * 2], a);
    atomicAdd(&stats[(b * G + gi) * 2 + 1], a2);
  }
}

__global__ void gn_apply(const __nv_bfloat16* __restrict__ x, const float* __restrict__ stats,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         __nv_bfloat16* __restrict__ y, int HW, int C, int G, int rows_par,
                         int rows_per_block, float inv_n, float eps, int silu) {
  const int lanes = C / 8;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % lanes, rp = threadIdx.x / lanes;
  const int c0 = lane * 8;
  const float* sb = stats + b * G * 2;
  const int cpg = C / G;
  // y = x * a + s per channel, a = rstd * gamma, s = beta - mean * a, worked
  // out once per thread for its 8 channels (one group or a few) and kept in
  // registers over its rows
  float a[8], sh[8];
  int g = -1;
  float mean = 0.f, rstd = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int gj = (c0 + j) / cpg;
    if (gj != g) {
      g = gj;
      mean = sb[2 * g] * inv_n;
      rstd = rsqrtf(fmaxf(sb[2 * g + 1] * inv_n - mean * mean, 0.f) + eps);
    }
    a[j] = rstd * gamma[c0 + j];
    sh[j] = beta[c0 + j] - mean * a[j];
  }
  const int row_end = min((blockIdx.x + 1) * rows_per_block, HW);
  const size_t base = (size_t)b * HW * C + c0;
#pragma unroll
  for (int k = 0; k < kApplyRows; ++k) {
    const int r = blockIdx.x * rows_per_block + k * rows_par + rp;
    if (r >= row_end) break;
    const uint4 raw = *reinterpret_cast<const uint4*>(x + base + (size_t)r * C);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 res;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p[j]);
      float y0 = f.x * a[2 * j] + sh[2 * j];
      float y1 = f.y * a[2 * j + 1] + sh[2 * j + 1];
      if (silu) {
        y0 = y0 / (1.f + expf(-y0));
        y1 = y1 / (1.f + expf(-y1));
      }
      o[j] = __floats2bfloat162_rn(y0, y1);
    }
    *reinterpret_cast<uint4*>(y + base + (size_t)r * C) = res;
  }
}

}  // namespace

// x, y: (B, HW, C) bf16 contiguous, 16-byte aligned, C % 8 == 0, C % G == 0;
// gamma, beta: (C,) f32; stats: (B*G*2) f32 scratch. Returns
// cudaGetLastError() after the launches on `stream`.
extern "C" int groupnorm_silu_bf16(const void* x, const void* gamma, const void* beta,
                                   void* y, void* stats, int B, int HW, int C, int G,
                                   float eps, int silu, void* stream) {
  if (B <= 0 || HW <= 0 || C % 8 != 0 || G <= 0 || C % G != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(stats, 0, sizeof(float) * 2 * B * G, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int lanes = C / 8;
  const int rows_par = lanes >= kStatThreads ? 1 : kStatThreads / lanes;
  const int threads = lanes * rows_par;
  if (threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = rows_par * kRowsPerThread;
  const dim3 sgrid((HW + rows_per_block - 1) / rows_per_block, B);
  gn_stats<<<sgrid, threads, 2 * C * sizeof(float), st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(stats), HW, C, G, rows_par,
      rows_per_block);

  const int apply_rows = rows_par * kApplyRows;
  const dim3 agrid((HW + apply_rows - 1) / apply_rows, B);
  gn_apply<<<agrid, threads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<__nv_bfloat16*>(y), HW, C, G, rows_par, apply_rows,
      1.f / (float(HW) * float(C / G)), eps, silu);
  return static_cast<int>(cudaGetLastError());
}
