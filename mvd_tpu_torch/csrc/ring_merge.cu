// K4m: ring attention's merge of one hop into the running result, in place,
// for Hopper (sm_90a).
//
// Replaces the merge of the TPU ring, mvd_tpu/kernels/ring_attention.py:_merge
// (:104-117, XLA ops between the per-hop Pallas calls there). Per (batch,
// query row, head), over the head's D lanes:
//   m = max(l, l_i),  w = exp(l - m),  w_i = exp(l_i - m)
//   o <- (o * w + o_i * w_i) / (w + w_i)         o f32, o_i bf16 (K1's out)
//   l <- m + log(w + w_i)                        l, l_i f32
// each product, sum and quotient rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn, no contraction), as ring_merge_plain computes them in PyTorch;
// exp and log are expf and logf.
//
// Bound on the H100: its bytes. Per element it reads o (4 bytes) and o_i (2)
// and writes o (4); per head it reads l and l_i and writes l (12 bytes). At
// the 512^2 self sites of a 4-way ring (B1, S4096 a rank, H5, D64) that is
// 13.4 MB, 4.0 us at 3.35 TB/s; at the train shard B6 S9216 H5, 177 MB,
// 53 us. The arithmetic (two exponentials and a log per head, four flops
// per element) is far below that.
//
// Design: one pass, no shared memory. Each thread takes 4 lanes of one head
// (a 16-byte load of o, an 8-byte load of o_i), so D/4 neighbouring threads
// cover one head's row and a warp reads whole 128-byte lines. The first
// thread of a head reads l and l_i once and passes them to the others by
// shuffle; it alone writes the new l, after every thread of the head has its
// copy, so no thread reads a half-updated l. Every (batch, row, head) is
// independent: a NaN or -inf in one touches no other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) ring_merge_kernel(
    float* __restrict__ o, float* __restrict__ lse, const __nv_bfloat16* __restrict__ oi,
    const float* __restrict__ lsei, long long rows, int quads) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long row = t / quads;  // (batch, query row, head)
  const int lane = static_cast<int>(t % quads);
  const bool live = row < rows;
  float l0 = 0.f, l1 = 0.f;
  if (live && lane == 0) {
    l0 = lse[row];
    l1 = lsei[row];
  }
  // every thread of the warp takes part: a row's quads threads are all live
  // or all past the end, since THREADS is a multiple of quads
  l0 = __shfl_sync(0xffffffffu, l0, 0, quads);
  l1 = __shfl_sync(0xffffffffu, l1, 0, quads);
  if (!live) return;
  const float m = fmaxf(l0, l1);
  const float w0 = expf(l0 - m), w1 = expf(l1 - m);
  const float den = __fadd_rn(w0, w1);

  float4* po = reinterpret_cast<float4*>(o) + t;
  const float4 a = *po;
  const uint2 raw = reinterpret_cast<const uint2*>(oi)[t];
  const float2 b01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  auto mix = [&](float x, float y) {
    return __fdiv_rn(__fadd_rn(__fmul_rn(x, w0), __fmul_rn(y, w1)), den);
  };
  *po = make_float4(mix(a.x, b01.x), mix(a.y, b01.y), mix(a.z, b23.x), mix(a.w, b23.y));
  if (lane == 0) lse[row] = __fadd_rn(m, logf(den));
}

}  // namespace

// o: (B, S, heads*head_dim) f32, lse: (B, S, heads) f32, both updated in
// place; oi: like o in bf16; lsei: like lse. All contiguous, o 16-byte and
// oi 8-byte aligned. rows = B * S * heads; head_dim / 4 a power of two from
// 1 to 32. Returns 0 or the CUDA error code after the launch on `stream`.
extern "C" int ring_merge(void* o, void* lse, const void* oi, const void* lsei, long long rows,
                          int head_dim, void* stream) {
  const int quads = head_dim / 4;
  if (rows < 0 || head_dim % 4 || quads < 1 || quads > 32 || (quads & (quads - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const long long threads = rows * quads;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ring_merge_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(o), static_cast<float*>(lse), static_cast<const __nv_bfloat16*>(oi),
      static_cast<const float*>(lsei), rows, quads);
  return static_cast<int>(cudaGetLastError());
}
