// K6q: K6's quantizers as one fused pass in two launches, for Hopper
// (sm_90a): bf16 q, k, v (B, S, H*64) in; K6's int8 operands and f32 scales
// out.
//
// Replaces the quantizers around the TPU kernel's call in
// mvd_tpu/kernels/flash_attention.py:_flash_fwd_packed_int8 (:450-457: K
// smoothing, _quantize_rows, _quantize_heads, _quantize_channels), XLA ops
// in the same jitted program there, about 30 eager PyTorch ops per site in
// the port before. Same function, bit for bit except for the order in which
// K's per-channel sum over the sequence is taken (the port's PyTorch version
// sums in another order, so K's mean, and through it k8 and sk, may differ
// in the last bit):
//   mu[c]   = mean_s k[s, c]                          (K smoothing, per channel)
//   sk[h]   = max(max_{s, c in h} |k - mu|, 1e-6) / 127,  k8 = rint((k - mu) / sk)
//   sq[s,h] = max(max_{c in h} |q[s, c]|, 1e-6) / 127,    q8 = rint(q / sq)
//   sv[c]   = max(max_s |v[s, c]|, 1e-6) / 127,           v8 = rint(v / sv)
// with "/ 127" a multiply by the f32 constant 1/127, every other division
// IEEE (__fdiv_rn, as torch's "/"), rint half to even (as torch.round), and
// the maxima NaN-propagating (as torch.amax and torch.clamp). v8 is written
// transposed, (B, H*64, Sk), with the keys of every 16-key block in K6's
// order (position 4t + i holds key 8 (i / 2) + 2t + i % 2; flash_attn_int8.cu
// says why).
//
// Bound on the H100: its bytes. At B4 S4096^2 H5 it must read q, k and v
// once (31.5 MB) and write the int8 operands and scales once (16.1 MB),
// 0.014 ms at 3.35 TB/s; the arithmetic (a division per element) is far
// below that. The algorithm reads k and v twice (68 MB, 0.020 ms); the
// second read is mostly from L2.
//
// Design, two launches:
//  * k6q_stats: one CTA per (64 channels, 512 keys, batch): per channel the
//    sum, max and min of k and the max |v| over its keys, each thread over
//    its rows, then over the CTA's threads in a fixed order through shared
//    memory, to scratch (B, splits, 4, H*64). The smoothed K's amax needs no
//    pass over k - mu: max_s |k - mu| = max(max k - mu, mu - min k), exact,
//    since subtracting a constant is monotone under f32 rounding;
//  * k6q_quantize: one CTA per (128 rows, head, batch) loads its rows of q,
//    k and v, folds the splits of its head's 64 channels in a fixed order
//    meanwhile (mu, sk, sv; the first row tile of each head stores sk and
//    sv), then quantizes its rows
//    of q, k and v, each thread 4 rows x 8 channels: Q's row amax over the
//    head's 64 channels by shuffles among the 8 threads of a row; V's four
//    rows per thread are keys 2t, 2t+1, 8+2t, 9+2t of a 16-key block, so
//    each channel's four bytes are one word of K6's key order, staged in
//    shared memory and stored as 128-byte channel rows.
// No atomics: the result is bitwise repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int D = 64;                              // head width
constexpr int ROWS = 128;                          // rows per k6q_quantize CTA
constexpr int STAT_ROWS = 512;                     // keys per k6q_stats CTA
constexpr int STAT_CH = 64;                        // channels per k6q_stats CTA (128 bytes a row)
constexpr int THREADS = 256;
constexpr int LANES = THREADS / (STAT_CH / 8);     // row lanes of k6q_stats (8 threads a row)
constexpr int VT_LD = 132;                         // bytes per staged V8^T row (128 + 4)
constexpr float INV127 = static_cast<float>(1.0 / 127.0);  // as torch and JAX round 1/127
constexpr float FLOOR = 1e-6f;

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// 8 bf16 (one 16-byte load) to f32
__device__ __forceinline__ void unpack8(const uint4& w, float (&x)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint32_t to_s8(float x, float scale) {
  return static_cast<uint32_t>(__float2int_rn(__fdiv_rn(x, scale))) & 0xFFu;
}

__global__ void __launch_bounds__(THREADS)
k6q_stats(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
          float* __restrict__ part, int Sk, int HD) {
  __shared__ float red[4][LANES][STAT_CH];
  const int c0 = blockIdx.x * STAT_CH, split = blockIdx.y, b = blockIdx.z;
  const int vec = threadIdx.x % (STAT_CH / 8), lane = threadIdx.x / (STAT_CH / 8);
  const int r_end = min(Sk, (split + 1) * STAT_ROWS);
  float sum[8], mx[8], mn[8], av[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sum[i] = 0.f;
    mx[i] = -INFINITY;
    mn[i] = INFINITY;
    av[i] = 0.f;
  }
  const size_t base = (size_t)b * Sk * HD + c0 + 8 * vec;
#pragma unroll 4
  for (int r = split * STAT_ROWS + lane; r < r_end; r += LANES) {
    float x[8], y[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(k + base + (size_t)r * HD)), x);
    unpack8(__ldg(reinterpret_cast<const uint4*>(v + base + (size_t)r * HD)), y);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sum[i] += x[i];
      mx[i] = max_nan(mx[i], x[i]);
      mn[i] = min_nan(mn[i], x[i]);
      av[i] = max_nan(av[i], fabsf(y[i]));
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red[0][lane][8 * vec + i] = sum[i];
    red[1][lane][8 * vec + i] = mx[i];
    red[2][lane][8 * vec + i] = mn[i];
    red[3][lane][8 * vec + i] = av[i];
  }
  __syncthreads();
  {  // one thread per (statistic, channel), lanes in order
    const int stat = threadIdx.x / STAT_CH, ch = threadIdx.x % STAT_CH;
    float acc = red[stat][0][ch];
    for (int i = 1; i < LANES; ++i) {
      const float x = red[stat][i][ch];
      acc = stat == 0 ? acc + x : stat == 2 ? min_nan(acc, x) : max_nan(acc, x);
    }
    part[(((size_t)b * gridDim.y + split) * 4 + stat) * HD + c0 + ch] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
k6q_quantize(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const float* __restrict__ part,
             int8_t* __restrict__ q8_out, float* __restrict__ sq, int8_t* __restrict__ k8_out,
             float* __restrict__ sk, int8_t* __restrict__ v8t, float* __restrict__ sv, int Sq,
             int Sk, int heads, int splits) {
  __shared__ float mu_s[D], sv_s[D], amax_s[2];
  __shared__ __align__(16) uint8_t vt_s[D * VT_LD];
  const int r0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int HD = heads * D;

  // thread: channels 8 cv .. 8 cv + 7 of the head; rows 16 blk + {2 tq,
  // 2 tq + 1, 8 + 2 tq, 9 + 2 tq} of the tile (positions 4 tq .. 4 tq + 3 of
  // the block in K6's key order). Its loads go out before the statistics are
  // folded.
  const int cv = threadIdx.x & 7, quad = threadIdx.x >> 3, blk = quad >> 2, tq = quad & 3;
  int rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rows[i] = r0 + 16 * blk + 8 * (i >> 1) + 2 * tq + (i & 1);
  const int col = h * D + 8 * cv;
  uint4 wq[4], wk[4], wv[4];
  if (r0 < Sq) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wq[i] = __ldg(reinterpret_cast<const uint4*>(q + ((size_t)b * Sq + rows[i]) * HD + col));
  }
  if (r0 < Sk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t at = ((size_t)b * Sk + rows[i]) * HD + col;
      wk[i] = __ldg(reinterpret_cast<const uint4*>(k + at));
      wv[i] = __ldg(reinterpret_cast<const uint4*>(v + at));
    }
  }

  // fold the splits of this head's channels, in order
  if (threadIdx.x < D) {
    const int c = h * D + threadIdx.x;
    const float* pb = part + (size_t)b * splits * 4 * HD + c;
    float s = 0.f, mx = -INFINITY, mn = INFINITY, av = 0.f;
    for (int i = 0; i < splits; ++i) {
      s += pb[(4 * i) * HD];
      mx = max_nan(mx, pb[(4 * i + 1) * HD]);
      mn = min_nan(mn, pb[(4 * i + 2) * HD]);
      av = max_nan(av, pb[(4 * i + 3) * HD]);
    }
    const float mu = __fdiv_rn(s, static_cast<float>(Sk));
    mu_s[threadIdx.x] = mu;
    const float svc = max_nan(av, FLOOR) * INV127;
    sv_s[threadIdx.x] = svc;
    float am = max_nan(__fsub_rn(mx, mu), __fsub_rn(mu, mn));  // max |k - mu| of the channel
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) am = max_nan(am, __shfl_xor_sync(0xffffffffu, am, o));
    if ((threadIdx.x & 31) == 0) amax_s[threadIdx.x >> 5] = am;
    if (blockIdx.x == 0) sv[(size_t)b * HD + c] = svc;
  }
  __syncthreads();
  const float skh = max_nan(max_nan(amax_s[0], amax_s[1]), FLOOR) * INV127;
  if (blockIdx.x == 0 && threadIdx.x == 0) sk[b * heads + h] = skh;

  if (r0 < Sq) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x[8];
      unpack8(wq[i], x);
      float am = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) am = max_nan(am, fabsf(x[e]));
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) am = max_nan(am, __shfl_xor_sync(0xffffffffu, am, o));
      const float scale = max_nan(am, FLOOR) * INV127;
      const size_t at = (size_t)b * Sq + rows[i];
      uint2 out;
      out.x = to_s8(x[0], scale) | to_s8(x[1], scale) << 8 | to_s8(x[2], scale) << 16 | to_s8(x[3], scale) << 24;
      out.y = to_s8(x[4], scale) | to_s8(x[5], scale) << 8 | to_s8(x[6], scale) << 16 | to_s8(x[7], scale) << 24;
      *reinterpret_cast<uint2*>(q8_out + at * HD + col) = out;
      if (cv == 0) sq[at * heads + h] = scale;
    }
  }
  if (r0 >= Sk) return;  // block-uniform

  uint32_t vb[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x[8], y[8];
    unpack8(wk[i], x);
    unpack8(wv[i], y);
    uint2 out;
    uint32_t kb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      kb[e] = to_s8(__fsub_rn(x[e], mu_s[8 * cv + e]), skh);
      vb[i][e] = to_s8(y[e], sv_s[8 * cv + e]);
    }
    out.x = kb[0] | kb[1] << 8 | kb[2] << 16 | kb[3] << 24;
    out.y = kb[4] | kb[5] << 8 | kb[6] << 16 | kb[7] << 24;
    *reinterpret_cast<uint2*>(k8_out + ((size_t)b * Sk + rows[i]) * HD + col) = out;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    *reinterpret_cast<uint32_t*>(vt_s + (8 * cv + e) * VT_LD + 16 * blk + 4 * tq) =
        vb[0][e] | vb[1][e] << 8 | vb[2][e] << 16 | vb[3][e] << 24;
  }
  __syncthreads();
  // the staged tile out: a warp per channel row of ROWS bytes
  const int w = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < D; c += THREADS / 32) {
    *reinterpret_cast<uint32_t*>(v8t + ((size_t)b * HD + h * D + c) * Sk + r0 + 4 * w) =
        *reinterpret_cast<const uint32_t*>(vt_s + c * VT_LD + 4 * w);
  }
}

}  // namespace

// Keys per k6q_stats CTA: the scratch holds B * ceil(Sk / this) * 4 *
// heads * head_dim floats.
extern "C" int quantize_int8_stat_rows() { return STAT_ROWS; }

// q: (B, Sq, heads*head_dim), k and v: (B, Sk, heads*head_dim), bf16,
// contiguous, 16-byte aligned. Out: q8 like q and k8 like k, int8; sq
// (B, Sq, heads), sk (B, heads), sv (B, heads*head_dim), f32; v8t
// (B, heads*head_dim, Sk) int8 in K6's key order; scratch as
// quantize_int8_stat_rows says. Sq and Sk multiples of 128, head_dim 64.
// Returns 0 or the CUDA error code after the two launches on `stream`.
extern "C" int quantize_int8(const void* q, const void* k, const void* v, void* q8, void* sq,
                             void* k8, void* sk, void* v8t, void* sv, void* scratch, int B,
                             int Sq, int Sk, int heads, int head_dim, void* stream) {
  if (head_dim != D || B <= 0 || heads <= 0 || B > 65535 || heads > 65535 || Sq <= 0 ||
      Sk <= 0 || Sq % ROWS || Sk % ROWS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HD = heads * D, splits = (Sk + STAT_ROWS - 1) / STAT_ROWS;
  k6q_stats<<<dim3(HD / STAT_CH, splits, B), THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<float*>(scratch), Sk, HD);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k6q_quantize<<<dim3((std::max(Sq, Sk) + ROWS - 1) / ROWS, heads, B), THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(scratch),
      static_cast<int8_t*>(q8), static_cast<float*>(sq), static_cast<int8_t*>(k8),
      static_cast<float*>(sk), static_cast<int8_t*>(v8t), static_cast<float*>(sv), Sq, Sk, heads,
      splits);
  return static_cast<int>(cudaGetLastError());
}
