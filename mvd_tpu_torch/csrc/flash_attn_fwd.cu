// K1 and K5: flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out,
// f32 log-sum-exp. One kernel, two layouts:
//
//  * K1 replaces the TPU kernel mvd_tpu/kernels/flash_attention.py:
//    _fwd_kernel_packed (called by _flash_fwd_packed): the packed (B, S, H*D)
//    layout, out (B, Sq, H*D), lse (B, Sq, H);
//  * K5 replaces _fwd_kernel_grid (called by _flash_fwd, the kernels
//    package's public flash_attention): the (B, H, S, D) layout, out
//    (B, H, Sq, D), lse (B, H, Sq).
//
// Same function in both: non-causal multi-head attention, online softmax
// with f32 state. The layout only changes where a head's rows start and
// their stride (Layout below), a compile-time choice, so K1's code is the
// same as with one layout.
//
// Design:
//  * one CTA per (q-tile of 64 rows, head, batch); four warps, 16 query rows
//    each. A CTA reads its head's D columns by stride (row stride H*D
//    packed, D in (B, H, S, D)), so no head transposes are needed;
//  * K/V tiles of 64 keys are staged in shared memory (rows padded to 72
//    bf16 so the 4-byte fragment loads hit 32 distinct banks); Q stays in
//    registers as mma A-fragments for the whole loop;
//  * S = Q K^T and O += P V run on the tensor cores through
//    mma.sync.m16n8k16 (bf16 operands, f32 accumulate). The S accumulator
//    fragment is re-packed in registers as the A-fragment of P, so P never
//    touches shared memory;
//  * the online-softmax state (row max m, row sum l, accumulator O) is f32;
//    the softmax scale is folded with log2(e) into one multiply on S and
//    exp2 is used throughout;
//  * the ragged Sq and Sk edges are masked in the kernel: query rows past Sq
//    load as zero and are not stored, key columns past Sk score -inf and
//    their V rows stage as zero. The host pads nothing.
//
// Bound on the H100: at the UNet's self-attention sites (Sq = Sk = 4096,
// D = 64) the tensor-core operations bound it (4*Sq*Sk*D per head against
// 989 TFLOP/s bf16); at Sk = 77 the bytes of Q and O do. This first kernel
// uses mma.sync without TMA, wgmma or warp specialisation, and overlaps the
// tile loads only through several CTAs per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;      // query rows per CTA
constexpr int BK = 64;      // keys per shared-memory tile
constexpr int NWARPS = BQ / 16;
constexpr int PAD = 8;      // bf16 of padding per shared-memory row

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// D(16x8, f32) += A(16x16, bf16, row-major) * B(16x8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where (batch b, head h, row 0) of a tensor with S rows per head starts,
// its row stride, and where (b, h, row) sits in the log-sum-exp.
template <bool BHSD>
struct Layout {
  static __device__ __forceinline__ size_t base(int b, int h, int S, int heads, int D) {
    return BHSD ? ((size_t)b * heads + h) * S * D : (size_t)b * S * heads * D + (size_t)h * D;
  }
  static __device__ __forceinline__ int ld(int heads, int D) { return BHSD ? D : heads * D; }
  static __device__ __forceinline__ size_t stat(int b, int h, int row, int S, int heads) {
    return BHSD ? ((size_t)b * heads + h) * S + row : ((size_t)b * S + row) * heads + h;
  }
};

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A: a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..), a2 (row g, k 2t+8..),
//      a3 (row g+8, k 2t+8..);
//   B: b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9, col g);
//   C: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, cols 2t, 2t+1).
template <int D, bool BHSD>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                        int Sq, int Sk, int heads, float scale_log2) {
  constexpr int KSTEPS = D / 16;  // k-steps of S = Q K^T
  constexpr int DTILES = D / 8;   // n-tiles of O
  constexpr int NT = BK / 8;      // n-tiles of one score tile
  constexpr int LD = D + PAD;
  __shared__ __align__(16) __nv_bfloat16 k_s[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[BK * LD];

  using L = Layout<BHSD>;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ld = L::ld(heads, D);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BQ + warp * 16 + g;  // rows r0 and r0 + 8

  const __nv_bfloat16* qb = q + L::base(b, h, Sq, heads, D);
  const __nv_bfloat16* kb = k + L::base(b, h, Sk, heads, D);
  const __nv_bfloat16* vb = v + L::base(b, h, Sk, heads, D);

  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + (i & 1) * 8;
      const int col = kk * 16 + 2 * t + (i >> 1) * 8;
      qf[kk][i] = row < Sq
          ? *reinterpret_cast<const uint32_t*>(qb + (size_t)row * ld + col)
          : 0u;
    }
  }

  float o[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int kv0 = 0; kv0 < Sk; kv0 += BK) {
    __syncthreads();  // the previous tile is consumed
    constexpr int CHUNKS = BK * D / 8;  // 16-byte chunks per tile
    for (int c = threadIdx.x; c < CHUNKS; c += NWARPS * 32) {
      const int row = c / (D / 8), col = (c % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (kv0 + row < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(kv0 + row) * ld + col);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(kv0 + row) * ld + col);
      }
      *reinterpret_cast<uint4*>(k_s + row * LD + col) = kv;
      *reinterpret_cast<uint4*>(v_s + row * LD + col) = vv;
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = k_s + (n * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[n], qf[kk], b0, b1);
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kv0 + n * 8 + 2 * t + (i & 1);
        const float x = col < Sk ? s[n][i] * scale_log2 : -INFINITY;
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[n][i] - m[i >> 1]);
        s[n][i] = p;
        l[i >> 1] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_floats(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_floats(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_floats(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_floats(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        const __nv_bfloat16* vcol = v_s + (j * 16 + 2 * t) * LD + dt * 8 + g;
        const uint32_t b0 = pack_bf16(vcol[0], vcol[LD]);
        const uint32_t b1 = pack_bf16(vcol[8 * LD], vcol[9 * LD]);
        mma_bf16(o[dt], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + r * 8;
    if (row >= Sq) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* orow = out + L::base(b, h, Sq, heads, D) + (size_t)row * ld;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    }
    if (t == 0) {
      lse[L::stat(b, h, row, Sq, heads)] = m[r] * 0.69314718055994531f + logf(l[r]);
    }
  }
}

template <bool BHSD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq,
           int Sk, int heads, int head_dim, float scale, void* stream) {
  if (head_dim != 64 || B <= 0 || Sq <= 0 || Sk <= 0 || heads <= 0 || B > 65535 ||
      heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, heads, B);
  flash_fwd_kernel<64, BHSD><<<grid, NWARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Sk, heads, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. q: (B, Sq, heads*head_dim), k and v: (B, Sk, heads*head_dim), all bf16
// and contiguous with 16-byte aligned rows; out: like q; lse: (B, Sq, heads)
// f32. Returns cudaGetLastError() after the launch on `stream`.
extern "C" int flash_attn_fwd_packed_bf16(const void* q, const void* k, const void* v,
                                          void* out, void* lse, int B, int Sq, int Sk,
                                          int heads, int head_dim, float scale,
                                          void* stream) {
  return launch<false>(q, k, v, out, lse, B, Sq, Sk, heads, head_dim, scale, stream);
}

// K5. q: (B, heads, Sq, head_dim), k and v: (B, heads, Sk, head_dim), all
// bf16 and contiguous, 16-byte aligned; out: like q; lse: (B, heads, Sq) f32.
extern "C" int flash_attn_fwd_bhsd_bf16(const void* q, const void* k, const void* v,
                                        void* out, void* lse, int B, int Sq, int Sk,
                                        int heads, int head_dim, float scale, void* stream) {
  return launch<true>(q, k, v, out, lse, B, Sq, Sk, heads, head_dim, scale, stream);
}
