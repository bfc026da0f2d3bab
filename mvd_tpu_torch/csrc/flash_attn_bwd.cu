// K3a / K3b: flash-attention backward for Hopper (sm_90a), bf16 in, bf16
// out, f32 log-sum-exp and delta, on the packed (B, S, H*D) layout of K1 or
// the (B, H, S, D) layout of K5 (a compile-time choice, as in
// flash_attn_fwd.cu: the layout changes only where a head's rows start and
// their stride).
//
// Replace the TPU kernels mvd_tpu/kernels/flash_attention.py:_bwd_dq_kernel
// (K3a) and :_bwd_dkv_kernel (K3b), launched from _flash_bwd. Same math,
// with P = exp(q k^T * scale - lse) and delta = rowsum(dO * O) given:
//   K3a: dq = sum_k dS K * scale,          dS = P * (dO V^T - delta);
//   K3b: dk = sum_q dS^T Q * scale,  dv = sum_q P^T dO.
// P and dS are rounded to bf16 right before their products, where the TPU
// kernels cast them; every accumulator is f32.
//
// Design:
//  * the packed (B, S, H*D) layout is read directly: a CTA reads its head's D
//    columns out of the packed rows (row stride H*D), so the JAX VJP's head
//    transposes are gone; (B, H, S, D), the JAX _flash_bwd's own layout, is
//    read with row stride D;
//  * K3a: one CTA per (q-tile of 64 rows, head, batch), four warps of 16 query
//    rows. Q and dO stay in registers as mma A-fragments; K/V tiles of 64
//    keys are staged in shared memory; S = Q K^T and dP = dO V^T run on the
//    tensor cores (mma.sync.m16n8k16, bf16 operands, f32 accumulate), dS is
//    formed in registers and re-packed as the A-fragment of dS K;
//  * K3b: one CTA per (k-tile of 64 keys, head, batch), four warps of 16
//    keys. K and V stay in registers; Q/dO tiles of 64 rows with their lse
//    and delta are staged in shared memory. The products are taken in the
//    transposed form (S^T = K Q^T, dP^T = V dO^T), so P^T and dS^T come out
//    of the accumulators already as the A-fragments of P^T dO and dS^T Q;
//  * the TPU kernels carried their sums in VMEM scratch across sequential
//    grid steps; on the GPU the reduction axis is a loop inside the CTA and
//    nothing is carried across CTAs (no atomics);
//  * ragged edges are masked in the kernel: key columns past Sk get P = 0
//    (their K/V rows stage as zero), query rows past Sq get lse = +inf and
//    so P = 0 and dS = 0, and neither reads past the end nor stores. The
//    host pads nothing.
//
// Bound on the H100: at the UNet's self-attention and adapter sites
// (Sq = Sk = 9216 at 768^2, D = 64) the tensor-core operations bound both
// (6 Sq Sk D per head for K3a, 8 Sq Sk D for K3b, against 989 TFLOP/s bf16).
// This first version uses mma.sync without ldmatrix, cp.async/TMA, wgmma or
// warp specialisation, and overlaps tile loads only through several CTAs
// per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile
constexpr int NWARPS = 4;
constexpr int PAD = 8;  // bf16 of padding per shared-memory row
constexpr float LOG2E = 1.4426950408889634f;

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
// its row stride, and where (b, h, row) sits in lse and delta.
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

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4), as in K1:
//   A: a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..), a2 (row g, k 2t+8..),
//      a3 (row g+8, k 2t+8..);
//   B: b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9, col g);
//   C: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, cols 2t, 2t+1).

// A-fragments of 16 rows x D columns of a packed tensor, rows r0 and r0 + 8
// (zero past `rows`).
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             const __nv_bfloat16* base, int r0,
                                             int rows, int ld, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + (i & 1) * 8;
      const int col = kk * 16 + 2 * t + (i >> 1) * 8;
      f[kk][i] = row < rows
          ? *reinterpret_cast<const uint32_t*>(base + (size_t)row * ld + col)
          : 0u;
    }
  }
}

// Stage two 64 x D tiles (rows r0.. of a and b, zero past `rows`) into
// shared memory with row stride D + PAD.
template <int D>
__device__ __forceinline__ void stage_pair(__nv_bfloat16* a_s, __nv_bfloat16* b_s,
                                           const __nv_bfloat16* a, const __nv_bfloat16* b,
                                           int r0, int rows, int ld) {
  constexpr int LD = D + PAD;
  constexpr int CHUNKS = 64 * D / 8;  // 16-byte chunks per tile
  for (int c = threadIdx.x; c < CHUNKS; c += NWARPS * 32) {
    const int row = c / (D / 8), col = (c % (D / 8)) * 8;
    uint4 av = make_uint4(0u, 0u, 0u, 0u), bv = av;
    if (r0 + row < rows) {
      av = *reinterpret_cast<const uint4*>(a + (size_t)(r0 + row) * ld + col);
      bv = *reinterpret_cast<const uint4*>(b + (size_t)(r0 + row) * ld + col);
    }
    *reinterpret_cast<uint4*>(a_s + row * LD + col) = av;
    *reinterpret_cast<uint4*>(b_s + row * LD + col) = bv;
  }
}

// c[n] += A (16 x D, registers) * T^T for the 64 staged rows of T (8 n-tiles
// of 8 rows): the product with a shared-memory tile read row-major.
template <int D>
__device__ __forceinline__ void mma_rows(float (&c)[8][4], const uint32_t (&a)[D / 16][4],
                                         const __nv_bfloat16* t_s, int g, int t) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const __nv_bfloat16* row = t_s + (n * 8 + g) * LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(row + kk * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(row + kk * 16 + 8);
      mma_bf16(c[n], a[kk], b0, b1);
    }
  }
}

// acc (16 x D) += X (16 x 64, the f32 accumulator fragments x, rounded to
// bf16) * T for the 64 staged rows of T (D columns).
template <int D>
__device__ __forceinline__ void mma_acc(float (&acc)[D / 8][4], const float (&x)[8][4],
                                        const __nv_bfloat16* t_s, int g, int t) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t a[4];
    a[0] = pack_floats(x[2 * j][0], x[2 * j][1]);
    a[1] = pack_floats(x[2 * j][2], x[2 * j][3]);
    a[2] = pack_floats(x[2 * j + 1][0], x[2 * j + 1][1]);
    a[3] = pack_floats(x[2 * j + 1][2], x[2 * j + 1][3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const __nv_bfloat16* col = t_s + (j * 16 + 2 * t) * LD + dt * 8 + g;
      const uint32_t b0 = pack_bf16(col[0], col[LD]);
      const uint32_t b1 = pack_bf16(col[8 * LD], col[9 * LD]);
      mma_bf16(acc[dt], a, b0, b1);
    }
  }
}

// Store rows r0 and r0 + 8 (if < rows) of a 16 x D f32 accumulator, times
// `mul`, as bf16 into a packed tensor.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, const float (&acc)[D / 8][4],
                                           int r0, int rows, int ld, float mul, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + r * 8;
    if (row >= rows) continue;
    __nv_bfloat16* dst = base + (size_t)row * ld;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[dt][2 * r] * mul, acc[dt][2 * r + 1] * mul);
    }
  }
}

template <int D, bool BHSD>
__global__ void __launch_bounds__(NWARPS * 32)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int heads, float scale,
                    float scale_log2) {
  constexpr int LD = D + PAD;
  __shared__ __align__(16) __nv_bfloat16 k_s[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[BK * LD];

  using L = Layout<BHSD>;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ld = L::ld(heads, D);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BQ + warp * 16 + g;  // query rows r0 and r0 + 8

  const size_t q_off = L::base(b, h, Sq, heads, D);
  const __nv_bfloat16* kb = k + L::base(b, h, Sk, heads, D);
  const __nv_bfloat16* vb = v + L::base(b, h, Sk, heads, D);

  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_a_frags<D>(qf, q + q_off, r0, Sq, ld, t);
  load_a_frags<D>(dof, dout + q_off, r0, Sq, ld, t);
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + r * 8;
    const size_t i = L::stat(b, h, row, Sq, heads);
    lse2[r] = row < Sq ? lse[i] * LOG2E : INFINITY;  // +inf: P = 0
    dlt[r] = row < Sq ? delta[i] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int kv0 = 0; kv0 < Sk; kv0 += BK) {
    __syncthreads();  // the previous tile is consumed
    stage_pair<D>(k_s, v_s, kb, vb, kv0, Sk, ld);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    mma_rows<D>(s, qf, k_s, g, t);    // S = Q K^T
    mma_rows<D>(dp, dof, v_s, g, t);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kv0 + n * 8 + 2 * t + (i & 1);
        const float p = col < Sk ? exp2f(s[n][i] * scale_log2 - lse2[i >> 1]) : 0.f;
        s[n][i] = p * (dp[n][i] - dlt[i >> 1]);  // dS
      }
    }
    mma_acc<D>(acc, s, k_s, g, t);  // dq += dS K
  }
  store_rows<D>(dq + q_off, acc, r0, Sq, ld, scale, t);
}

template <int D, bool BHSD>
__global__ void __launch_bounds__(NWARPS * 32)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
                     int Sk, int heads, float scale, float scale_log2) {
  constexpr int LD = D + PAD;
  __shared__ __align__(16) __nv_bfloat16 q_s[BQ * LD];
  __shared__ __align__(16) __nv_bfloat16 do_s[BQ * LD];
  __shared__ float lse_s[BQ];
  __shared__ float dlt_s[BQ];

  using L = Layout<BHSD>;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ld = L::ld(heads, D);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BK + warp * 16 + g;  // key rows r0 and r0 + 8

  const size_t k_off = L::base(b, h, Sk, heads, D);
  const __nv_bfloat16* qb = q + L::base(b, h, Sq, heads, D);
  const __nv_bfloat16* dob = dout + L::base(b, h, Sq, heads, D);

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(kf, k + k_off, r0, Sk, ld, t);
  load_a_frags<D>(vf, v + k_off, r0, Sk, ld, t);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dk_acc[dt][0] = dk_acc[dt][1] = dk_acc[dt][2] = dk_acc[dt][3] = 0.f;
    dv_acc[dt][0] = dv_acc[dt][1] = dv_acc[dt][2] = dv_acc[dt][3] = 0.f;
  }

  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    __syncthreads();  // the previous tile is consumed
    stage_pair<D>(q_s, do_s, qb, dob, q0, Sq, ld);
    for (int r = threadIdx.x; r < BQ; r += NWARPS * 32) {
      const int row = q0 + r;
      const size_t i = L::stat(b, h, row, Sq, heads);
      lse_s[r] = row < Sq ? lse[i] * LOG2E : INFINITY;  // +inf: P = 0
      dlt_s[r] = row < Sq ? delta[i] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];  // keys x queries
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    }
    mma_rows<D>(st, kf, q_s, g, t);    // S^T = K Q^T
    mma_rows<D>(dpt, vf, do_s, g, t);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = n * 8 + 2 * t + (i & 1);
        const float p = exp2f(st[n][i] * scale_log2 - lse_s[qc]);
        st[n][i] = p;
        dpt[n][i] = p * (dpt[n][i] - dlt_s[qc]);  // dS^T
      }
    }
    mma_acc<D>(dv_acc, st, do_s, g, t);  // dv += P^T dO
    mma_acc<D>(dk_acc, dpt, q_s, g, t);  // dk += dS^T Q
  }
  store_rows<D>(dk + k_off, dk_acc, r0, Sk, ld, scale, t);
  store_rows<D>(dv + k_off, dv_acc, r0, Sk, ld, 1.f, t);
}

bool bad_args(int B, int Sq, int Sk, int heads, int head_dim) {
  return head_dim != 64 || B <= 0 || Sq <= 0 || Sk <= 0 || heads <= 0 || B > 65535 ||
         heads > 65535;
}

template <bool BHSD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int Sq, int Sk, int heads, int head_dim,
              float scale, void* stream) {
  if (bad_args(B, Sq, Sk, heads, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + BQ - 1) / BQ, heads, B);
  flash_bwd_dq_kernel<64, BHSD><<<grid, NWARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), Sq, Sk, heads, scale, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <bool BHSD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int heads,
               int head_dim, float scale, void* stream) {
  if (bad_args(B, Sq, Sk, heads, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sk + BK - 1) / BK, heads, B);
  flash_bwd_dkv_kernel<64, BHSD><<<grid, NWARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq, Sk, heads, scale,
      scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Packed (K1's layout). q, dout: (B, Sq, heads*head_dim); k, v: (B, Sk,
// heads*head_dim); all bf16, contiguous, 16-byte aligned. lse and delta:
// (B, Sq, heads) f32. dq: like q. Returns cudaGetLastError() after the launch
// on `stream`.
extern "C" int flash_attn_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int B, int Sq, int Sk, int heads,
                                      int head_dim, float scale, void* stream) {
  return launch_dq<false>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, heads, head_dim, scale,
                          stream);
}

// As above; dk and dv: like k.
extern "C" int flash_attn_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int Sq, int Sk, int heads,
                                       int head_dim, float scale, void* stream) {
  return launch_dkv<false>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, heads, head_dim,
                           scale, stream);
}

// (B, H, S, D) (K5's layout). q, dout: (B, heads, Sq, head_dim); k, v:
// (B, heads, Sk, head_dim); lse and delta: (B, heads, Sq) f32; otherwise as
// the packed entries.
extern "C" int flash_attn_bwd_dq_bhsd_bf16(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dq, int B, int Sq, int Sk,
                                           int heads, int head_dim, float scale,
                                           void* stream) {
  return launch_dq<true>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, heads, head_dim, scale,
                         stream);
}

extern "C" int flash_attn_bwd_dkv_bhsd_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dk, void* dv, int B,
                                            int Sq, int Sk, int heads, int head_dim,
                                            float scale, void* stream) {
  return launch_dkv<true>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, heads, head_dim,
                          scale, stream);
}
