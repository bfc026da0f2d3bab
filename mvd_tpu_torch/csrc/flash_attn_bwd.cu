// K3a / K3b: flash-attention backward for Hopper (sm_90a), bf16 in, bf16
// out, f32 log-sum-exp and delta, on the packed (B, S, H*D) layout of K1 or
// the (B, H, S, D) layout of K5 (a compile-time choice, as in
// flash_attn_fwd.cu: the layout changes only the tensor maps and where a
// row's gradient is stored).
//
// Replace the TPU kernels mvd_tpu/kernels/flash_attention.py:_bwd_dq_kernel
// (K3a) and :_bwd_dkv_kernel (K3b), launched from _flash_bwd. Same math,
// with P = exp(q k^T * scale - lse) and delta = rowsum(dO * O) given:
//   K3a: dq = sum_k dS K * scale,          dS = P * (dO V^T - delta);
//   K3b: dk = sum_q dS^T Q * scale,  dv = sum_q P^T dO.
// P and dS are rounded to bf16 right before their products, where the TPU
// kernels cast them; every accumulator is f32. Two kernels, as on the TPU:
// K3a alone serves the sites whose K/V need no gradient, and no kernel uses
// atomics, so results are bitwise repeatable.
//
// Bound on the H100: at the train step's self-attention and adapter sites
// (Sq = Sk = 9216 at 768^2, D = 64) the tensor-core operations bound both
// (K3a 3 products, K3b 4, each 2 Sq Sk D per head, against 989 TFLOP/s
// bf16); the exponentials (Sq Sk per head) come next. So every product runs
// as wgmma, and the elementwise work of one warpgroup overlaps the products
// of the other.
//
// Design (warp-specialised like K1; one CTA of 2 consumer warpgroups and a
// producer warpgroup, one CTA per SM):
//  * TMA loads every bf16 tile (128 rows of one head's 64 columns) through a
//    3-D tensor map with the 128-byte swizzle, {H*D, S, B} packed, {D, S, B*H}
//    in (B, H, S, D), so rows past Sq or Sk arrive as zeros from within the
//    same batch and head and nothing reads across a batch;
//  * lse and delta come as f32 (B, H, Sq_pad) from the wrapper, Sq_pad = Sq
//    rounded up to 128, lse padded with +inf and delta with 0: padded query
//    rows get P = 0 and dS = 0. (TMA cannot cut one head out of the packed
//    (B, Sq, H) statistics: their row stride of 4 H bytes is not a multiple
//    of 16.)
//  * K3b, one CTA per (128 keys, head, batch): the producer loads the CTA's
//    K and V tiles once, then streams Q and dO tiles of 128 query rows with
//    their lse and delta slices (1-D bulk copies) through a ring of STAGES
//    stages with full/empty mbarriers. Consumer warpgroup w owns keys
//    64w..64w+63 and takes the products transposed: S^T = K Q^T and
//    dP^T = V dO^T as wgmma m64n128k16 with both operands K-major in shared
//    memory; P^T and dS^T, packed to bf16 in registers, are the register A
//    operand of dv += P^T dO and dk += dS^T Q (m64n64k16), whose B (dO, Q)
//    is read MN-major through the descriptor's transpose bit from the same
//    swizzled tiles the first products read K-major;
//  * K3a, one CTA per (128 query rows, head, batch): the producer loads Q and
//    dO once and streams K/V tiles of 128 keys; consumer warpgroup w owns
//    query rows 64w..64w+63, with their lse and delta in registers: S = Q K^T
//    and dP = dO V^T (m64n128k16, K-major), then dq += dS K with dS from
//    registers and K read MN-major. The key mask runs only on a ragged last
//    tile (zero K rows give S = 0, and exp(-lse) may overflow);
//  * nothing goes through shared memory but the TMA tiles and statistics;
//    the TPU kernels carried their sums in VMEM scratch across sequential
//    grid steps, here the reduction axis is the loop inside the CTA.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int NWG = 2;                        // consumer warpgroups of 64 rows
constexpr int THREADS = 128 * (NWG + 1);
constexpr int STAGES = 3;                     // ring stages
constexpr int STAT_BYTES = TILE * 4;          // one tile's lse (or delta), f32
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // all 65,536 of the SM
constexpr float LOG2E = 1.4426950408889634f;

static_assert(64 * NWG == TILE, "a CTA's rows are one tile");

// 1024 of alignment slack; the CTA's two resident tiles, the ring's two
// tiles per stage, K3b's statistics per stage; full and empty barriers per
// stage and one for the resident tiles.
constexpr int smem_bytes(bool dkv) {
  return 1024 + 2 * TILE_BYTES + 2 * STAGES * TILE_BYTES + (dkv ? STAGES * 2 * STAT_BYTES : 0) +
         8 * (2 * STAGES + 1);
}

// Store rows 16 warp + g and + 8 of a warpgroup's 64 x D f32 accumulator,
// times `mul`, as bf16; row0 is the warpgroup's first row, rows past S are
// skipped.
template <bool BHSD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst, const float (&acc)[32],
                                           int row0, int S, int b, int h, int heads, float mul,
                                           int warp, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    const size_t at = BHSD ? ((size_t)b * heads + h) * S + row : ((size_t)b * S + row) * heads + h;
    __nv_bfloat16* out = dst + at * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// K3b: dk, dv for the CTA's 128 keys. c = scale * log2(e).
template <bool BHSD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int heads, float scale,
                    float c) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = smem_raw + (((smem_u32(smem_raw) + 1023) & ~1023u) - smem_u32(smem_raw));
  const uint32_t k_s = smem_u32(sm);  // the swizzle needs 1024-byte alignment
  const uint32_t v_s = k_s + TILE_BYTES;
  const uint32_t q_ring = v_s + TILE_BYTES;
  const uint32_t do_ring = q_ring + STAGES * TILE_BYTES;
  const uint32_t stat_off = 2 * TILE_BYTES + 2 * STAGES * TILE_BYTES;  // lse, delta per stage
  const uint32_t bars = k_s + stat_off + STAGES * 2 * STAT_BYTES;
  const uint32_t kv_bar = bars + 16 * STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * TILE;
  const int n_tiles = (Sq + TILE - 1) / TILE;
  const size_t stat_row = ((size_t)b * heads + h) * (size_t)(n_tiles * TILE);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == NWG * 128) {
    tma_prefetch_map(&q_map);
    tma_prefetch_map(&k_map);
    tma_prefetch_map(&v_map);
    tma_prefetch_map(&do_map);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NWG);
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // producer: one thread issues every load of the CTA
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == NWG * 128) {
      const int c0 = BHSD ? 0 : h * D, c2 = BHSD ? b * heads + h : b;
      mbar_arrive_expect_tx(kv_bar, 2 * TILE_BYTES);
      tma_load_3d(k_s, &k_map, c0, k0, c2, kv_bar);
      tma_load_3d(v_s, &v_map, c0, k0, c2, kv_bar);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const uint32_t stats = k_s + stat_off + s * 2 * STAT_BYTES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(full(s), 2 * TILE_BYTES + 2 * STAT_BYTES);
        tma_load_3d(q_ring + s * TILE_BYTES, &q_map, c0, i * TILE, c2, full(s));
        tma_load_3d(do_ring + s * TILE_BYTES, &do_map, c0, i * TILE, c2, full(s));
        bulk_load(stats, lse + stat_row + i * TILE, STAT_BYTES, full(s));
        bulk_load(stats + STAT_BYTES, delta + stat_row + i * TILE, STAT_BYTES, full(s));
      }
    }
  } else {
    // consumer warpgroup wg: keys k0 + 64 wg .. k0 + 64 wg + 63; accumulators
    // are keys x queries (S^T, dP^T) and keys x D (dk, dv)
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint64_t k_desc = desc_sw128(k_s + wg * 64 * ROW_BYTES);
    const uint64_t v_desc = desc_sw128(v_s + wg * 64 * ROW_BYTES);

    float dk_acc[32], dv_acc[32];
    zero(dk_acc);
    zero(dv_acc);
    float st[64], dpt[64];
    uint32_t pa[TILE / 16][4], dsa[TILE / 16][4];

    mbar_wait(kv_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint64_t q_desc = desc_sw128(q_ring + s * TILE_BYTES);
      const uint64_t do_desc = desc_sw128(do_ring + s * TILE_BYTES);
      const float* lse_s = reinterpret_cast<const float*>(sm + stat_off + s * 2 * STAT_BYTES);
      const float* dlt_s = lse_s + TILE;
      mbar_wait(full(s), (i / STAGES) & 1);
      wgmma_fence();
      issue_scores(st, k_desc, q_desc);    // S^T = K Q^T
      issue_scores(dpt, v_desc, do_desc);  // dP^T = V dO^T
      wgmma_wait<1>();                     // S^T; dP^T may still run
      fence_regs(st);
      // P^T = exp2(S^T c - lse log2(e)); columns are queries 8j + 2t, + 1
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
        const float l0 = l.x * LOG2E, l1 = l.y * LOG2E;
        st[4 * j] = ex2(fmaf(st[4 * j], c, -l0));
        st[4 * j + 1] = ex2(fmaf(st[4 * j + 1], c, -l1));
        st[4 * j + 2] = ex2(fmaf(st[4 * j + 2], c, -l0));
        st[4 * j + 3] = ex2(fmaf(st[4 * j + 3], c, -l1));
      }
      wgmma_wait<0>();
      fence_regs(dpt);
      // dS^T = P^T (dP^T - delta), from the f32 P^T
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(dlt_s + 8 * j + 2 * t);
        dpt[4 * j] = st[4 * j] * (dpt[4 * j] - d.x);
        dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - d.y);
        dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - d.x);
        dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - d.y);
      }
      pack_p(pa, st);
      pack_p(dsa, dpt);
      wgmma_fence();
      issue_pv(dv_acc, pa, do_desc);   // dv += P^T dO
      issue_pv(dk_acc, dsa, q_desc);   // dk += dS^T Q
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      if (tid == 0) mbar_arrive(empty(s));  // this warpgroup is done with stage s
    }
    store_rows<BHSD>(dk, dk_acc, k0 + wg * 64, Sk, b, h, heads, scale, warp, g, t);
    store_rows<BHSD>(dv, dv_acc, k0 + wg * 64, Sk, b, h, heads, 1.f, warp, g, t);
  }
}

// K3a: dq for the CTA's 128 query rows. c = scale * log2(e).
template <bool BHSD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
                   int Sk, int heads, float scale, float c) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle needs 1024 B
  const uint32_t do_s = q_s + TILE_BYTES;
  const uint32_t k_ring = do_s + TILE_BYTES;
  const uint32_t v_ring = k_ring + STAGES * TILE_BYTES;
  const uint32_t bars = v_ring + STAGES * TILE_BYTES;
  const uint32_t q_bar = bars + 16 * STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * TILE;
  const int n_tiles = (Sk + TILE - 1) / TILE;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == NWG * 128) {
    tma_prefetch_map(&q_map);
    tma_prefetch_map(&k_map);
    tma_prefetch_map(&v_map);
    tma_prefetch_map(&do_map);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NWG);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == NWG * 128) {
      const int c0 = BHSD ? 0 : h * D, c2 = BHSD ? b * heads + h : b;
      mbar_arrive_expect_tx(q_bar, 2 * TILE_BYTES);
      tma_load_3d(q_s, &q_map, c0, q0, c2, q_bar);
      tma_load_3d(do_s, &do_map, c0, q0, c2, q_bar);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), 2 * TILE_BYTES);
        tma_load_3d(k_ring + s * TILE_BYTES, &k_map, c0, i * TILE, c2, full(s));
        tma_load_3d(v_ring + s * TILE_BYTES, &v_map, c0, i * TILE, c2, full(s));
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg .. q0 + 64 wg + 63, this
    // thread's rows g and g + 8 of its warp's 16
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint64_t q_desc = desc_sw128(q_s + wg * 64 * ROW_BYTES);
    const uint64_t do_desc = desc_sw128(do_s + wg * 64 * ROW_BYTES);
    auto k_desc = [&](int s) { return desc_sw128(k_ring + s * TILE_BYTES); };
    auto v_desc = [&](int s) { return desc_sw128(v_ring + s * TILE_BYTES); };
    const int last_masked = Sk % TILE != 0 ? n_tiles - 1 : -1;

    // the rows' statistics, padded to whole tiles (lse +inf, delta 0)
    const size_t stat_row = ((size_t)b * heads + h) * (size_t)((Sq + TILE - 1) / TILE * TILE);
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t at = stat_row + q0 + wg * 64 + warp * 16 + g + 8 * r;
      lse2[r] = lse[at] * LOG2E;
      dlt[r] = delta[at];
    }

    float dq_acc[32];
    zero(dq_acc);
    float s_acc[64], dp[64];
    uint32_t dsa[TILE / 16][4];

    mbar_wait(q_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      mbar_wait(full(s), (i / STAGES) & 1);
      wgmma_fence();
      issue_scores(s_acc, q_desc, k_desc(s));  // S = Q K^T
      issue_scores(dp, do_desc, v_desc(s));    // dP = dO V^T
      wgmma_wait<1>();
      fence_regs(s_acc);
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s_acc[4 * j + e] = ex2(fmaf(s_acc[4 * j + e], c, -lse2[e >> 1]));
      }
      if (i == last_masked) {  // P = 0 for keys past Sk
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const int col = i * TILE + 8 * j + 2 * t;
          if (col >= Sk) s_acc[4 * j] = s_acc[4 * j + 2] = 0.f;
          if (col + 1 >= Sk) s_acc[4 * j + 1] = s_acc[4 * j + 3] = 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * j + e] = s_acc[4 * j + e] * (dp[4 * j + e] - dlt[e >> 1]);
      }
      pack_p(dsa, dp);
      wgmma_fence();
      issue_pv(dq_acc, dsa, k_desc(s));  // dq += dS K
      wgmma_wait<0>();
      fence_regs(dq_acc);
      if (tid == 0) mbar_arrive(empty(s));
    }
    store_rows<BHSD>(dq, dq_acc, q0 + wg * 64, Sq, b, h, heads, scale, warp, g, t);
  }
}

// One K3a (DKV false: out0 = dq) or K3b (DKV true: out0 = dk, out1 = dv)
// launch. Returns 0, a CUDA error code after the launch, or minus the
// CUresult of a failed tensor-map encode.
template <bool DKV, bool BHSD>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* out0, void* out1, int B, int Sq, int Sk, int heads,
           int head_dim, float scale, void* stream) {
  if (head_dim != D || B <= 0 || Sq <= 0 || Sk <= 0 || heads <= 0 || B > 65535 ||
      heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const EncodeTiled fn = encode_fn();
  if (!fn) return static_cast<int>(cudaErrorSymbolNotFound);
  // packed: {H*D, S, B}; (B, H, S, D): {D, S, B*H}
  const int row_elems = BHSD ? D : heads * D, outer = BHSD ? B * heads : B;
  CUtensorMap q_map, k_map, v_map, do_map;
  int err = encode(fn, &q_map, q, row_elems, Sq, outer, TILE);
  if (!err) err = encode(fn, &k_map, k, row_elems, Sk, outer, TILE);
  if (!err) err = encode(fn, &v_map, v, row_elems, Sk, outer, TILE);
  if (!err) err = encode(fn, &do_map, dout, row_elems, Sq, outer, TILE);
  if (err) return -err;

  constexpr int SMEM = smem_bytes(DKV);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  const float c = scale * LOG2E;
  if constexpr (DKV) {
    e = allow_smem<flash_bwd_dkv_wgmma<BHSD>>(SMEM, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((Sk + TILE - 1) / TILE, heads, B);
    flash_bwd_dkv_wgmma<BHSD><<<grid, THREADS, SMEM, st>>>(
        q_map, k_map, v_map, do_map, l, d, static_cast<__nv_bfloat16*>(out0),
        static_cast<__nv_bfloat16*>(out1), Sq, Sk, heads, scale, c);
  } else {
    e = allow_smem<flash_bwd_dq_wgmma<BHSD>>(SMEM, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((Sq + TILE - 1) / TILE, heads, B);
    flash_bwd_dq_wgmma<BHSD><<<grid, THREADS, SMEM, st>>>(
        q_map, k_map, v_map, do_map, l, d, static_cast<__nv_bfloat16*>(out0), Sq, Sk, heads,
        scale, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Packed (K1's layout). q, dout: (B, Sq, heads*head_dim); k, v: (B, Sk,
// heads*head_dim); all bf16, contiguous, 16-byte aligned. lse and delta:
// f32 (B, heads, Sq_pad), Sq_pad = Sq rounded up to 128 (flash_attn_bwd_rows),
// padded with +inf and 0, 16-byte aligned. dq: like q. Returns 0 or an error
// code (see launch) after the launch on `stream`.
extern "C" int flash_attn_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int B, int Sq, int Sk, int heads,
                                      int head_dim, float scale, void* stream) {
  return launch<false, false>(q, k, v, dout, lse, delta, dq, nullptr, B, Sq, Sk, heads,
                              head_dim, scale, stream);
}

// As above; dk and dv: like k.
extern "C" int flash_attn_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int Sq, int Sk, int heads,
                                       int head_dim, float scale, void* stream) {
  return launch<true, false>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, heads, head_dim,
                             scale, stream);
}

// (B, H, S, D) (K5's layout). q, dout: (B, heads, Sq, head_dim); k, v:
// (B, heads, Sk, head_dim); lse and delta as for the packed entries.
extern "C" int flash_attn_bwd_dq_bhsd_bf16(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dq, int B, int Sq, int Sk,
                                           int heads, int head_dim, float scale,
                                           void* stream) {
  return launch<false, true>(q, k, v, dout, lse, delta, dq, nullptr, B, Sq, Sk, heads,
                             head_dim, scale, stream);
}

extern "C" int flash_attn_bwd_dkv_bhsd_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dk, void* dv, int B,
                                            int Sq, int Sk, int heads, int head_dim,
                                            float scale, void* stream) {
  return launch<true, true>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, heads, head_dim,
                            scale, stream);
}

// The row multiple of the padded statistics (lse, delta) both kernels take.
extern "C" int flash_attn_bwd_rows() { return TILE; }

// Dynamic shared memory of one K3a (dkv 0) or K3b (dkv 1) CTA, for the build
// report.
extern "C" int flash_attn_bwd_smem_bytes(int dkv) { return smem_bytes(dkv != 0); }
