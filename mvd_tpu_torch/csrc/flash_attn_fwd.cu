// K1 and K5: flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out,
// f32 log-sum-exp (natural log). One kernel, two layouts:
//
//  * K1 replaces the TPU kernel mvd_tpu/kernels/flash_attention.py:
//    _fwd_kernel_packed (called by _flash_fwd_packed): the packed (B, S, H*D)
//    layout, out (B, Sq, H*D), lse (B, Sq, H);
//  * K5 replaces _fwd_kernel_grid (called by _flash_fwd, the kernels
//    package's public flash_attention): the (B, H, S, D) layout, out
//    (B, H, Sq, D), lse (B, H, Sq).
//
// Same function in both: non-causal multi-head attention, D = 64, online
// softmax with f32 state. The layout only changes the tensor maps and where
// a row's output and lse are stored (a compile-time choice).
//
// Bound on the H100: at the UNet's self-attention sites (Sq = Sk = 4096,
// D = 64) the tensor-core operations (4 Sq Sk D per head at 989 TFLOP/s
// bf16) and the exponentials (Sq Sk per head at 16 per clock per SM) take
// about as long, so both the matrix products and the softmax have to run
// near their rates and overlap; at Sk = 77 the bytes of Q and O bound it.
//
// Design (warp-specialised, one CTA of NWG + 1 warpgroups per
// (q-tile of 64 * NWG rows, head, batch), one CTA per SM):
//  * TMA loads every tile through a 3-D tensor map with the 128-byte swizzle
//    (one head's row of 64 bf16 is 128 bytes): dims {H*D, S, B} packed,
//    {D, S, B*H} in (B, H, S, D). Rows past S arrive as zeros from within
//    the same batch and head, so the ragged edges need no load code;
//  * the last warpgroup is the producer: one thread loads the CTA's Q tile
//    once, then K and V tiles of BK = 128 keys into a ring of STAGES stages
//    in dynamic shared memory, each stage with a full and an empty
//    mbarrier. It gives its registers to the consumers (setmaxnreg);
//  * each consumer warpgroup owns 64 query rows. S = Q K^T runs as
//    wgmma m64n128k16 with Q and K both read from shared memory through
//    descriptors whose swizzle matches TMA's; the scores stay in registers;
//  * P = exp2(S c - m c) with c = scale * log2(e): one FFMA and one EX2 per
//    score; the row max and sum run as 4 partial chains per row; the key
//    mask runs only on the last tile and only when Sk is not a multiple of
//    BK;
//  * P is packed to bf16 in registers and is wgmma's register A operand for
//    O += P V (m64n64k16): the accumulator layout of the first product is
//    the A-fragment layout of the second, so P never touches shared memory.
//    V is the B operand in its stored (keys x D) order, read MN-major
//    through the descriptor's transpose bit;
//  * the online-softmax state (row max m, row sum l of the f32 P, and O) is
//    f32; out = O / l in bf16 and lse = m c ln 2 + ln l are stored straight
//    from registers, skipping rows past Sq;
//  * a consumer issues S_i = Q K_i^T and O += P_{i-1} V_{i-1} together and
//    runs the softmax of S_i while P V is in flight, so a stage is held one
//    tile longer (hence 3 stages). ptxas still puts its wait for P V ahead
//    of most of the softmax, so the overlap is partial; it measured about
//    9% faster at S = 4096 than the loop without it;
//  * NWG is 2 (BQ = 128) or 3 (BQ = 192), whichever needs fewer waves of
//    CTAs times rows per CTA on this card's SMs (3 on a tie): 2 at S = 4096,
//    3 at S = 1024 and 9216. Three warpgroups get 160 registers a thread
//    (ptxas spills 56 bytes), two 240.
// Tried on the H100 and not kept, because they did not gain at S = 4096
// (PERF.md, PR 4): ordering the consumer warpgroups' products with named
// barriers ("ping-pong"); separate K and V barriers; 2 or 4 stages.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BK = TILE;                     // keys per K/V tile
constexpr int STAGES = 3;                    // K/V ring stages
constexpr int KV_TILE_BYTES = TILE_BYTES;
constexpr float LN2 = 0.69314718055994531f;

// registers per thread of the producer and of each consumer warpgroup, all
// 65,536 of the SM between them (one CTA per SM)
__host__ __device__ constexpr int producer_regs(int nwg) { return nwg == 2 ? 24 : 32; }
__host__ __device__ constexpr int consumer_regs(int nwg) { return nwg == 2 ? 240 : 160; }

template <int NWG>
constexpr int smem_bytes() {  // 1024 of alignment slack, Q, K and V rings, barriers
  return 1024 + 64 * NWG * ROW_BYTES + 2 * STAGES * KV_TILE_BYTES + 8 * (2 * STAGES + 1);
}

// Scores of keys past Sk (only in the last tile, starting at key kv0) to -inf.
__device__ __forceinline__ void mask_keys(float (&s)[64], int kv0, int Sk, int t) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const int col = kv0 + 8 * j + 2 * t;
    if (col >= Sk) s[4 * j] = s[4 * j + 2] = -INFINITY;
    if (col + 1 >= Sk) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
  }
}

// One online-softmax step for rows g (r = 0) and g + 8 (r = 1): the new row
// max m (raw score units), the scores turned in place into P = exp2(S c -
// m c), the row sums l rescaled and added to. Returns in alpha the factor
// exp2((m_old - m) c) that O still has to be multiplied by. The max and the
// sum each run as 4 partial chains per row, so that their latency hides
// behind the exponentials.
__device__ __forceinline__ void softmax_step(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c) {
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      mx[r][k] = m[r];
      sum[r][k] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx[0][j & 3] = fmaxf(mx[0][j & 3], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1][j & 3] = fmaxf(mx[1][j & 3], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    alpha[r] = ex2((m[r] - x) * c);  // 0 on the first tile (m = -inf)
    m[r] = x;
    mc[r] = x * c;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], c, -mc[e >> 1]));
      sum[e >> 1][j & 3] += s[4 * j + e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l[r] * alpha[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
  }
}

template <int NWG, bool BHSD>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                float* __restrict__ lse, int Sq, int Sk, int heads, float c) {
  constexpr int BQ = 64 * NWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle needs 1024 B
  const uint32_t k_s = q_s + BQ * ROW_BYTES;
  const uint32_t v_s = k_s + STAGES * KV_TILE_BYTES;
  const uint32_t bars = v_s + STAGES * KV_TILE_BYTES;  // full, then empty, per stage; Q's
  const uint32_t q_bar = bars + 16 * STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int n_tiles = (Sk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == NWG * 128) {  // the producer's thread: descriptors early
    tma_prefetch_map(&q_map);
    tma_prefetch_map(&k_map);
    tma_prefetch_map(&v_map);
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
    // producer: one thread issues every load of the CTA
    setmaxnreg_dec<producer_regs(NWG)>();
    if (threadIdx.x == NWG * 128) {
      const int c0 = BHSD ? 0 : h * D, c2 = BHSD ? b * heads + h : b;
      mbar_arrive_expect_tx(q_bar, BQ * ROW_BYTES);
      tma_load_3d(q_s, &q_map, c0, q0, c2, q_bar);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(full(s), 2 * KV_TILE_BYTES);
        tma_load_3d(k_s + s * KV_TILE_BYTES, &k_map, c0, i * BK, c2, full(s));
        tma_load_3d(v_s + s * KV_TILE_BYTES, &v_map, c0, i * BK, c2, full(s));
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg .. q0 + 64 wg + 63. The
    // products of tile i are issued together, S_i = Q K_i^T first and then
    // O += P_{i-1} V_{i-1}, so that P V runs while the softmax of S_i does;
    // O is rescaled once P V is done.
    setmaxnreg_inc<consumer_regs(NWG)>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint64_t q_desc = desc_sw128(q_s + wg * 64 * ROW_BYTES);
    auto k_desc = [&](int s) { return desc_sw128(k_s + s * KV_TILE_BYTES); };
    auto v_desc = [&](int s) { return desc_sw128(v_s + s * KV_TILE_BYTES); };
    const int last_masked = Sk % BK != 0 ? n_tiles - 1 : -1;

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float s_acc[64];
    uint32_t p[BK / 16][4];
    float m[2] = {-INFINITY, -INFINITY};  // row max of the raw scores, rows g and g + 8
    float l[2] = {0.f, 0.f};              // this thread's share of the row sums
    float alpha[2];

    mbar_wait(q_bar, 0);
    mbar_wait(full(0), 0);
    wgmma_fence();
    issue_scores(s_acc, q_desc, k_desc(0));
    wgmma_wait<0>();
    fence_regs(s_acc);
    if (last_masked == 0) mask_keys(s_acc, 0, Sk, t);
    softmax_step(s_acc, m, l, alpha, c);
    pack_p(p, s_acc);

    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % STAGES, prev = (i - 1) % STAGES;
      mbar_wait(full(s), (i / STAGES) & 1);
      wgmma_fence();
      issue_scores(s_acc, q_desc, k_desc(s));
      issue_pv(o, p, v_desc(prev));
      wgmma_wait<1>();  // the scores; P V may still run
      fence_regs(s_acc);
      if (i == last_masked) mask_keys(s_acc, i * BK, Sk, t);
      softmax_step(s_acc, m, l, alpha, c);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(s_acc);
      if (tid == 0) mbar_arrive(empty(prev));  // this warpgroup is done with stage prev
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      pack_p(p, s_acc);
    }
    wgmma_fence();
    issue_pv(o, p, v_desc((n_tiles - 1) % STAGES));
    wgmma_wait<0>();
    fence_regs(o);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row0 = q0 + wg * 64 + warp * 16 + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      const float inv = 1.f / l[r];
      const size_t at = BHSD ? ((size_t)b * heads + h) * Sq + row : ((size_t)b * Sq + row) * heads + h;
      __nv_bfloat16* orow = out + at * D;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
      if (t == 0) lse[at] = m[r] * c * LN2 + logf(l[r]);
    }
  }
}

// Returns 0, a CUDA error code after the launch, or minus the CUresult of a
// failed tensor-map encode.
template <int NWG, bool BHSD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq,
           int Sk, int heads, float scale, int dev, cudaStream_t stream) {
  constexpr int SMEM = smem_bytes<NWG>();
  const EncodeTiled fn = encode_fn();
  if (!fn) return static_cast<int>(cudaErrorSymbolNotFound);
  // packed: {H*D, S, B}; (B, H, S, D): {D, S, B*H}
  const int row_elems = BHSD ? D : heads * D, outer = BHSD ? B * heads : B;
  CUtensorMap q_map, k_map, v_map;
  int err = encode(fn, &q_map, q, row_elems, Sq, outer, 64 * NWG);
  if (!err) err = encode(fn, &k_map, k, row_elems, Sk, outer, BK);
  if (!err) err = encode(fn, &v_map, v, row_elems, Sk, outer, BK);
  if (err) return -err;

  auto kernel = flash_fwd_wgmma<NWG, BHSD>;
  const cudaError_t e = allow_smem<flash_fwd_wgmma<NWG, BHSD>>(SMEM, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + 64 * NWG - 1) / (64 * NWG), heads, B);
  kernel<<<grid, 128 * (NWG + 1), SMEM, stream>>>(q_map, k_map, v_map,
                                                   static_cast<__nv_bfloat16*>(out),
                                                   static_cast<float*>(lse), Sq, Sk, heads,
                                                   scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// 3 consumer warpgroups when the grid's waves on device dev's SMs times the
// rows per CTA come out no larger than with 2 (one CTA per SM).
bool three_consumers(int B, int Sq, int heads, int dev) {
  static int sms_of[MAX_DEVICES] = {};
  int sms = dev < MAX_DEVICES ? sms_of[dev] : 0;
  if (!sms) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) sms = 132;
    if (dev < MAX_DEVICES) sms_of[dev] = sms;
  }
  auto cost = [&](int bq) {
    const long long ctas = (long long)((Sq + bq - 1) / bq) * heads * B;
    return (ctas + sms - 1) / sms * bq;
  };
  return cost(192) <= cost(128);
}

template <bool BHSD>
int launch_any(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq,
               int Sk, int heads, int head_dim, float scale, void* stream) {
  if (head_dim != D || B <= 0 || Sq <= 0 || Sk <= 0 || heads <= 0 || B > 65535 ||
      heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return three_consumers(B, Sq, heads, dev)
             ? launch<3, BHSD>(q, k, v, out, lse, B, Sq, Sk, heads, scale, dev, st)
             : launch<2, BHSD>(q, k, v, out, lse, B, Sq, Sk, heads, scale, dev, st);
}

}  // namespace

// K1. q: (B, Sq, heads*head_dim), k and v: (B, Sk, heads*head_dim), all bf16
// and contiguous, 16-byte aligned; out: like q; lse: (B, Sq, heads) f32.
// Returns 0 or an error code (see launch) after the launch on `stream`.
extern "C" int flash_attn_fwd_packed_bf16(const void* q, const void* k, const void* v,
                                          void* out, void* lse, int B, int Sq, int Sk,
                                          int heads, int head_dim, float scale,
                                          void* stream) {
  return launch_any<false>(q, k, v, out, lse, B, Sq, Sk, heads, head_dim, scale, stream);
}

// K5. q: (B, heads, Sq, head_dim), k and v: (B, heads, Sk, head_dim), all
// bf16 and contiguous, 16-byte aligned; out: like q; lse: (B, heads, Sq) f32.
extern "C" int flash_attn_fwd_bhsd_bf16(const void* q, const void* k, const void* v,
                                        void* out, void* lse, int B, int Sq, int Sk,
                                        int heads, int head_dim, float scale, void* stream) {
  return launch_any<true>(q, k, v, out, lse, B, Sq, Sk, heads, head_dim, scale, stream);
}

// Dynamic shared memory of one CTA with `consumers` (2 or 3) consumer
// warpgroups, for the build report.
extern "C" int flash_attn_fwd_smem_bytes(int consumers) {
  return consumers == 3 ? smem_bytes<3>() : smem_bytes<2>();
}
