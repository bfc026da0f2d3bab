// K2: GroupNorm(+SiLU) forward for Hopper (sm_90a) on NHWC bf16, f32 stats.
//
// Replaces the TPU kernel mvd_tpu/kernels/groupnorm_silu.py:_gn_silu_kernel
// (called by _pallas_gn_silu). Same function: per-group f32 sum and sum of
// squares; mean = sum/n, var = max(sumsq/n - mean^2, 0), rstd =
// rsqrt(var + eps); y = x * a + b in f32 with a = rstd * gamma and
// b = beta - mean * a, then an optional SiLU, stored in bf16.
//
// Bound on the H100: bytes (x read once, y written once). The TPU kernel
// kept a whole batch row in VMEM and ran one program per row; here a row is
// cut into group sets (a multiple of 8 channels and of C/G, so that every
// row segment is 16-byte aligned and holds whole groups), and the launch
// plan, worked out in Python (kernels/groupnorm_silu.py:launch_plan), picks
// one of two paths:
//
//  path 0, one launch (gn_fused_cluster): one thread-block cluster per
//    (batch row, group set). Each CTA copies its share of the slab's rows
//    into shared memory with 16-byte cp.async in four stages, and sums each
//    stage while the next is in flight; the CTA folds its per-channel sums
//    into per-group partials in a fixed order; after barrier.cluster every
//    CTA gathers all ranks' partials through distributed shared memory
//    (map_shared_rank) and sums them in rank order, then applies from its
//    own shared memory. x is read from HBM once, with no memset, no scratch
//    in device memory and no atomics, so two launches are bitwise equal.
//  path 1, two launches, where the plan finds no cluster whose CTAs hold
//    at most 128 KB of x each in row segments of 64 bytes or more
//    (gn_partial_stats, gn_partial_apply): a (row chunk, group set, batch)
//    grid; the first kernel writes each CTA's per-group partials to
//    scratch, the second sums every chunk's partials in a fixed order and
//    applies. No memset and no atomics either; x is read twice, and the
//    apply walks its rows backwards so that it starts on the rows the first
//    kernel read last, which may still sit in the 50 MB L2.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;   // 8 portable, 16 with the non-portable attribute
constexpr int kSmemMax = 232448;  // 227 KB of dynamic shared memory per CTA
constexpr int kStages = 4;        // cp.async commit groups per CTA on path 0
constexpr int kUnroll = 4;        // 16-byte loads in flight per thread on path 1
constexpr bool kApplyReversed = true;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Thread layout shared by every kernel: a row segment of the set holds
// vpr = set/8 16-byte vectors; thread t takes vector (t % vpr) of rows
// t / vpr, t / vpr + rows_par, ...; the last threads of the CTA idle when
// vpr does not divide the block.
struct Lanes {
  int vpr, rows_par, lane, rp;
  bool active;
};

__device__ __forceinline__ Lanes lanes_of(int set) {
  Lanes L;
  L.vpr = set / 8;
  L.rows_par = blockDim.x / L.vpr;
  L.lane = threadIdx.x % L.vpr;
  L.rp = threadIdx.x / L.vpr;
  L.active = L.rp < L.rows_par;
  return L;
}

__device__ __forceinline__ void accumulate(const uint4& raw, float (&s)[8], float (&q)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(p[j]);
    s[2 * j] += f.x;
    q[2 * j] = fmaf(f.x, f.x, q[2 * j]);
    s[2 * j + 1] += f.y;
    q[2 * j + 1] = fmaf(f.y, f.y, q[2 * j + 1]);
  }
}

// Folds every thread's per-channel sums (s, q over its 8 channels) into
// per-group sums of the set in a fixed order, with every warp at work: the
// (thread row, channel) terms of a group are split over wpg warps, each
// lane sums a strided share, a butterfly adds the lanes, and one thread
// adds the warps' sums in warp order. Writes out[2g], out[2g+1] for the
// set's groups g. red holds 2 * rows_par * set floats, wsum 2 * max(groups,
// warps). Ends with __syncthreads.
__device__ void fold_groups(float* red, float* wsum, float* out, const Lanes& L, int set, int cpg,
                            const float (&s)[8], const float (&q)[8]) {
  const int n = L.rows_par * set, gs = set / cpg, warps = blockDim.x / 32;
  if (L.active) {
    float4* rs = reinterpret_cast<float4*>(red + L.rp * set + L.lane * 8);
    float4* rq = reinterpret_cast<float4*>(red + n + L.rp * set + L.lane * 8);
    rs[0] = make_float4(s[0], s[1], s[2], s[3]);
    rs[1] = make_float4(s[4], s[5], s[6], s[7]);
    rq[0] = make_float4(q[0], q[1], q[2], q[3]);
    rq[1] = make_float4(q[4], q[5], q[6], q[7]);
  }
  __syncthreads();
  const int wpg = max(1, warps / gs), terms = L.rows_par * cpg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int task = warp; task < gs * wpg; task += warps) {
    const int g = task / wpg;
    float a = 0.f, b = 0.f;
    for (int e = task % wpg * 32 + lane; e < terms; e += wpg * 32) {
      const int i = e / cpg * set + g * cpg + e % cpg;
      a += red[i];
      b += red[n + i];
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      wsum[2 * task] = a;
      wsum[2 * task + 1] = b;
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < gs; g += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < wpg; ++j) {
      a += wsum[2 * (g * wpg + j)];
      b += wsum[2 * (g * wpg + j) + 1];
    }
    out[2 * g] = a;
    out[2 * g + 1] = b;
  }
  __syncthreads();
}

__device__ __forceinline__ void mean_rstd(float sum, float sumsq, float inv_n, float eps,
                                          float* dst) {
  const float mean = sum * inv_n;
  dst[0] = mean;
  dst[1] = rsqrtf(fmaxf(sumsq * inv_n - mean * mean, 0.f) + eps);
}

// y = x * a + b for the thread's 8 channels: a = rstd * gamma, b = beta -
// mean * a, from stats[2g] = mean, stats[2g+1] = rstd of the set's groups.
__device__ __forceinline__ void coefficients(const float* stats, const float* __restrict__ gamma,
                                             const float* __restrict__ beta, int c_set, int c0,
                                             int cpg, float (&a)[8], float (&b)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int g = (c_set + j) / cpg;
    a[j] = stats[2 * g + 1] * gamma[c0 + j];
    b[j] = beta[c0 + j] - stats[2 * g] * a[j];
  }
}

__device__ __forceinline__ float fast_rcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint4 apply8(const uint4& raw, const float (&a)[8], const float (&b)[8],
                                        bool silu) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 res;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(p[j]);
    float y0 = fmaf(f.x, a[2 * j], b[2 * j]);
    float y1 = fmaf(f.y, a[2 * j + 1], b[2 * j + 1]);
    if (silu) {
      y0 *= fast_rcp(1.f + __expf(-y0));
      y1 *= fast_rcp(1.f + __expf(-y1));
    }
    o[j] = __floats2bfloat162_rn(y0, y1);
  }
  return res;
}

// Shared memory of every path (bytes), in the order the kernels lay it out:
// path 0 the slab (rows x set bf16, rounded up to 16 bytes), then on every
// path the fold's 2 x rows_par x set floats, 2 x 2 floats per group of the
// set (partials, then mean and rstd) and the fold's 2 x max(groups, warps)
// warp sums. kernels/groupnorm_silu.py:_smem_bytes is the same formula.
__host__ __device__ inline int smem_bytes(int path, int rows, int set, int threads, int cpg) {
  const int slab = path == 0 ? (rows * set * 2 + 15) / 16 * 16 : 0;
  const int gs = set / cpg;
  return slab + 2 * (threads / (set / 8)) * set * 4 + 4 * gs * 4 +
         2 * (gs > threads / 32 ? gs : threads / 32) * 4;
}

// The regions of a CTA's shared memory after the slab: the fold's terms,
// the set's partials, its (mean, rstd) and the fold's warp sums.
struct Regions {
  float *red, *part, *stats, *wsum;
};

__device__ __forceinline__ Regions regions(unsigned char* smem, int slab_bytes, const Lanes& L,
                                           int set, int gs) {
  Regions R;
  R.red = reinterpret_cast<float*>(smem + slab_bytes);
  R.part = R.red + 2 * L.rows_par * set;
  R.stats = R.part + 2 * gs;
  R.wsum = R.stats + 2 * gs;
  return R;
}

// Path 0. Grid (sets * cluster, B), cluster (cluster, 1, 1); CTA `rank`
// of a cluster holds rows [rank * rows, (rank + 1) * rows) of the set.
__global__ void __launch_bounds__(kMaxThreads)
    gn_fused_cluster(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, __nv_bfloat16* __restrict__ y, int HW,
                     int C, int cpg, int set, int rows, float inv_n, float eps, int silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.dim_blocks().x);
  const int rank = static_cast<int>(cluster.block_rank());
  const int gset = blockIdx.x / cs, gs = set / cpg;
  const Lanes L = lanes_of(set);
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem);
  const Regions R = regions(smem, (rows * set * 2 + 15) / 16 * 16, L, set, gs);
  const int row0 = rank * rows;
  const int nrows = max(0, min(rows, HW - row0));
  const int mine = L.active && L.rp < nrows ? (nrows - L.rp + L.rows_par - 1) / L.rows_par : 0;
  const size_t base = (static_cast<size_t>(blockIdx.y) * HW + row0) * C +
                      static_cast<size_t>(gset) * set + L.lane * 8;
  __nv_bfloat16* own = slab + L.rp * set + L.lane * 8;  // this thread's first vector
  const int step = L.rows_par * set;
  const int per = (mine + kStages - 1) / kStages;
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    for (int k = st * per; k < min(mine, (st + 1) * per); ++k) {
      cp_async16(own + k * step, x + base + static_cast<size_t>(L.rp + k * L.rows_par) * C);
    }
    cp_async_commit();
  }
  // each thread reads back only the vectors it copied itself
  float s[8] = {}, q[8] = {};
  auto take = [&](int st) {
    for (int k = st * per; k < min(mine, (st + 1) * per); ++k) {
      accumulate(*reinterpret_cast<const uint4*>(own + k * step), s, q);
    }
  };
  cp_async_wait<3>();
  take(0);
  cp_async_wait<2>();
  take(1);
  cp_async_wait<1>();
  take(2);
  cp_async_wait<0>();
  take(3);
  fold_groups(R.red, R.wsum, R.part, L, set, cpg, s, q);

  cluster.sync();  // every CTA's partials are written
  // one float of one rank's partials per thread, gathered into the fold's
  // (now free) terms, then summed in rank order
  for (int t = threadIdx.x; t < cs * 2 * gs; t += blockDim.x) {
    R.red[t] = cluster.map_shared_rank(R.part, t / (2 * gs))[t % (2 * gs)];
  }
  cluster_arrive();  // done with the other CTAs' shared memory
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < gs) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < cs; ++r) {
      a += R.red[r * 2 * gs + 2 * threadIdx.x];
      b += R.red[r * 2 * gs + 2 * threadIdx.x + 1];
    }
    mean_rstd(a, b, inv_n, eps, R.stats + 2 * threadIdx.x);
  }
  __syncthreads();
  if (mine) {
    float a[8], b[8];
    coefficients(R.stats, gamma, beta, L.lane * 8, gset * set + L.lane * 8, cpg, a, b);
    for (int k = 0; k < mine; ++k) {
      const uint4 v = *reinterpret_cast<const uint4*>(own + k * step);
      *reinterpret_cast<uint4*>(y + base + static_cast<size_t>(L.rp + k * L.rows_par) * C) =
          apply8(v, a, b, silu);
    }
  }
  cluster_wait();  // no CTA leaves while another may still read its partials
}

// Path 1, first launch. Grid (chunks, sets, B); chunk i holds rows
// [i * rows, (i + 1) * rows). part: (B, G, chunks, 2) f32.
__global__ void __launch_bounds__(kMaxThreads)
    gn_partial_stats(const __nv_bfloat16* __restrict__ x, float* __restrict__ part, int HW, int C,
                     int G, int cpg, int set, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Lanes L = lanes_of(set);
  const int chunk = blockIdx.x, gset = blockIdx.y, gs = set / cpg;
  const Regions R = regions(smem, 0, L, set, gs);
  const int row0 = chunk * rows, nrows = min(rows, HW - row0);
  float s[8] = {}, q[8] = {};
  if (L.active) {
    const __nv_bfloat16* xb = x + (static_cast<size_t>(blockIdx.z) * HW + row0) * C +
                              static_cast<size_t>(gset) * set + L.lane * 8;
    const size_t stride = static_cast<size_t>(L.rows_par) * C;
    int r = L.rp;
    for (; r + (kUnroll - 1) * L.rows_par < nrows; r += kUnroll * L.rows_par) {
      uint4 v[kUnroll];
      const __nv_bfloat16* p = xb + static_cast<size_t>(r) * C;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(reinterpret_cast<const uint4*>(p + u * stride));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) accumulate(v[u], s, q);
    }
    for (; r < nrows; r += L.rows_par) {
      accumulate(__ldg(reinterpret_cast<const uint4*>(xb + static_cast<size_t>(r) * C)), s, q);
    }
  }
  fold_groups(R.red, R.wsum, R.part, L, set, cpg, s, q);
  if (static_cast<int>(threadIdx.x) < gs) {
    float* p = part + ((static_cast<size_t>(blockIdx.z) * G + gset * gs + threadIdx.x) *
                           gridDim.x + chunk) * 2;
    p[0] = R.part[2 * threadIdx.x];
    p[1] = R.part[2 * threadIdx.x + 1];
  }
}

// Path 1, second launch, on gn_partial_stats' grid: each CTA sums its
// groups' partials over every chunk (one warp per group: lanes over chunks,
// then a butterfly, the same order in every CTA) and applies to its chunk.
__global__ void __launch_bounds__(kMaxThreads)
    gn_partial_apply(const __nv_bfloat16* __restrict__ x, const float* __restrict__ part,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     __nv_bfloat16* __restrict__ y, int HW, int C, int G, int cpg, int set,
                     int rows, float inv_n, float eps, int silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Lanes L = lanes_of(set);
  const int chunk = blockIdx.x, chunks = gridDim.x, gset = blockIdx.y, gs = set / cpg;
  float* stats = regions(smem, 0, L, set, gs).stats;
  const int warp = threadIdx.x / 32, lane32 = threadIdx.x % 32;
  for (int g = warp; g < gs; g += blockDim.x / 32) {
    const float* p = part + (static_cast<size_t>(blockIdx.z) * G + gset * gs + g) * chunks * 2;
    float a = 0.f, b = 0.f;
    for (int i = lane32; i < chunks; i += 32) {
      a += p[2 * i];
      b += p[2 * i + 1];
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane32 == 0) mean_rstd(a, b, inv_n, eps, stats + 2 * g);
  }
  __syncthreads();
  const int row0 = chunk * rows, nrows = min(rows, HW - row0);
  if (!L.active || L.rp >= nrows) return;
  const int mine = (nrows - L.rp + L.rows_par - 1) / L.rows_par;
  float a[8], b[8];
  coefficients(stats, gamma, beta, L.lane * 8, gset * set + L.lane * 8, cpg, a, b);
  const size_t base = (static_cast<size_t>(blockIdx.z) * HW + row0 + L.rp) * C +
                      static_cast<size_t>(gset) * set + L.lane * 8;
  const size_t stride = static_cast<size_t>(L.rows_par) * C;
  auto at = [&](int k) { return base + (kApplyReversed ? mine - 1 - k : k) * stride; };
  int k = 0;
  for (; k + kUnroll <= mine; k += kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(reinterpret_cast<const uint4*>(x + at(k + u)));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      *reinterpret_cast<uint4*>(y + at(k + u)) = apply8(v[u], a, b, silu);
    }
  }
  for (; k < mine; ++k) {
    *reinterpret_cast<uint4*>(y + at(k)) =
        apply8(__ldg(reinterpret_cast<const uint4*>(x + at(k))), a, b, silu);
  }
}

// Raises the kernels' dynamic shared-memory limit to kSmemMax and allows
// clusters of 16 on device dev, once per device.
cudaError_t prepare(int dev) {
  static bool done[kMaxDevices] = {};
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(gn_fused_cluster,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gn_fused_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gn_partial_stats, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gn_partial_apply, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  }
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

}  // namespace

// x, y: (B, HW, C) bf16 contiguous, 16-byte aligned, C % 8 == 0, C % G == 0;
// gamma, beta: (C,) f32. The plan (path, cluster, set, rows, threads, smem)
// comes from kernels/groupnorm_silu.py:launch_plan; path 1 also takes
// scratch: (B, G, ceil(HW / rows), 2) f32, which it fully overwrites.
// Launches on `stream` of the current device and returns 0 or a CUDA error
// code (cudaErrorInvalidValue for a plan that does not fit the shape).
extern "C" int groupnorm_silu_bf16(const void* x, const void* gamma, const void* beta, void* y,
                                   void* scratch, int B, int HW, int C, int G, float eps,
                                   int silu, int path, int cluster, int set, int rows,
                                   int threads, int smem, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || C % 8 || G <= 0 || C % G) return bad;
  const int cpg = C / G;
  if (set <= 0 || C % set || set % 8 || set % cpg || rows <= 0) return bad;
  if (threads % 32 || threads > kMaxThreads || threads < set / 8) return bad;
  if (smem != smem_bytes(path, rows, set, threads, cpg) || smem > kSmemMax) return bad;
  const int sets = C / set;
  const long long chunks = (static_cast<long long>(HW) + rows - 1) / rows;
  if (path == 0) {
    // the cluster's partials are gathered into the fold's terms
    const int terms = 2 * (threads / (set / 8)) * set;
    if (cluster < 1 || cluster > kMaxCluster || chunks != cluster || cluster * 2 * (set / cpg) > terms) {
      return bad;
    }
  } else if (path != 1 || cluster != 1 || !scratch || sets > 65535 || chunks > 0x7fffffff) {
    return bad;
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = prepare(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* gp = static_cast<const float*>(gamma);
  const auto* bp = static_cast<const float*>(beta);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  const float inv_n = 1.f / (static_cast<float>(HW) * static_cast<float>(cpg));
  if (path == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(sets * cluster, B);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, gn_fused_cluster, xp, gp, bp, yp, HW, C, cpg, set, rows, inv_n,
                           eps, silu);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>(chunks), sets, B);
  float* part = static_cast<float*>(scratch);
  gn_partial_stats<<<grid, threads, smem, st>>>(xp, part, HW, C, G, cpg, set, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gn_partial_apply<<<grid, threads, smem, st>>>(xp, part, gp, bp, yp, HW, C, G, cpg, set, rows,
                                                inv_n, eps, silu);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` CTAs of `threads` threads and `smem` bytes
// of shared memory the current device holds at once (path 0), or -1 on an
// error.
extern "C" int groupnorm_silu_max_clusters(int cluster, int threads, int smem) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || prepare(dev) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, gn_fused_cluster, &cfg) == cudaSuccess ? n : -1;
}
