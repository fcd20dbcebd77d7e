// The GroupNorm kernels shared by the fused GroupNorm (groupnorm.cu, K3) and
// the prologue of the fused GroupNorm+SiLU+conv3x3 (gn_conv.cu, K2/K4):
// y = act(GN(x + add[b, c])) over channel-last rows x (B, M, C), fp32
// moments, `add` folded into them (s2 += 2*t*s1 + M*t^2, s1 += M*t, as
// imagdressing_tpu/kernels/fused_groupnorm.py:57-116 does), the group
// variance as E[x^2] - E[x]^2, one rounding of the output. The design is
// in groupnorm.cu's note; fused_groupnorm.py:gn_plan picks the mode and
// tiles, and gn_launch below runs them.
//
// Resident mode (gn_resident): one launch. A cluster of `cs` blocks owns
// one (batch row, slab of sw channels); each block loads its rows of the
// slab into shared memory by TMA, sums them, reads every rank's partials
// through distributed shared memory in rank order, then normalizes its
// rows from shared memory straight into y.
//
// Streaming mode (gn_stream_stats, then gn_apply): a cluster of blocks sums
// a range of whole rows, rank 0 adds the ranks' partials (DSMEM, rank order)
// into one partial per cluster, and the last cluster of the batch row to
// arrive (an integer arrival counter) adds the clusters' partials in index
// order and writes scale/shift; the apply pass then reads x again.
//
// No float atomics: every sum has a fixed order, so two runs give the same
// bits.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

constexpr int GN_THREADS = 256;
constexpr int GN_MAX_SLAB = 256;    // channels of a slab: a TMA box's width
constexpr int GN_BOX_ROWS = 256;    // rows of a TMA box: the box limit
constexpr int GN_MAX_CLUSTER = 8;   // blocks of a cluster: the portable limit
constexpr int GN_SMEM_LIMIT = 232448;
// the row lanes' (s1, s2) x 8 channels of every thread, then (s1, s2) of
// up to GN_THREADS partial sums over lanes
constexpr int GN_RED_FLOATS = 2 * GN_THREADS * 8 + 2 * GN_THREADS;
constexpr int GN_MAX_BOXES = 64;    // TMA boxes (and mbarriers) of a block
// a resident block's shared memory beside its rows: alignment slack, the
// lanes' partials, three float2 per slab channel (the block's partials, the
// cluster's totals, the channels' scale and shift), the boxes' mbarriers.
// fused_groupnorm.py:FIXED_SMEM mirrors it.
constexpr int GN_FIXED_SMEM =
    128 + GN_RED_FLOATS * 4 + 3 * GN_MAX_SLAB * 8 + GN_MAX_BOXES * 8;

// fused_groupnorm.py:GnPlan, field for field
struct GnPlan {
  int resident;           // 1: one launch with the rows resident; 0: streaming
  int cs;                 // blocks per cluster
  int sw;                 // resident: channels of a slab (whole groups, 8 | sw)
  int box_rows, nboxes;   // resident: rows per TMA box, boxes per block
  int nclusters;          // streaming: clusters per batch row
  int rows_per_block;     // streaming: rows per block
};

// Add the row lanes' per-thread sums (thread t: channels 8 * (t % ngrp) of
// width = 8 * ngrp, row lane t / ngrp of `lanes`) into part[0, width) in a
// fixed order: red holds lane-major (lanes, width) s1 then s2; K =
// GN_THREADS / width threads per channel each add a run of consecutive lanes,
// then one thread per channel adds the K runs in order. Every thread of the
// block calls it; it ends with part written but not synchronised.
__device__ void reduce_lanes(const float (&s1)[8], const float (&s2)[8], int lanes, int width,
                             float* red, float2* part) {
  const int tid = threadIdx.x;
  float* red2 = red + GN_THREADS * 8;
  float* run1 = red2 + GN_THREADS * 8;
  float* run2 = run1 + GN_THREADS;
  if (tid < lanes * (width / 8)) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[tid * 8 + j] = s1[j];
      red2[tid * 8 + j] = s2[j];
    }
  }
  __syncthreads();
  const int K = GN_THREADS / width;
  if (K <= 1) {  // wide rows: few lanes, one thread per channel adds them
    for (int c = tid; c < width; c += GN_THREADS) {
      float a = 0.f, q = 0.f;
      for (int l = 0; l < lanes; ++l) {
        a += red[l * width + c];
        q += red2[l * width + c];
      }
      part[c] = make_float2(a, q);
    }
    return;
  }
  const int per = (lanes + K - 1) / K, c = tid % width, k = tid / width;
  if (k < K) {
    float a = 0.f, q = 0.f;
    const int l1 = min(lanes, (k + 1) * per);
#pragma unroll 4
    for (int l = k * per; l < l1; ++l) {
      a += red[l * width + c];
      q += red2[l * width + c];
    }
    run1[tid] = a;
    run2[tid] = q;
  }
  __syncthreads();
  if (tid < width) {
    float a = 0.f, q = 0.f;
    for (int kk = 0; kk < K; ++kk) {
      a += run1[kk * width + tid];
      q += run2[kk * width + tid];
    }
    part[tid] = make_float2(a, q);
  }
}

__device__ __forceinline__ void add_moments(const float (&v)[8], float (&s1)[8], float (&s2)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s1[j] += v[j];
    s2[j] += v[j] * v[j];
  }
}

// Per-channel fp32 (s1, s2) over rows [0, rows) of a row-major tile of
// `width` channels (row stride `stride` elements) into part[0, width): 8
// channels (one 16-byte load of bf16) per thread with the rows dealt to row
// lanes of threads, then reduce_lanes. Every thread of the block calls it;
// it ends synchronised.
template <typename T>
__device__ void channel_sums(const T* p, long long stride, int rows, int width, float* red,
                             float2* part) {
  const int tid = threadIdx.x, ngrp = width / 8;
  if (ngrp > GN_THREADS) {  // wide rows: a thread per 8 channels, every row
    for (int cg = tid; cg < ngrp; cg += GN_THREADS) {
      float s1[8] = {}, s2[8] = {};
      for (int r = 0; r < rows; ++r) {
        float v[8];
        load8(p + r * stride + cg * 8, v);
        add_moments(v, s1, s2);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) part[cg * 8 + j] = make_float2(s1[j], s2[j]);
    }
    __syncthreads();
    return;
  }
  const int lanes = GN_THREADS / ngrp, cg = tid % ngrp, rl = tid / ngrp;
  float s1[8] = {}, s2[8] = {};
  if (rl < lanes) {
#pragma unroll 4
    for (int r = rl; r < rows; r += lanes) {
      float v[8];
      load8(p + r * stride + cg * 8, v);
      add_moments(v, s1, s2);
    }
  }
  reduce_lanes(s1, s2, lanes, width, red, part);
  __syncthreads();
}

// The sum over the cluster's ranks, in rank order, of the float2 at p's
// offset in each block's shared memory (after a cluster barrier). The loads
// are all issued before the first add.
__device__ __forceinline__ float2 cluster_sum(const float2* p, int cs) {
  float2 v[GN_MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < GN_MAX_CLUSTER; ++r)
    if (r < cs) v[r] = ld_cluster(p, r);
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int r = 0; r < GN_MAX_CLUSTER; ++r)
    if (r < cs) {
      s.x += v[r].x;
      s.y += v[r].y;
    }
  return s;
}

// (scale, shift) of channel c from the add-folded channel totals of its
// whole group (tot[c - c % cpg, ... + cpg)), added in channel order by every
// thread that asks, so all get the same bits: mean = sum s1 / n, rstd =
// rsqrt(sum s2 / n - mean^2 + eps), scale = gamma * rstd, shift = beta -
// mean * scale + add * scale (add = 0 without one).
__device__ __forceinline__ float2 channel_scale_shift(const float2* tot, int c, int cpg, float n,
                                                      float eps, float gamma, float beta,
                                                      float add) {
  const float2* g = tot + (c - c % cpg);
  float a = 0.f, q = 0.f;
#pragma unroll 4
  for (int i = 0; i < cpg; ++i) {
    a += g[i].x;
    q += g[i].y;
  }
  const float mean = a / n;
  const float sc = rsqrtf(q / n - mean * mean + eps) * gamma;
  return make_float2(sc, beta - mean * sc + add * sc);
}

// silu on the special-function unit's exp2 and reciprocal (two operations),
// where expf and an IEEE division would set the normalize passes' pace
__device__ __forceinline__ float silu_fast(float y) { return __fdividef(y, 1.f + __expf(-y)); }

// fold the per-(B, C) bias t into a channel's moments over M rows
__device__ __forceinline__ float2 fold_add(float s1, float s2, float t, float fm) {
  s2 += 2.f * t * s1 + fm * t * t;
  s1 += fm * t;
  return make_float2(s1, s2);
}

struct GnArgs {
  const void* add;  // T (B, C) or null
  const void* gamma;
  const void* beta;
  void* out;  // T (B, M, C)
  int M, C, G;
  float eps;
  int act_silu;
  int sw, box_rows, nboxes;
};

// Resident mode. Grid (cs, C / sw, B), cluster (cs, 1, 1): block `rank`
// holds rows [rank * rpb, (rank + 1) * rpb) of the slab, rpb = box_rows *
// nboxes, box i landing on mbarrier i; rows at or past M come in as TMA's
// zero fill and are never written.
template <typename T>
__global__ void __launch_bounds__(GN_THREADS)
    gn_resident(const GnArgs a, const __grid_constant__ CUtensorMap xmap) {
  extern __shared__ unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127));
  const int rpb = a.box_rows * a.nboxes, sw = a.sw;
  float* red = reinterpret_cast<float*>(xs + (size_t)rpb * sw);
  float2* part = reinterpret_cast<float2*>(red + GN_RED_FLOATS);
  float2* tot = part + GN_MAX_SLAB;
  float2* ss = tot + GN_MAX_SLAB;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ss + GN_MAX_SLAB);

  const int tid = threadIdx.x, rank = blockIdx.x, cs = gridDim.x, b = blockIdx.z;
  const int c0 = blockIdx.y * sw, m0 = rank * rpb;
  const int rows = max(0, min(rpb, a.M - m0));

  if (tid == 0) {
    prefetch_tensormap(&xmap);
    for (int i = 0; i < a.nboxes; ++i) mbar_init(&bar[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t box = (uint32_t)(a.box_rows * sw * sizeof(T));
    for (int i = 0; i < a.nboxes; ++i) {
      mbar_expect(&bar[i], box);
      tma_load_3d(xs + (size_t)i * a.box_rows * sw, &xmap, c0, m0 + i * a.box_rows, b, &bar[i]);
    }
  }
  // thread c < sw: channel c0 + c's parameters, fetched while the rows land
  float gamma = 0.f, beta = 0.f, add = 0.f;
  if (tid < sw) {
    gamma = to_f32(static_cast<const T*>(a.gamma)[c0 + tid]);
    beta = to_f32(static_cast<const T*>(a.beta)[c0 + tid]);
    if (a.add != nullptr) add = to_f32(static_cast<const T*>(a.add)[(size_t)b * a.C + c0 + tid]);
  }

  // thread t: channels 8 * (t % ngrp) of the slab, row lane t / ngrp taking
  // every lanes-th row; each box summed as soon as it lands
  const int ngrp = sw / 8, lanes = GN_THREADS / ngrp, cg = tid % ngrp, rl = tid / ngrp;
  const bool active = rl < lanes;
  {
    float s1[8] = {}, s2[8] = {};
    for (int i = 0; i < a.nboxes; ++i) {
      const int lo = i * a.box_rows, hi = min(rows, lo + a.box_rows);
      mbar_wait(&bar[i], 0);
      if (!active) continue;
#pragma unroll 4
      for (int r = lo + (rl - lo % lanes + lanes) % lanes; r < hi; r += lanes) {
        float v[8];
        load8(xs + r * sw + cg * 8, v);
        add_moments(v, s1, s2);
      }
    }
    reduce_lanes(s1, s2, lanes, sw, red, part);
  }

  // the cluster's totals: every block adds the ranks' partials in rank
  // order, so all get the same bits (a cluster of one skips the barriers)
  const float fm = (float)a.M;
  if (cs > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  if (tid < sw) {
    const float2 s = cs > 1 ? cluster_sum(part + tid, cs) : part[tid];
    tot[tid] = a.add != nullptr ? fold_add(s.x, s.y, add, fm) : s;
  }
  if (cs > 1) cluster_arrive();  // done with the peers' partials
  __syncthreads();
  if (tid < sw)
    ss[tid] = channel_scale_shift(tot, tid, a.C / a.G, fm * (float)(a.C / a.G), a.eps, gamma,
                                    beta, add);
  __syncthreads();

  // normalize the resident rows straight into y, 16 bytes a thread
  if (active) {
    float sc[8], sh[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j] = ss[cg * 8 + j].x;
      sh[j] = ss[cg * 8 + j].y;
    }
    T* y = static_cast<T*>(a.out) + ((size_t)b * a.M + m0) * a.C + c0 + cg * 8;
#pragma unroll 4
    for (int r = rl; r < rows; r += lanes) {
      float v[8];
      load8(xs + r * sw + cg * 8, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float t = v[j] * sc[j] + sh[j];
        v[j] = a.act_silu ? silu_fast(t) : t;
      }
      store8(y + (size_t)r * a.C, v);
    }
  }
  if (cs > 1) cluster_wait();  // our partials outlive the peers' reads
}

struct GnStreamArgs {
  const void* x;
  const void* add;
  const void* gamma;
  const void* beta;
  float2* cpart;    // (B, nclusters, C): one partial per cluster
  unsigned* count;  // (B,) arrival counters, zero on entry and on exit
  float* scale;     // (B, C)
  float* shift;     // (B, C)
  int M, C, G;
  float eps;
  int rows_per_block;
};

// Streaming statistics. Grid (cs, nclusters, B), cluster (cs, 1, 1): block
// (rank, k) sums rows [(k * cs + rank) * rows_per_block, ...) of batch row b.
template <typename T>
__global__ void __launch_bounds__(GN_THREADS) gn_stream_stats(const GnStreamArgs a) {
  extern __shared__ float smem_f[];
  float* red = smem_f;
  float2* part = reinterpret_cast<float2*>(red + GN_RED_FLOATS);  // C
  float2* tot = part + a.C;                                         // C
  int* is_last = reinterpret_cast<int*>(tot + a.C);
  const int tid = threadIdx.x, rank = blockIdx.x, cs = gridDim.x, k = blockIdx.y;
  const int ncl = gridDim.y, b = blockIdx.z, C = a.C;
  const long long m0 = (long long)(k * cs + rank) * a.rows_per_block;
  const int rows = (int)max(0ll, min((long long)a.rows_per_block, a.M - m0));
  const T* add_b = a.add != nullptr ? static_cast<const T*>(a.add) + (size_t)b * C : nullptr;
  channel_sums(static_cast<const T*>(a.x) + ((long long)b * a.M + m0) * C, C, rows, C, red,
               part);

  cluster_arrive();
  cluster_wait();
  float2* mine = a.cpart + ((size_t)b * ncl + k) * C;
  if (rank == 0) {
    for (int c = tid; c < C; c += GN_THREADS) mine[c] = cluster_sum(part + c, cs);
  }
  cluster_arrive();  // the peers' partials are read
  if (rank == 0) {
    __threadfence();
    __syncthreads();
    if (tid == 0) *is_last = atomicAdd(a.count + b, 1u) == (unsigned)(ncl - 1);
    __syncthreads();
    if (*is_last) {  // every cluster's partial is written: add them in order
      __threadfence();
      const float fm = (float)a.M;
      const float2* all = a.cpart + (size_t)b * ncl * C;
      for (int c = tid; c < C; c += GN_THREADS) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < ncl; ++kk) {
          const float2 p = __ldcg(all + (size_t)kk * C + c);
          s1 += p.x;
          s2 += p.y;
        }
        tot[c] = add_b != nullptr ? fold_add(s1, s2, to_f32(add_b[c]), fm) : make_float2(s1, s2);
      }
      __syncthreads();
      const int cpg = C / a.G;
      for (int c = tid; c < C; c += GN_THREADS) {
        const float2 ss = channel_scale_shift(
            tot, c, cpg, fm * (float)cpg, a.eps, to_f32(static_cast<const T*>(a.gamma)[c]),
            to_f32(static_cast<const T*>(a.beta)[c]), add_b != nullptr ? to_f32(add_b[c]) : 0.f);
        a.scale[(size_t)b * C + c] = ss.x;
        a.shift[(size_t)b * C + c] = ss.y;
      }
      if (tid == 0) a.count[b] = 0u;  // ready for the next launch
    }
  }
  cluster_wait();
}

// y = act(x * scale + shift) in fp32, rounded once to T; 8 channels (16
// bytes of bf16) per thread. Bound by bytes: one read of x, one write of y.
template <typename T>
__global__ void __launch_bounds__(256)
    gn_apply(const T* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ shift, T* __restrict__ out, long long n8, long long MC,
             int C, int act_silu) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 8;  // C % 8 == 0: the 8 lie in one (b, row)
    const long long b = e / MC;
    const int c = (int)(e % C);
    const float* sc = scale + b * C + c;
    const float* sh = shift + b * C + c;
    float v[8];
    load8(x + e, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float y = v[j] * sc[j] + sh[j];
      v[j] = act_silu ? silu_fast(y) : y;
    }
    store8(out + e, v);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename T>
constexpr CUtensorMapDataType gn_tma_type() {
  return sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// (C, M, B) rows of `p` in boxes of sw channels x box_rows rows; rows past M
// read as zeros
template <typename T>
static bool gn_rows_map(CUtensorMap* m, const void* p, int B, int M, int C, int sw,
                        int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)M, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(T), (cuuint64_t)M * C * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)sw, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(m, gn_tma_type<T>(), 3, const_cast<void*>(p), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a cluster launch of `kernel` over `grid`, cluster (cs, 1, 1); the kernel's
// dynamic shared memory limit is raised once per kernel, before any
// CUDA-graph capture
template <typename... Params, typename... Args>
static int gn_cluster_launch(void (*kernel)(Params...), bool& attributes_set, dim3 grid, int cs,
                             size_t smem, cudaStream_t st, Args&&... args) {
  if (!attributes_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GN_SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    attributes_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(GN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<Args&&>(args)...);
}

template <typename T>
static size_t gn_resident_smem(const GnPlan& p) {
  return GN_FIXED_SMEM + (size_t)p.box_rows * p.nboxes * p.sw * sizeof(T);
}
static size_t gn_stream_smem(int C) {
  return (size_t)GN_RED_FLOATS * 4 + (size_t)C * 16 + 16;
}

// The streaming statistics alone: scale/shift (B, C) fp32 for a plan with
// resident == 0. ws: the (B, nclusters, C) float2 cluster partials; count:
// B zeroed arrival counters (left zeroed).
template <typename T>
static int gn_stream_stats_launch(const T* x, const T* add, const T* gamma, const T* beta,
                                  int B, int M, int C, int G, float eps, const GnPlan& p,
                                  float2* cpart, unsigned* count, float* scale, float* shift,
                                  cudaStream_t st) {
  static bool attributes_set = false;
  const size_t smem = gn_stream_smem(C);
  if (p.resident || p.cs < 1 || p.cs > GN_MAX_CLUSTER || p.nclusters < 1 ||
      p.rows_per_block < 1 || (long long)p.nclusters * p.cs * p.rows_per_block < M ||
      smem > GN_SMEM_LIMIT || count == nullptr)
    return (int)cudaErrorInvalidValue;
  GnStreamArgs a{x, add, gamma, beta, cpart, count, scale, shift, M, C, G, eps,
                 p.rows_per_block};
  return gn_cluster_launch(gn_stream_stats<T>, attributes_set, dim3(p.cs, p.nclusters, B),
                           p.cs, smem, st, a);
}

template <typename T>
static int gn_apply_launch(const T* x, const float* scale, const float* shift, T* out, int B,
                           int M, int C, int act_silu, cudaStream_t stream) {
  const long long n8 = (long long)B * M * C / 8;
  const long long want = (n8 + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  gn_apply<T><<<blocks, 256, 0, stream>>>(x, scale, shift, out, n8, (long long)M * C, C,
                                          act_silu);
  return (int)cudaGetLastError();
}

// act(GN(x + add)) into out by the plan: one launch (resident) or two
// (streaming: the statistics, then the apply pass). ws: streaming mode's
// (B, nclusters, C) float2 cluster partials, then scale and shift (B, C)
// fp32 each (null in resident mode); count: B zeroed arrival counters.
// Returns a CUDA error code (cudaErrorInvalidValue for a plan it does not
// take).
template <typename T>
static int gn_launch(const T* x, const T* add, const T* gamma, const T* beta, T* out,
                     float* ws, unsigned* count, int B, int M, int C, int G, float eps,
                     int act_silu, const GnPlan& p, cudaStream_t st) {
  if (B < 1 || M < 1 || C % 8 || G < 1 || C % G) return (int)cudaErrorInvalidValue;
  if (!p.resident) {
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    float2* cpart = reinterpret_cast<float2*>(ws);
    float* scale = ws + 2 * (size_t)B * p.nclusters * C;
    float* shift = scale + (size_t)B * C;
    const int rc = gn_stream_stats_launch<T>(x, add, gamma, beta, B, M, C, G, eps, p, cpart,
                                             count, scale, shift, st);
    if (rc != 0) return rc;
    return gn_apply_launch<T>(x, scale, shift, out, B, M, C, act_silu, st);
  }
  static bool attributes_set = false;
  const int cpg = C / G;
  if (p.sw < 8 || p.sw > GN_MAX_SLAB || p.sw % 8 || p.sw % cpg || C % p.sw || p.cs < 1 ||
      p.cs > GN_MAX_CLUSTER || p.box_rows < 1 || p.box_rows > GN_BOX_ROWS || p.nboxes < 1 ||
      p.nboxes > GN_MAX_BOXES ||
      (p.box_rows * p.sw * sizeof(T)) % 128 ||
      (long long)p.cs * p.box_rows * p.nboxes < M || gn_resident_smem<T>(p) > GN_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm;
  if (!gn_rows_map<T>(&xm, x, B, M, C, p.sw, p.box_rows)) return (int)cudaErrorInvalidValue;
  GnArgs a{add, gamma, beta, out, M, C, G, eps, act_silu, p.sw, p.box_rows, p.nboxes};
  return gn_cluster_launch(gn_resident<T>, attributes_set, dim3(p.cs, C / p.sw, B), p.cs,
                           gn_resident_smem<T>(p), st, a, xm);
}
