// Fused GroupNorm(+add)+activation: act(GN(x + add[b, c])), act in {none, silu},
// x channel-last (B, M, C), bf16 or fp32. Its kernels live in gn_stats.cuh,
// which the fused GroupNorm+SiLU+conv3x3 (gn_conv.cu) also runs as its
// prologue.
//
// Replaces imagdressing_tpu/kernels/fused_groupnorm.py:_gn_kernel, the
// Pallas kernel that holds one batch row in VMEM, sums fp32 channel moments
// over it, folds `add` into them and normalizes the same VMEM copy: x is
// read from HBM once.
//
// Bound on the H100: bytes. The function reads x once and writes y once (4
// bytes per element in bf16) and does a few flops per element, far under the
// ~295 flop/byte ridge. At (2, 5120, 320) bf16 that is 13.1 MB, 3.9 us at
// 3.35 TB/s; a statistics pass, a finalize and an apply pass re-reading x
// took ~20 us there as three launches.
//
// Resident mode, one launch: the H100 keeps the TPU's residency across a
// thread-block cluster instead of one core's VMEM. fused_groupnorm.py:gn_plan
// cuts the channels into slabs of whole groups (a multiple of lcm(C/G, 8)
// channels, so a row segment is a multiple of 16 bytes for TMA) and gives
// each (batch row, slab) one cluster of cs blocks (up to 8, the portable
// limit), sized so that the slab's rows fit the cluster's shared memory
// (227 KB a block); among the plans that fit, a cost model fitted to
// measured plans picks one (a cluster of one where the slab fits a block:
// the barriers and the exchange cost ~1.2 us).
// Each block:
//   1. loads its rows of the slab by TMA (a 3-D map (C, M, B), boxes of up to
//      256 rows x sw channels, rows past M zero-filled), each box completing
//      on its own mbarrier;
//   2. sums per-channel fp32 (s1, s2) over its rows in a fixed order, each
//      box as soon as it lands (row lanes, then a halving tree);
//   3. meets the cluster at its barrier and adds every rank's partials read
//      through distributed shared memory in rank order, so each block gets
//      the same bits; folds `add`, forms the groups' mean and rstd (a warp per
//      group), then each channel's scale and shift;
//   4. normalizes its resident rows (fp32, one rounding) straight from
//      shared memory into y, 16 bytes a thread;
//   5. waits at the cluster barrier again, so that its partials stay alive
//      while its peers read them.
// x crosses HBM once and y once; no partial, scale or shift touches device
// memory.
//
// Streaming mode, two launches, where a (batch row, slab) fits no cluster:
// the VAE's pixel levels, e.g. (1, 327680, 256) bf16 (5.2 MB per 8-channel
// slab against 8 x 227 KB). gn_stream_stats sums ranges of whole rows;
// each cluster's partials meet through distributed shared memory and the
// last cluster of the batch row to arrive (an integer counter) adds the
// clusters' partials in index order and writes scale/shift; gn_apply then
// reads x again.
//
// No float atomics: two runs give the same bits. The fp32 variant runs the
// same kernels (4-byte elements, the same 8-channel vectors).
#include "gn_stats.cuh"

#define GN_ARGS                                                                     \
  const void *x, const void *add, const void *gamma, const void *beta, void *out,   \
      float *ws, unsigned *count, int B, int M, int C, int G, float eps, int act_silu, \
      int resident, int cs, int sw, int box_rows, int nboxes, int nclusters,        \
      int rows_per_block, void *stream
#define GN_RUN(T)                                                                          \
  gn_launch<T>(static_cast<const T*>(x), static_cast<const T*>(add),                       \
               static_cast<const T*>(gamma), static_cast<const T*>(beta),                  \
               static_cast<T*>(out), ws, count, B, M, C, G, eps, act_silu,                 \
               GnPlan{resident, cs, sw, box_rows, nboxes, nclusters, rows_per_block},      \
               reinterpret_cast<cudaStream_t>(stream))

// x, add (or null), gamma, beta, out; ws: streaming mode's workspace (null
// when resident); count: B zeroed arrival counters; the plan's fields. Each
// returns a CUDA error code.
extern "C" int group_norm_act_bf16(GN_ARGS) { return GN_RUN(bf16); }
extern "C" int group_norm_act_f32(GN_ARGS) { return GN_RUN(float); }

template <typename T>
static int max_clusters(int cs, int smem) {
  cudaFuncSetAttribute(gn_resident<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, GN_SMEM_LIMIT);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1, 1);
  cfg.blockDim = dim3(GN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, gn_resident<T>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// How many clusters of `cs` resident blocks with `smem` bytes of dynamic
// shared memory each the card holds at once (cudaOccupancyMaxActiveClusters),
// bf16 (bf != 0) or fp32; minus the CUDA error code on error. For the tools.
extern "C" int gn_resident_max_clusters(int bf, int cs, int smem) {
  return bf ? max_clusters<bf16>(cs, smem) : max_clusters<float>(cs, smem);
}
