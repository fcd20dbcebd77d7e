// Fused GroupNorm(+add)+activation: act(GN(x + add[b, c])), act in {none, silu}.
//
// Replaces imagdressing_tpu/kernels/fused_groupnorm.py:_gn_kernel (the
// Pallas kernel that holds one batch row in VMEM, sums fp32 channel
// moments, folds `add` into them and writes normalize+affine+act).
//
// Bound on the H100: bytes. The function reads x once and writes y once
// (4 bytes per element in bf16) and does a few flops per element, far under
// the ~295 flop/byte ridge. A TPU-style whole-row residency does not fit a
// block's 227 KB of shared memory at the UNet's top level (5120 x 320 bf16 =
// 3.3 MB), so the statistics are a separate grid-wide pass: x is read twice
// (stats, then apply) and the normalized tensor is written once. The stats
// pass writes only (B, chunks, C) fp32 partials, and the second read of x
// mostly hits the 50 MB L2 at UNet sizes. Both passes stream contiguous
// channel-last rows; the apply pass moves 8 channels (16 bytes of bf16) per
// thread.
#include "gn_stats.cuh"  // the statistics passes and gn_apply

template <typename T>
static int run(const void* x, const void* add, const void* gamma,
               const void* beta, void* out, void* partial, float* scale,
               float* shift, int B, int M, int C, int G, float eps,
               int act_silu, int nchunks, int rows_per_chunk, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  gn_stats_launch<T>(static_cast<const T*>(x), static_cast<const T*>(add),
                     static_cast<const T*>(gamma), static_cast<const T*>(beta),
                     B, M, C, G, eps, nchunks, rows_per_chunk,
                     static_cast<float2*>(partial), scale, shift, st);
  gn_apply_launch<T>(static_cast<const T*>(x), scale, shift, static_cast<T*>(out), B, M, C,
                     act_silu, st);
  return (int)cudaGetLastError();
}

#define GN_ARGS                                                            \
  const void *x, const void *add, const void *gamma, const void *beta,     \
      void *out, void *partial, float *scale, float *shift, int B, int M,  \
      int C, int G, float eps, int act_silu, int nchunks,                  \
      int rows_per_chunk, void *stream
#define GN_PASS                                                          \
  x, add, gamma, beta, out, partial, scale, shift, B, M, C, G, eps,      \
      act_silu, nchunks, rows_per_chunk, stream

extern "C" int group_norm_act_bf16(GN_ARGS) { return run<bf16>(GN_PASS); }
extern "C" int group_norm_act_f32(GN_ARGS) { return run<float>(GN_PASS); }
