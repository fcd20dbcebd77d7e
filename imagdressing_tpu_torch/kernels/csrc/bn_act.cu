// Folded batch norm + activation (InPlaceABN inference):
//   y = act(x * scale + shift),  scale = w / sqrt(var + eps),
//   shift = b - mean * w / sqrt(var + eps),  act in {none, leaky_relu, elu}.
//
// Replaces imagdressing_tpu/kernels/fused_bn_act.py:_fused_kernel (the
// Pallas kernel that streams (block_m, C) tiles of the (M, C) view through
// VMEM with the folded per-channel scale/shift resident).
//
// Bound on the H100: bytes. One read of x and one write of y (8 bytes per
// element in fp32) against 2-3 flops per element, far below the ~20
// flop/byte fp32 ridge. Most SCHP launches move 0.1-8 MB, which the card
// streams in a few microseconds, so launch count matters as much as the
// pass: the fold of the running statistics happens here, in each thread's
// prologue, instead of in separate elementwise launches before the pass.
//
// Design: a thread owns one group of 8 channels (a 16-byte bf16 vector, two
// 16-byte fp32 vectors) for the whole launch, so it folds and rounds its
// 8 scales and shifts to the storage type once (the JAX package rounds them
// to x's dtype), then walks a grid-stride loop over rows. The block is
// (C/8 threads, rows) when C/8 <= 256, so a warp covers contiguous memory
// and any C that is a multiple of 8 (48 ... 2048) and any M (1 ... 65536)
// runs without padding. Multiply and add are rounded separately
// (__fmul_rn / __fadd_rn, no FMA contraction), as the plain version rounds
// them.
#include "common.cuh"

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

template <typename T>
__global__ void __launch_bounds__(256)
bn_act_kernel(const T* __restrict__ x, const float* __restrict__ weight,
              const float* __restrict__ bias, const float* __restrict__ mean,
              const float* __restrict__ var, T* __restrict__ out, long long M,
              int C, float eps, int act, float slope) {
  const int c8 = C / 8;
  for (int cv = threadIdx.x; cv < c8; cv += blockDim.x) {
    const int c = cv * 8;
    float sc[8], sh[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float inv =
          __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var[c + j], eps)));
      const float w = weight[c + j];
      sc[j] = round_to<T>(__fmul_rn(w, inv));
      sh[j] = round_to<T>(
          __fsub_rn(bias[c + j], __fmul_rn(__fmul_rn(mean[c + j], w), inv)));
    }
    for (long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y; r < M;
         r += (long long)gridDim.x * blockDim.y) {
      const long long e = r * C + c;
      float v[8];
      load8(x + e, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float y = __fadd_rn(__fmul_rn(v[j], sc[j]), sh[j]);
        if (act == 1) {
          v[j] = y >= 0.0f ? y : __fmul_rn(slope, y);
        } else if (act == 2) {
          v[j] = y >= 0.0f ? y : expm1f(y);
        } else {
          v[j] = y;
        }
      }
      store8(out + e, v);
    }
  }
}

template <typename T>
static int run(const void* x, const float* weight, const float* bias,
               const float* mean, const float* var, void* out, long long M,
               int C, float eps, int act, float slope, void* stream) {
  const int c8 = C / 8;
  const int bx = c8 < 256 ? c8 : 256;
  const int by = 256 / bx;
  const long long want = (M + by - 1) / by;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  bn_act_kernel<T><<<blocks, dim3(bx, by), 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), weight, bias, mean, var, static_cast<T*>(out),
      M, C, eps, act, slope);
  return (int)cudaGetLastError();
}

#define BN_ARGS                                                           \
  const void *x, const float *weight, const float *bias, const float *mean, \
      const float *var, void *out, long long M, int C, float eps, int act,  \
      float slope, void *stream
#define BN_PASS x, weight, bias, mean, var, out, M, C, eps, act, slope, stream

extern "C" int bn_act_bf16(BN_ARGS) { return run<bf16>(BN_PASS); }
extern "C" int bn_act_f32(BN_ARGS) { return run<float>(BN_PASS); }
