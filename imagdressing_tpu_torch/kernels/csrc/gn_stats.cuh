// GroupNorm statistics and the normalize pass shared by the fused GroupNorm
// (groupnorm.cu) and the fused GroupNorm+SiLU+conv3x3 (gn_conv.cu):
// per-(B, C) fp32 scale/shift such that GN(x + add) == x * scale + shift,
// then y = act(x * scale + shift).
//
// Pass 1 (gn_partial_sums): each block sums one chunk of rows of one batch
// row into per-channel fp32 (s1, s2) partials, 8 channels (one 16-byte
// load of bf16) per thread, the chunk's rows split over row lanes of
// threads and the lanes added in a fixed order. Pass 2 (gn_finalize): one
// block per (group, batch row). A warp per channel adds that channel's
// partials (lanes over chunks, then a fixed xor tree; no atomics, so every
// run gives the same bits), folds the per-(B, C) bias `add` into the
// moments algebraically (s2 += 2*t*s1 + M*t^2, s1 += M*t, as
// imagdressing_tpu/kernels/fused_gn_conv.py:93-97 does); warp 0 then
// aggregates the group with E[x^2] - E[x]^2, and the block writes
// scale = gamma * rsqrt(var + eps), shift = beta - mean * scale + add * scale.
#pragma once

#include "common.cuh"

constexpr int GN_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(GN_THREADS)
gn_partial_sums(const T* __restrict__ x, int M, int C, int rows_per_chunk,
                float2* __restrict__ partial) {
  __shared__ float red[GN_THREADS * 16];  // the row lanes' (s1, s2) x 8
  const int chunk = blockIdx.x, nchunks = gridDim.x, b = blockIdx.y;
  const int m0 = chunk * rows_per_chunk;
  const int m1 = min(M, m0 + rows_per_chunk);
  const T* xb = x + (size_t)b * M * C;
  float2* out = partial + ((size_t)b * nchunks + chunk) * C;
  const int ngrp = C / 8;  // 8-channel groups, one 16-byte load of bf16
  if (ngrp > GN_THREADS) {  // wide rows: a thread per group, every row
    for (int cg = threadIdx.x; cg < ngrp; cg += GN_THREADS) {
      float s1[8] = {}, s2[8] = {};
      for (int m = m0; m < m1; ++m) {
        float v[8];
        load8(xb + (size_t)m * C + cg * 8, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s1[j] += v[j];
          s2[j] += v[j] * v[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) out[cg * 8 + j] = make_float2(s1[j], s2[j]);
    }
    return;
  }
  // thread t: group t % ngrp, row lane t / ngrp taking every lanes-th row;
  // then lane 0 adds the other lanes in lane order (fixed, so every run
  // gives the same bits)
  const int lanes = GN_THREADS / ngrp;
  const int cg = threadIdx.x % ngrp, rl = threadIdx.x / ngrp;
  float s1[8] = {}, s2[8] = {};
  if (rl < lanes) {
#pragma unroll 4
    for (int m = m0 + rl; m < m1; m += lanes) {
      float v[8];
      load8(xb + (size_t)m * C + cg * 8, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s1[j] += v[j];
        s2[j] += v[j] * v[j];
      }
    }
    if (rl > 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        red[threadIdx.x * 16 + j] = s1[j];
        red[threadIdx.x * 16 + 8 + j] = s2[j];
      }
    }
  }
  __syncthreads();
  if (rl == 0) {
    for (int l = 1; l < lanes; ++l) {
      const float* r = red + (l * ngrp + cg) * 16;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s1[j] += r[j];
        s2[j] += r[8 + j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) out[cg * 8 + j] = make_float2(s1[j], s2[j]);
  }
}

__device__ __forceinline__ float warp_sum_xor(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(GN_THREADS)
gn_finalize(const float2* __restrict__ partial, int nchunks,
            const T* __restrict__ add, const T* __restrict__ gamma,
            const T* __restrict__ beta, int M, int C, int G, float eps,
            float* __restrict__ scale, float* __restrict__ shift) {
  extern __shared__ float sm[];  // s1[cpg], s2[cpg]
  __shared__ float stat[2];      // the group's mean, rsqrt(var + eps)
  const int g = blockIdx.x, b = blockIdx.y, cpg = C / G, c0 = g * cpg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float fm = (float)M;
  for (int i = warp; i < cpg; i += GN_THREADS / 32) {
    const int c = c0 + i;
    float s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < nchunks; k += 32) {
      const float2 p = partial[((size_t)b * nchunks + k) * C + c];
      s1 += p.x;
      s2 += p.y;
    }
    s1 = warp_sum_xor(s1);
    s2 = warp_sum_xor(s2);
    if (lane == 0) {
      if (add != nullptr) {
        const float t = to_f32(add[(size_t)b * C + c]);
        s2 += 2.f * t * s1 + fm * t * t;
        s1 += fm * t;
      }
      sm[i] = s1;
      sm[cpg + i] = s2;
    }
  }
  __syncthreads();
  if (warp == 0) {
    float a = 0.f, q = 0.f;
    for (int i = lane; i < cpg; i += 32) {
      a += sm[i];
      q += sm[cpg + i];
    }
    a = warp_sum_xor(a);
    q = warp_sum_xor(q);
    if (lane == 0) {
      const float n = fm * (float)cpg;
      const float mean = a / n;
      stat[0] = mean;
      stat[1] = rsqrtf(q / n - mean * mean + eps);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cpg; i += GN_THREADS) {
    const int c = c0 + i;
    const float sc = stat[1] * to_f32(gamma[c]);
    float sh = to_f32(beta[c]) - stat[0] * sc;
    if (add != nullptr) sh += to_f32(add[(size_t)b * C + c]) * sc;
    scale[(size_t)b * C + c] = sc;
    shift[(size_t)b * C + c] = sh;
  }
}

// Launch both passes on `stream`. `partial` holds B * nchunks * C float2.
template <typename T>
static void gn_stats_launch(const T* x, const T* add, const T* gamma,
                            const T* beta, int B, int M, int C, int G,
                            float eps, int nchunks, int rows_per_chunk,
                            float2* partial, float* scale, float* shift,
                            cudaStream_t stream) {
  gn_partial_sums<T><<<dim3(nchunks, B), GN_THREADS, 0, stream>>>(
      x, M, C, rows_per_chunk, partial);
  const size_t smem = 2 * (size_t)(C / G) * sizeof(float);
  gn_finalize<T><<<dim3(G, B), GN_THREADS, smem, stream>>>(
      partial, nchunks, add, gamma, beta, M, C, G, eps, scale, shift);
}

// y = act(x * scale + shift) in fp32, rounded once to T; 8 channels (16
// bytes of bf16) per thread. Bound by bytes: one read of x, one write of y.
template <typename T>
__global__ void __launch_bounds__(256)
gn_apply(const T* __restrict__ x, const float* __restrict__ scale,
         const float* __restrict__ shift, T* __restrict__ out, long long n8,
         long long MC, int C, int act_silu) {
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
      v[j] = act_silu ? silu_f32(y) : y;
    }
    store8(out + e, v);
  }
}

template <typename T>
static void gn_apply_launch(const T* x, const float* scale, const float* shift, T* out,
                            int B, int M, int C, int act_silu, cudaStream_t stream) {
  const long long n8 = (long long)B * M * C / 8;
  const long long want = (n8 + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  gn_apply<T><<<blocks, 256, 0, stream>>>(x, scale, shift, out, n8, (long long)M * C, C,
                                          act_silu);
}
