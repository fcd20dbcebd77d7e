// Fused GroupNorm(+add)+SiLU+conv3x3 (SAME, stride 1):
//   out = conv3x3(silu(GN(x + add[b, c]))) + bias,   x NHWC, w (Cout,3,3,Cin).
//
// Replaces imagdressing_tpu/kernels/fused_gn_conv.py:_kernel (whole batch
// row in VMEM, zero-bordered normalized scratch, nine-tap MXU GEMM) and,
// by function, :_windowed_kernel (the same chain streamed in row windows
// with one-row halos for VAE pixel-level shapes). One op covers both: the
// window/halo split was a VMEM-capacity device that a tiled GEMM does not
// need.
//
// Bound on the H100: operations at UNet and VAE widths (2*9*Cin*Cout flops
// per pixel against (Cin+Cout)*2 bytes: hundreds of flops per byte, over
// the ~295 ridge), except at the deepest UNet level, where M = 80-160
// pixels and the 29-59 MB of weights set the bound.
//
// bf16 design (sm_90a), two launches on one stream (three where the plan
// splits K; one more where the GroupNorm streams):
//  1-3. normalize once: h = silu(GN(x + add)), fp32 arithmetic rounded once
//       to bf16 into a scratch of x's shape, by the fused GroupNorm's own
//       launch (gn_stats.cuh:gn_launch with act = silu, as groupnorm.cu runs
//       it): one cluster launch with the rows resident in shared memory, or,
//       at the VAE's pixel levels, the streaming statistics and an apply
//       pass. The rounding points are the plain version's. The TPU kernel
//       kept h out of device memory; here the conv is operations-bound, and
//       h's write and read cost ~2*M*Cin*2 bytes, far less than normalizing
//       each element again for every tap and every N tile (9 * Cout/BN
//       times);
//  4.   the conv as an implicit GEMM: M = pixels, N = Cout, K = 9 * Cin, in
//       K steps of one tap x 64 channels. A block owns a 128-pixel tile (TH
//       rows x TW columns of one image; TW a power of two) and BN output
//       channels, with two warpgroups of 64 pixels each sharing every
//       weight tile. Per K step one thread asks the tensor-memory
//       accelerator for two boxes: the A tile over h as a 4-D map (Cin, W,
//       H, B) with box (64, TW, TH, 1) at (c0, x0 + dx, y0 + dy, b) -- its
//       zero fill for out-of-range coordinates is the SAME border and the
//       channel tail -- and the weight tile as a 3-D map (Cin, 9, Cout) with
//       box (64, 1, BN) at (c0, tap, n0). Both land 128-byte swizzled in a
//       ring of STAGES mbarrier stages, requested STAGES - 1 steps ahead;
//       wgmma m64nBNk16 reads both from shared memory (fp32 accumulators).
//  5.   split-K where M is small: the plan (fused_gn_conv.py:conv_plan)
//       splits the K steps into `splits` balanced ranges (blockIdx.z) so
//       that a launch fills the card; each block writes its fp32 partial
//       tile to a (splits, M, Cout) buffer, and a second pass adds the
//       partials in split order, adds the bias and rounds once. No atomics:
//       two runs give the same bits. Without a split the epilogue adds the
//       bias and rounds once itself. Stores are masked for the ragged tile.
//
// The fp32 variant (parity mode) is a SIMT kernel: a 64x64 output tile per
// block, the A tile normalized and passed through SiLU on its way into
// shared memory, fp32 FMAs. It reads per-(B, Cin) scale/shift, which the
// streaming statistics launch (gn_stats.cuh) writes.
#include "gn_stats.cuh"
#include "sm90.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma implicit GEMM
// ---------------------------------------------------------------------------

constexpr int BM = 128;   // pixels of a block: two warpgroups of 64
constexpr int BKC = 64;   // channels of a K step: one 128-byte swizzled row
constexpr int CONV_THREADS = 256;

// Ring depth per N width, and the dynamic shared memory it takes (the 1024
// bytes of slack align the swizzled tiles); fused_gn_conv.py mirrors both.
__host__ __device__ constexpr int conv_stages(int bn) {
  return bn == 256 ? 4 : bn == 160 ? 5 : 6;
}
__host__ __device__ constexpr int conv_smem(int bn) {
  return conv_stages(bn) * ((BM + bn) * 128 + 8) + 1024;
}

struct ConvArgs {
  const bf16* bias;
  bf16* out;    // (M, Cout) when splits == 1
  float* part;  // (splits, M, Cout) fp32 partials when splits > 1
  int B, H, W, Cout;
  int tw_shift, TH;        // the pixel tile: TH rows x (1 << tw_shift)
  int tiles_x, tiles_y;    // pixel tiles per image row / column
  int csteps, ksteps;      // K steps per tap (ceil(Cin / 64)), in all (9x)
  int splits;
};

struct ConvMaps {
  CUtensorMap a, w;
};

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

template <int BN>
__global__ void __launch_bounds__(CONV_THREADS, 1)
    gn_conv3x3_wgmma(const ConvArgs a, const __grid_constant__ ConvMaps m) {
  constexpr int STAGES = conv_stages(BN);
  constexpr uint32_t A_BYTES = BM * 128, B_BYTES = BN * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* As = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Bs = As + STAGES * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * B_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  int tile = blockIdx.x;
  const int x0 = (tile % a.tiles_x) << a.tw_shift;
  tile /= a.tiles_x;
  const int y0 = (tile % a.tiles_y) * a.TH;
  const int b = tile / a.tiles_y;
  const int n0 = blockIdx.y * BN, split = blockIdx.z;
  const int k0 = (int)((long long)split * a.ksteps / a.splits);
  const int nk = (int)((long long)(split + 1) * a.ksteps / a.splits) - k0;

  // K step k0 + i (tap, 64 channels) into stage i % STAGES; one thread
  auto load = [&](int i) {
    const int st = i % STAGES, k = k0 + i;
    const int tap = k / a.csteps, c = (k % a.csteps) * BKC;
    mbar_expect(&full[st], A_BYTES + B_BYTES);
    tma_load_4d(As + st * A_BYTES, &m.a, c, x0 + tap % 3 - 1, y0 + tap / 3 - 1, b, &full[st]);
    tma_load_3d(Bs + st * B_BYTES, &m.w, c, tap, n0, &full[st]);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < STAGES && i < nk; ++i) load(i);

  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  fence_regs(acc);

  // Step i's products are issued while step i - 1's may still run: they
  // chain on the same accumulators, which nothing else touches until the
  // last wait (a read of them in the loop would make ptxas wait for every
  // group before the next issue).
  for (int i = 0; i < nk; ++i) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const unsigned char* At = As + st * A_BYTES + wg * (64 * 128);
    const unsigned char* Bt = Bs + st * B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKC / 16; ++kk)
      Wgmma<BN>::template ss<0, 0>(acc, desc_sw128(At + 32 * kk), desc_sw128(Bt + 32 * kk), 1);
    wgmma_commit();
    wgmma_wait<1>();  // step i - 1's products are done ...
    __syncthreads();  // ... in both warpgroups: its stage is free
    if (tid == 0 && i >= 1 && i - 1 + STAGES < nk) load(i - 1 + STAGES);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // accumulator element j: row 16 * warp + lane / 4 + 8 * (j % 4 / 2) of
  // the warpgroup's 64, column 8 * (j / 4) + 2 * (lane % 4) + j % 2
  const long long M = (long long)a.B * a.H * a.W;
  const int tw_mask = (1 << a.tw_shift) - 1;
#pragma unroll
  for (int j = 0; j < BN / 2; j += 2) {
    const int r = 64 * wg + 16 * warp + (lane >> 2) + 8 * ((j >> 1) & 1);
    const int col = n0 + 8 * (j >> 2) + 2 * (lane & 3);
    const int y = y0 + (r >> a.tw_shift), x = x0 + (r & tw_mask);
    if (y >= a.H || x >= a.W || col >= a.Cout) continue;
    const long long p = ((long long)b * a.H + y) * a.W + x;
    if (a.splits > 1) {
      *reinterpret_cast<float2*>(a.part + ((long long)split * M + p) * a.Cout + col) =
          make_float2(acc[j], acc[j + 1]);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(a.out + p * a.Cout + col) = __floats2bfloat162_rn(
          acc[j] + to_f32(a.bias[col]), acc[j + 1] + to_f32(a.bias[col + 1]));
    }
  }
}

// out = bf16(sum over splits, in split order, of part + bias); 4 channels
// per thread (Cout % 8 == 0, so the 4 lie in one pixel row)
__global__ void __launch_bounds__(256)
    gn_conv3x3_splitk_reduce(const float* __restrict__ part, const bf16* __restrict__ bias,
                             bf16* __restrict__ out, long long MC, int Cout, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < MC / 4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 4;
    float4 s = *reinterpret_cast<const float4*>(part + e);
    for (int k = 1; k < splits; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(part + k * MC + e);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int c = (int)(e % Cout);
    __nv_bfloat162 lo = __floats2bfloat162_rn(s.x + to_f32(bias[c]), s.y + to_f32(bias[c + 1]));
    __nv_bfloat162 hi =
        __floats2bfloat162_rn(s.z + to_f32(bias[c + 2]), s.w + to_f32(bias[c + 3]));
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&lo);
    raw.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + e) = raw;
  }
}

// The two tensor maps, built anew for every launch (the caching allocator
// hands the same address to other tensors). Strides in bytes.
bool make_conv_maps(ConvMaps* m, const void* h, const void* w, int B, int H, int W, int Cin,
                    int Cout, int TW, int TH, int BN) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const cuuint64_t adims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t astrides[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                                  (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t abox[4] = {BKC, (cuuint32_t)TW, (cuuint32_t)TH, 1};
  if (fn(&m->a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(h), adims, astrides,
         abox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  const cuuint64_t wdims[3] = {(cuuint64_t)Cin, 9, (cuuint64_t)Cout};
  const cuuint64_t wstrides[2] = {(cuuint64_t)Cin * 2, (cuuint64_t)9 * Cin * 2};
  const cuuint32_t wbox[3] = {BKC, 1, (cuuint32_t)BN};
  return fn(&m->w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), wdims, wstrides,
            wbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch_conv(const ConvArgs& a, const ConvMaps& m, cudaStream_t st) {
  constexpr int smem = conv_smem(BN);
  static bool attribute_set = false;  // once, before any CUDA-graph capture
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(gn_conv3x3_wgmma<BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const dim3 grid(a.B * a.tiles_y * a.tiles_x, (a.Cout + BN - 1) / BN, a.splits);
  gn_conv3x3_wgmma<BN><<<grid, CONV_THREADS, smem, st>>>(a, m);
  return (int)cudaGetLastError();
}

int conv_bf16(const void* h, const void* w, const void* bias, void* out, float* part, int B,
              int H, int W, int Cin, int Cout, int tw, int bn, int splits, cudaStream_t st) {
  int tw_shift = 0;
  while ((1 << tw_shift) < tw) ++tw_shift;
  const int csteps = (Cin + BKC - 1) / BKC;
  if ((1 << tw_shift) != tw || tw > BM || splits < 1 || splits > 9 * csteps ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.bias = static_cast<const bf16*>(bias);
  a.out = static_cast<bf16*>(out);
  a.part = part;
  a.B = B; a.H = H; a.W = W; a.Cout = Cout;
  a.tw_shift = tw_shift;
  a.TH = BM / tw;
  a.tiles_x = (W + tw - 1) / tw;
  a.tiles_y = (H + a.TH - 1) / a.TH;
  a.csteps = csteps;
  a.ksteps = 9 * csteps;
  a.splits = splits;
  ConvMaps m;
  if (!make_conv_maps(&m, h, w, B, H, W, Cin, Cout, tw, a.TH, bn))
    return (int)cudaErrorInvalidValue;
  int rc;
  switch (bn) {
    case 64: rc = launch_conv<64>(a, m, st); break;
    case 128: rc = launch_conv<128>(a, m, st); break;
    case 160: rc = launch_conv<160>(a, m, st); break;
    case 256: rc = launch_conv<256>(a, m, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0 || splits == 1) return rc;
  const long long MC = (long long)B * H * W * Cout;
  const long long want = (MC / 4 + 255) / 256;
  gn_conv3x3_splitk_reduce<<<(int)(want < 132 * 16 ? want : 132 * 16), 256, 0, st>>>(
      part, static_cast<const bf16*>(bias), static_cast<bf16*>(out), MC, Cout, splits);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 (parity mode): SIMT implicit GEMM
// ---------------------------------------------------------------------------

constexpr int FBM = 64, FBN = 64, FBK = 32, FNT = 128;
constexpr int FSA = FBK + 8;  // padded smem row (elements)

__global__ void __launch_bounds__(FNT)
    gn_conv3x3_f32(const float* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ shift, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int B, int H, int W,
                   int Cin, int Cout) {
  __shared__ __align__(16) float As[FBM * FSA];
  __shared__ __align__(16) float Bs[FBN * FSA];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  const long long HW = (long long)H * W;
  const long long Mtot = (long long)B * HW;
  const long long m0 = (long long)blockIdx.x * FBM;
  const int n0 = blockIdx.y * FBN;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // Each thread stages 2 chunks of 8 channels of A and of B per K step:
  // chunk q = tid + i*FNT -> tile row q/4, channels (q%4)*8 .. +8.
  int pb[2], py[2], px[2];
  bool pok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = tid + i * FNT;
    const long long p = m0 + (q >> 2);
    pok[i] = p < Mtot;
    const long long pp = pok[i] ? p : 0;
    pb[i] = (int)(pp / HW);
    const long long rem = pp % HW;
    py[i] = (int)(rem / W);
    px[i] = (int)(rem % W);
  }

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < Cin; c0 += FBK) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tid + i * FNT;
        const int r = q >> 2, part = (q & 3) * 8;
        const int cc = c0 + part;
        float v[8];
        const int sy = py[i] + dy, sx = px[i] + dx;
        if (pok[i] && cc < Cin && sy >= 0 && sy < H && sx >= 0 && sx < W) {
          load8(x + (((long long)pb[i] * H + sy) * W + sx) * Cin + cc, v);
          const float* scp = scale + (size_t)pb[i] * Cin + cc;
          const float* shp = shift + (size_t)pb[i] * Cin + cc;
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = silu_f32(v[j] * scp[j] + shp[j]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = 0.f;
        }
        store8(&As[r * FSA + part], v);

        const int co = n0 + r;
        if (co < Cout && cc < Cin) {
          load8(w + ((long long)co * 9 + tap) * Cin + cc, v);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = 0.f;
        }
        store8(&Bs[r * FSA + part], v);
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < FBK; ++k) {
        float av[2][2], bv[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          av[mi][0] = As[(wm + mi * 16 + g) * FSA + k];
          av[mi][1] = As[(wm + mi * 16 + g + 8) * FSA + k];
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          bv[ni][0] = Bs[(wn + ni * 8 + t * 2) * FSA + k];
          bv[ni][1] = Bs[(wn + ni * 8 + t * 2 + 1) * FSA + k];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            acc[mi][ni][0] += av[mi][0] * bv[ni][0];
            acc[mi][ni][1] += av[mi][0] * bv[ni][1];
            acc[mi][ni][2] += av[mi][1] * bv[ni][0];
            acc[mi][ni][3] += av[mi][1] * bv[ni][1];
          }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long p = m0 + wm + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int co = n0 + wn + ni * 8 + t * 2 + (e & 1);
        if (p < Mtot && co < Cout) out[p * Cout + co] = acc[mi][ni][e] + bias[co];
      }
}

}  // namespace

// x, add (or null), gamma, beta, w (Cout,3,3,Cin), bias, out; ws: the
// GroupNorm's streaming workspace (gn_stats.cuh:gn_launch; null when the
// plan is resident); count: B zeroed arrival counters; the GroupNorm plan's
// fields (fused_groupnorm.py:GnPlan). bf16 also: hbuf, bf16 of x's shape (the
// normalized activation); kpart, the (splits, M, Cout) fp32 partials (null
// when splits == 1); the conv plan's pixel tile width tw (a power of two <=
// 128), N width bn (64, 128, 160, 256) and K splits. fp32: a streaming plan
// (cs, nclusters, rows_per_block); ws then ends with scale and shift. Each
// returns a CUDA error code (cudaErrorInvalidValue for a plan it does not
// take).
extern "C" int gn_silu_conv3x3_bf16(const void* x, const void* add, const void* gamma,
                                    const void* beta, const void* w, const void* bias, void* out,
                                    float* ws, unsigned* count, void* hbuf, float* kpart, int B,
                                    int H, int W, int Cin, int Cout, int G, float eps,
                                    int resident, int cs, int sw, int box_rows, int nboxes,
                                    int nclusters, int rows_per_block, int tw, int bn,
                                    int splits, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const GnPlan p{resident, cs, sw, box_rows, nboxes, nclusters, rows_per_block};
  const int rc = gn_launch<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(add),
                                 static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
                                 static_cast<bf16*>(hbuf), ws, count, B, H * W, Cin, G, eps, 1,
                                 p, st);
  if (rc != 0) return rc;
  return conv_bf16(hbuf, w, bias, out, kpart, B, H, W, Cin, Cout, tw, bn, splits, st);
}

extern "C" int gn_silu_conv3x3_f32(const void* x, const void* add, const void* gamma,
                                   const void* beta, const void* w, const void* bias, void* out,
                                   float* ws, unsigned* count, int B, int H, int W, int Cin,
                                   int Cout, int G, float eps, int cs, int nclusters,
                                   int rows_per_block, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const GnPlan p{0, cs, 0, 0, 0, nclusters, rows_per_block};
  float* scale = ws + 2 * (size_t)B * nclusters * Cin;
  float* shift = scale + (size_t)B * Cin;
  const int rc = gn_stream_stats_launch<float>(
      xf, static_cast<const float*>(add), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), B, H * W, Cin, G, eps, p, reinterpret_cast<float2*>(ws),
      count, scale, shift, st);
  if (rc != 0) return rc;
  const long long Mtot = (long long)B * H * W;
  dim3 grid((unsigned)((Mtot + FBM - 1) / FBM), (unsigned)((Cout + FBN - 1) / FBN));
  gn_conv3x3_f32<<<grid, FNT, 0, st>>>(xf, scale, shift, static_cast<const float*>(w),
                                       static_cast<const float*>(bias),
                                       static_cast<float*>(out), B, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}
