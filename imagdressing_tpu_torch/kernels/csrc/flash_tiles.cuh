// The tile layout, loads and fragment helpers that the wgmma flash kernels
// (flash_fwd.cu, flash_bwd.cu) share: (B, S, H, D) bf16 operands read by
// their strides through 5-D tensor maps into shared tiles in wgmma's
// no-swizzle core-matrix layout, one tile read K-major or MN-major.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

// A tile of R rows x C columns (bf16, C a multiple of 8) in the no-swizzle
// core-matrix layout: element (r, c) at ((c / 8) * R + r) * 8 + c % 8.
template <int R>
__device__ __forceinline__ int tile_at(int r, int chunk) {
  return (chunk * R + r) * 8;
}
// The k16 step `kk` of a tile read K-major (the columns are the contraction):
// 8-row groups 128 bytes apart (SBO), the two column chunks R * 16 apart (LBO).
template <int R>
__device__ __forceinline__ uint64_t desc_kmajor(const bf16* tile, int kk) {
  return make_desc(tile + tile_at<R>(0, 2 * kk), R * 16, 128);
}
// The k16 step `kk` of a tile read MN-major (the rows are the contraction,
// the columns the N width): column chunks R * 16 bytes apart (SBO), the two
// 8-row groups of the step 128 apart (LBO).
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(const bf16* tile, int kk) {
  return make_desc(tile + tile_at<R>(16 * kk, 0), 128, R * 16);
}

// One tile (the map's box: rows s .. s + R - 1 of head h, batch b, the
// box's column chunks from chunk `chunk` on) into shared memory in the tile
// layout above; past-the-end rows and columns arrive as zeros.
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, int h, int s, int b,
                                         uint64_t* bar, int chunk = 0) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(s), "r"(h), "r"(chunk), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// 2^x on the special-function unit (one MUFU.EX2; denormal results flush
// to zero, far below a bf16 probability's resolution)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator element j of m64nN: its column (the row within the warp's 16
// is lane / 4 + 8 * (j % 4 / 2))
__device__ __forceinline__ int acc_col(int j, int lane) {
  return 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
}
// The k16 step kk of a 64 x N accumulator as a wgmma A fragment, in bf16
__device__ __forceinline__ void a_frag(uint32_t f[4], const float* s, int kk) {
  f[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  f[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  f[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  f[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// A map over a (B, S, H, D) bf16 tensor of length S, by its element strides
// `st` (batch, seq, head), whose box is one tile: `rows` rows x `chunks`
// column chunks, laid out chunk by chunk (the map's dimensions, innermost
// first: 8 columns of a chunk, the row, the head, the chunk, the batch).
// Built anew for every launch: the caching allocator hands the same address
// to other tensors.
static bool make_bshd_map(CUtensorMap* map, const void* base, const long long st[3], int B,
                          int S, int H, int D, int rows, int chunks) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[5] = {8, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)(D / 8),
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2, 16,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[5] = {8, (cuuint32_t)rows, 1, (cuuint32_t)chunks, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
