// Flash-attention backward over one or two KV sources, for the training
// forward out = O1 + s_b * O2 (O1 = SDPA(q, k, v), O2 = SDPA(q, k_ref, v_ref)).
//
// Replaces imagdressing_tpu/kernels/flash_attention.py:_bwd_dkv_kernel (K6a)
// and :_bwd_dq_kernel (K6b). What they compute, per source with its saved
// base-2 log-sum-exp (flash_fwd.cu, residual mode):
//   p    = exp2(q.k * log2(e)/sqrt(D) - lse)       (recomputed, never stored)
//   g_e  = coeff * g, rounded to the input dtype   (coeff 1 for source 1, s_b
//                                                   for the reference source)
//   D_i  = rowsum(g * (O - s_b*O2)) for source 1, s_b * rowsum(g * O2) for
//          the reference source, rowsum(g * O) with one source (_bwd_di: from
//          the stored outputs, never from an exact O1, so that the bf16
//          rounding matches the JAX kernels)
//   dV  += p^T g_e         dP = g_e v^T          dS = p * (dP - D_i)
//   dK  += dS^T q / sqrt(D)                      dQ += dS k / sqrt(D)
// p and dS are rounded to the input dtype before their products, as the TPU
// kernels feed the MXU.
//
// Bound on the H100: at D = 40..160 the four (dK/dV) and three (dQ) tensor-
// core products per (q, k) pair and the exp2 per pair (16 per clock per SM)
// are far above the bytes of q, k, v, g, O, O2 and the gradients, so both
// kernels are bound by operations: tensor cores and the exp2 unit.
//
// Design (bf16, sm_90a). K6b runs first and K6a second, on one stream.
//  * D_i once per row: K6b forms D_i of its rows for every source from g, O
//    and O2 and writes it to an fp32 (B, H, nsrc, Sq) buffer beside the lse;
//    K6a reads it as it reads the lse.
//  * Products on wgmma m64nNk16, one warpgroup per 64 rows, two warpgroups
//    per block sharing every streamed tile (half the L2 traffic of one).
//    K6a: a block owns one 128-key tile of one source (the grid runs over
//    the tiles of both sources) and walks every BQ-row q tile, keeping dK
//    and dV in registers. S^T = K Q^T and dP^T = V G_e^T read both operands
//    from shared memory; P^T and dS^T stay in registers as the A operand of
//    dV += P^T G_e and dK += dS^T Q, whose B operand is the same row-major
//    Q / G_e tile read MN-major (wgmma's transpose bit): no transposed copy.
//    K6b: a block owns one 128-row q tile and walks the 64-key tiles of both
//    sources; S = Q K^T, dP = G_e V^T from shared memory, dQ += dS K with dS
//    in registers and K read MN-major.
//  * Tiles live in shared memory in wgmma's no-swizzle layout: 8-row x
//    16-byte core matrices, column chunk major (a chunk of 8 columns is R
//    rows of 16 bytes), so one tile serves as a K-major operand (D the
//    contraction) and as an MN-major one (D the N width) with only the
//    descriptor's strides changed. D is padded to the 16-deep step in shared
//    memory only (40 -> 48); N = D for the D-wide products.
//  * Tensor-memory-accelerator loads into a ring of four stages (three at
//    D > 128), each with an mbarrier, requested two steps ahead: one thread
//    asks for a whole tile with one instruction, through a 5-D tensor map
//    over the (B, S, H, D) strides whose box is the tile in its shared
//    layout (8 columns, R rows, every chunk); the unit zero-fills the rows
//    past the sequence's end and the padding columns past D. K6a's lse / D_i
//    rows come by cp.async.
//  * Software pipeline: the products S, dP of tile t+1 are issued before the
//    D-wide products of tile t, so the exp2 and dS of tile t+1 run on the
//    CUDA cores while the tensor cores finish tile t. One exp2 per (q, k)
//    pair per kernel.
//  * g_e = coeff * g: the tile arrives as g; where coeff != 1 the block
//    rounds coeff * g to bf16 in place, so the operand is bit-equal to the
//    plain version's g_e.
//  * No atomics: every output element is written once by one block, in a
//    fixed order, so the result is the same every run, as the TPU's
//    sequential grid axes gave.
//  * A reference tile of a scale-0 row contributes exactly zero: K6a writes
//    zeros to its dK_ref/dV_ref rows and returns (the outputs are allocated
//    uninitialised); K6b skips the reference source of such a row.
//  * At D > 80, K6a takes 32 q rows per step to keep its two D-wide
//    accumulators in registers.
//
// The fp32 variants (parity mode) are SIMT kernels: a warp per key row (K6a)
// or per query row (K6b), D spread over the lanes.
#include "common.cuh"
#include "flash_tiles.cuh"
#include "sm90.cuh"
#include "wgmma.cuh"

namespace {

constexpr int NTH = 128;  // threads of a warpgroup, and of the fp32 kernels
constexpr int BKV = 64;   // keys per K6b step
// Warpgroups per block: K6b loads each key tile once for WGS x 64 q rows,
// K6a each q tile once for WGS x 64 keys.
constexpr int WGS = 2;
// Depth of the tile ring: tiles are requested two steps ahead; three stages
// at D > 128, where four of K6b's would not fit in shared memory.
__host__ __device__ constexpr int ring_stages(int dn) { return dn > 128 ? 3 : 4; }

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* kr;
  const void* vr;
  const void* g;   // upstream gradient of out, (B, Sq, H, D)
  const void* o;   // forward output
  const void* o2;  // reference-source output, or null with one source
  const float* lse;        // (B, H, nsrc, Sq) fp32, base 2
  const float* ref_scale;  // (B,) fp32, or null with one source
  float* delta;            // (B, H, nsrc, Sq) fp32 D_i: K6b writes, K6a reads
  void* dq;
  void* dk;
  void* dv;
  void* dkr;
  void* dvr;
  int B, H, Sq, Skv, Skv_ref, D, nsrc;
  // element strides (batch, seq, head) of
  // q k v kr vr g o o2 dq dk dv dkr dvr
  long long st[13][3];
  float scale_log2;  // log2(e) / sqrt(D)
  float sm_scale;    // 1 / sqrt(D)
};

enum { Q_ = 0, K_, V_, KR_, VR_, G_, O_, O2_, DQ_, DK_, DV_, DKR_, DVR_ };

// Tensor maps of the tiled operands (bf16 path), boxes of 8 columns x the
// kernel's rows for that operand; kr / vr unset with one source.
struct Maps {
  CUtensorMap q, g, k, v, kr, vr;
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const BwdArgs& a, const void* base,
                                            int idx, int b, int s, int h) {
  return static_cast<const T*>(base) + b * a.st[idx][0] + (long long)s * a.st[idx][1] +
         h * a.st[idx][2];
}
template <typename T>
__device__ __forceinline__ T* row_ptr_w(const BwdArgs& a, void* base, int idx,
                                        int b, int s, int h) {
  return static_cast<T*>(base) + b * a.st[idx][0] + (long long)s * a.st[idx][1] +
         h * a.st[idx][2];
}

// (B, H, nsrc, Sq) row of the lse / D_i buffers
__device__ __forceinline__ long long stat_row(const BwdArgs& a, int b, int h, int src) {
  return ((long long)(b * a.H + h) * a.nsrc + src) * a.Sq;
}

// ---------------------------------------------------------------------------
// sm_90 building blocks of this file (the shared ones are in sm90.cuh and
// flash_tiles.cuh)
// ---------------------------------------------------------------------------

// 4 bytes global -> shared; an invalid source writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// g_e = coeff * g rounded to bf16, in place over the first D columns
template <int R, int NT>
__device__ __forceinline__ void scale_tile(bf16* tile, int D, float coeff, int tid) {
  for (int i = tid; i < R * (D / 8); i += NT) {
    bf16* p = tile + tile_at<R>(i % R, i / R);
    float f[8];
    load8(p, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] *= coeff;
    store8(p, f);
  }
}

// Store a warpgroup's 64 x DN accumulator (rows row0 + 16 * warp .., warp
// within the warpgroup) to a (B, S, H, D) bf16 tensor, columns < D and
// rows < S, times `mul`.
template <int DN>
__device__ __forceinline__ void store_rows(const float (&acc)[DN / 2], const BwdArgs& a,
                                           void* base, int idx, int b, int h, int row0,
                                           int S, float mul, int warp, int lane) {
#pragma unroll
  for (int j = 0; j < DN / 2; j += 2) {
    const int row = row0 + 16 * warp + (lane >> 2) + 4 * (j & 2), col = acc_col(j, lane);
    if (row < S && col < a.D)
      *reinterpret_cast<__nv_bfloat162*>(row_ptr_w<bf16>(a, base, idx, b, row, h) + col) =
          __floats2bfloat162_rn(mul * acc[j], mul * acc[j + 1]);
  }
}

// Partial D_i of one query row over columns [c, c + 8): the _bwd_di terms.
__device__ __forceinline__ float di_part(const BwdArgs& a, int b, int row, int h, int c,
                                         int src, float s_b) {
  float gv[8], ov[8];
  load8(row_ptr<bf16>(a, a.g, G_, b, row, h) + c, gv);
  float acc = 0.f;
  if (a.nsrc == 1) {
    load8(row_ptr<bf16>(a, a.o, O_, b, row, h) + c, ov);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += gv[i] * ov[i];
    return acc;
  }
  float o2v[8];
  load8(row_ptr<bf16>(a, a.o2, O2_, b, row, h) + c, o2v);
  if (src == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += gv[i] * o2v[i];
    return s_b * acc;
  }
  load8(row_ptr<bf16>(a, a.o, O_, b, row, h) + c, ov);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc += gv[i] * (ov[i] - s_b * o2v[i]);
  return acc;
}

// ---------------------------------------------------------------------------
// K6b, bf16: D_i and dQ of one q tile of 64 * WGS rows over both sources
// ---------------------------------------------------------------------------
//
// Warpgroup w owns rows 64 w .. 64 w + 63 of the tile; each key tile is
// loaded once for all of them. Key tile t (the source-1 tiles, then the
// reference ones) lands in stage t % STAGES. Groups of products in flight at
// the top of step t: S(t), dP(t), dQ(t-1).

template <int DN>
__global__ void __launch_bounds__(NTH * WGS, 1)
    flash_bwd_dq_wgmma(const BwdArgs a, const __grid_constant__ Maps m) {
  constexpr int NT = NTH * WGS;            // threads
  constexpr int BQ = 64 * WGS;             // q rows of the block
  constexpr int STAGES = ring_stages(DN);
  constexpr int DK = (DN + 15) / 16 * 16;  // contraction width (16-deep steps)
  constexpr int QT = BQ * DK;              // elements of the q tile
  constexpr int TILE = BKV * DK;           // elements of a key tile
  constexpr uint32_t TILE_BYTES = TILE * 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + QT;             // g_e of the current source
  bf16* Ks = Gs + QT;             // [STAGES] key tiles
  bf16* Vs = Ks + STAGES * TILE;  // [STAGES]
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * TILE);  // [STAGES]

  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float s_b = a.nsrc == 2 ? a.ref_scale[b] : 0.f;
  const int n0 = (a.Skv + BKV - 1) / BKV;
  const int nt = n0 + (a.nsrc == 2 && s_b != 0.f ? (a.Skv_ref + BKV - 1) / BKV : 0);
  // key tile t: its source and first key; one thread loads it
  auto tile_src = [&](int t) { return t < n0 ? 0 : 1; };
  auto load_kv = [&](int t) {
    const int src = tile_src(t), st = t % STAGES;
    const int kv0 = (t - src * n0) * BKV;
    mbar_expect(&full[st], 2 * TILE_BYTES + (t == 0 ? 4 * QT : 0));
    tma_tile(Ks + st * TILE, src ? &m.kr : &m.k, h, kv0, b, &full[st]);
    tma_tile(Vs + st * TILE, src ? &m.vr : &m.v, h, kv0, b, &full[st]);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i]);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {  // Q and g with the first key tile, then the second
    load_kv(0);
    tma_tile(Qs, &m.q, h, q0, b, &full[0]);
    tma_tile(Gs, &m.g, h, q0, b, &full[0]);
    for (int i = 1; i < STAGES - 1 && i < nt; ++i) load_kv(i);
  }

  // lse and D_i of this thread's rows r0, r1 for both sources (the 4
  // threads of a row split D); D_i goes to the buffer for K6a
  const int r0 = q0 + 64 * wg + 16 * warp + (lane >> 2), r1 = r0 + 8;
  float lse[2][2], di[2][2];
#pragma unroll
  for (int src = 0; src < 2; ++src) {
    float d0 = 0.f, d1 = 0.f;
    if (src < a.nsrc) {
      for (int c = (lane & 3) * 8; c < a.D; c += 32) {
        if (r0 < a.Sq) d0 += di_part(a, b, r0, h, c, src, s_b);
        if (r1 < a.Sq) d1 += di_part(a, b, r1, h, c, src, s_b);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, off);
      d1 += __shfl_xor_sync(0xffffffffu, d1, off);
    }
    di[src][0] = d0;
    di[src][1] = d1;
    lse[src][0] = lse[src][1] = 0.f;
    if (src < a.nsrc) {
      const long long row = stat_row(a, b, h, src);
      if (r0 < a.Sq) lse[src][0] = a.lse[row + r0];
      if (r1 < a.Sq) lse[src][1] = a.lse[row + r1];
      if ((lane & 3) == 0) {
        if (r0 < a.Sq) a.delta[row + r0] = d0;
        if (r1 < a.Sq) a.delta[row + r1] = d1;
      }
    }
  }

  float dq[DN / 2], s[32], dp[32];
  uint32_t ds[4][4];
#pragma unroll
  for (int j = 0; j < DN / 2; ++j) dq[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;

  // S = Q K^T and dP = G_e V^T of key tile t (this warpgroup's 64 rows),
  // one group each
  const bf16* Qw = Qs + tile_at<BQ>(64 * wg, 0);
  const bf16* Gw = Gs + tile_at<BQ>(64 * wg, 0);
  auto issue_s_dp = [&](int t) {
    const bf16* Kt = Ks + (t % STAGES) * TILE;
    const bf16* Vt = Vs + (t % STAGES) * TILE;
    wgmma_fence();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      Wgmma<64>::ss<0, 0>(s, desc_kmajor<BQ>(Qw, kk), desc_kmajor<BKV>(Kt, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      Wgmma<64>::ss<0, 0>(dp, desc_kmajor<BQ>(Gw, kk), desc_kmajor<BKV>(Vt, kk), kk);
    wgmma_commit();
  };

  mbar_wait(&full[0], 0);  // Q, g and key tile 0 have landed
  issue_s_dp(0);
  wgmma_commit();  // an empty group in the place of dQ(-1)

  for (int t = 0; t < nt; ++t) {
    const int src = tile_src(t);
    const int kv0 = (t - src * n0) * BKV;
    const int Skv = src ? a.Skv_ref : a.Skv;
    // P = exp2(S * scale - lse), keys past Skv masked
    wgmma_wait<2>();
    fence_regs(s);
    const float l0 = src ? lse[1][0] : lse[0][0], l1 = src ? lse[1][1] : lse[0][1];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = fast_exp2(s[j] * a.scale_log2 - ((j & 2) ? l1 : l0));
    if (kv0 + BKV > Skv) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (kv0 + acc_col(j, lane) >= Skv) s[j] = 0.f;
    }
    // dS = P * (dP - D_i)
    wgmma_wait<1>();
    fence_regs(dp);
    const float d0 = src ? di[1][0] : di[0][0], d1 = src ? di[1][1] : di[0][1];
#pragma unroll
    for (int j = 0; j < 32; ++j) dp[j] = s[j] * (dp[j] - ((j & 2) ? d1 : d0));
    wgmma_wait<0>();  // dQ(t-1) done: ds and its key stage are free
    fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(ds[kk], dp, kk);

    if (t + 1 < nt) {
      mbar_wait(&full[(t + 1) % STAGES], (t + 1) / STAGES & 1);  // key tile t+1
      if (t + 1 == n0 && s_b != 1.f) {  // the reference source: g -> s_b g
        __syncthreads();
        scale_tile<BQ, NT>(Gs, a.D, s_b, tid);
        fence_async_shared();
      }
      __syncthreads();  // every warp is past dQ(t-1): its stage is free
      if (tid == 0 && t + STAGES - 1 < nt) load_kv(t + STAGES - 1);
      issue_s_dp(t + 1);
    }
    // dQ += dS K, K read MN-major
    const bf16* Kt = Ks + (t % STAGES) * TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<DN>::template rs<1>(dq, ds[kk], desc_mnmajor<BKV>(Kt, kk), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(dq);

  store_rows<DN>(dq, a, a.dq, DQ_, b, h, q0 + 64 * wg, a.Sq, a.sm_scale, warp, lane);
}

// ---------------------------------------------------------------------------
// K6a, bf16: dK, dV of one key tile of 64 * WGS keys
// ---------------------------------------------------------------------------
//
// Warpgroup w owns keys 64 w .. 64 w + 63 of the tile; each q tile is loaded
// once for all of them. Q tile i (q, g_e, and its lse / D_i rows) lands in
// stage i % STAGES. Groups of products in flight at the top of step i:
// S^T(i), dP^T(i), dV/dK(i-1).

template <int DN, int BQ>
__global__ void __launch_bounds__(NTH * WGS, 1)
    flash_bwd_dkv_wgmma(const BwdArgs a, const __grid_constant__ Maps m) {
  constexpr int NT = NTH * WGS;  // threads
  constexpr int BK = 64 * WGS;   // keys of the block
  constexpr int STAGES = ring_stages(DN);
  constexpr int DK = (DN + 15) / 16 * 16;
  constexpr int KT = BK * DK;   // elements of the key tile
  constexpr int QT = BQ * DK;   // elements of a q tile
  constexpr int NS = BQ / 2;    // accumulator floats of m64nBQ
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + KT;
  bf16* Qs = Vs + KT;           // [STAGES]
  bf16* Gs = Qs + STAGES * QT;  // [STAGES] g_e
  float* Ls = reinterpret_cast<float*>(Gs + STAGES * QT);  // [STAGES][BQ] lse
  float* Ds = Ls + STAGES * BQ;                             // [STAGES][BQ] D_i
  uint64_t* full = reinterpret_cast<uint64_t*>(Ds + STAGES * BQ);  // [STAGES]

  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  const int h = blockIdx.y, b = blockIdx.z, D = a.D;
  const int nkt0 = (a.Skv + BK - 1) / BK;
  const int src = (int)blockIdx.x >= nkt0 ? 1 : 0;
  const int kv0 = ((int)blockIdx.x - src * nkt0) * BK;
  const int Skv = src ? a.Skv_ref : a.Skv;
  const float s_b = a.nsrc == 2 ? a.ref_scale[b] : 0.f;
  const float coeff = src ? s_b : 1.f;
  void* dkp = src ? a.dkr : a.dk;
  void* dvp = src ? a.dvr : a.dv;
  const int idk = src ? DKR_ : DK_, idv = src ? DVR_ : DV_;

  if (src == 1 && s_b == 0.f) {  // zero contribution: write zeros
    for (int idx = tid; idx < BK * (D / 8); idx += NT) {
      const int r = idx / (D / 8), cv = (idx % (D / 8)) * 8;
      if (kv0 + r < Skv) {
        *reinterpret_cast<uint4*>(row_ptr_w<bf16>(a, dkp, idk, b, kv0 + r, h) + cv) =
            make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(row_ptr_w<bf16>(a, dvp, idv, b, kv0 + r, h) + cv) =
            make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  const long long srow = stat_row(a, b, h, src);
  const int nq = (a.Sq + BQ - 1) / BQ;
  // the q side of tile i: q and g by one thread, the lse / D_i rows by
  // cp.async (one group per tile, committed by every thread)
  auto load_q_side = [&](int i) {
    const int q0 = i * BQ, st = i % STAGES;
    if (tid == 0) {
      mbar_expect(&full[st], 2 * QT * 2 + (i == 0 ? 2 * KT * 2 : 0));
      tma_tile(Qs + st * QT, &m.q, h, q0, b, &full[st]);
      tma_tile(Gs + st * QT, &m.g, h, q0, b, &full[st]);
    }
    if (tid < 2 * BQ) {
      const int r = tid % BQ;
      const bool ok = q0 + r < a.Sq;
      const float* from = tid < BQ ? a.lse : a.delta;
      float* to = tid < BQ ? Ls : Ds;
      cp_async4(to + st * BQ + r, from + srow + (ok ? q0 + r : 0), ok);
    }
    cp_async_commit();
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i]);
    mbar_init_fence();
  }
  __syncthreads();
  load_q_side(0);
  if (tid == 0) {  // the key tile with q tile 0
    tma_tile(Ks, src ? &m.kr : &m.k, h, kv0, b, &full[0]);
    tma_tile(Vs, src ? &m.vr : &m.v, h, kv0, b, &full[0]);
  }
  for (int i = 1; i < STAGES - 1; ++i) {
    if (i < nq) load_q_side(i);
    else cp_async_commit();  // one cp.async group per tile index
  }

  float dk[DN / 2], dv[DN / 2], s[NS], dp[NS];
  uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
  for (int j = 0; j < DN / 2; ++j) dk[j] = dv[j] = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.f;

  // S^T = K Q^T and dP^T = V G_e^T of q tile i: this warpgroup's 64 keys x
  // BQ rows
  const bf16* Kw = Ks + tile_at<BK>(64 * wg, 0);
  const bf16* Vw = Vs + tile_at<BK>(64 * wg, 0);
  auto issue_s_dp = [&](int i) {
    const bf16* Qt = Qs + (i % STAGES) * QT;
    const bf16* Gt = Gs + (i % STAGES) * QT;
    wgmma_fence();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      Wgmma<BQ>::template ss<0, 0>(s, desc_kmajor<BK>(Kw, kk), desc_kmajor<BQ>(Qt, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      Wgmma<BQ>::template ss<0, 0>(dp, desc_kmajor<BK>(Vw, kk), desc_kmajor<BQ>(Gt, kk), kk);
    wgmma_commit();
  };
  // q tile i in its stage: the lse / D_i rows of every thread, and g_e
  auto ready = [&](int i) {
    mbar_wait(&full[i % STAGES], i / STAGES & 1);
    if (coeff != 1.f) {
      scale_tile<BQ, NT>(Gs + (i % STAGES) * QT, D, coeff, tid);
      fence_async_shared();
    }
  };

  ready(0);
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  issue_s_dp(0);
  wgmma_commit();  // an empty group in the place of dV/dK(-1)

  for (int i = 0; i < nq; ++i) {
    const int q0 = i * BQ;
    const float* Lt = Ls + (i % STAGES) * BQ;
    const float* Dt = Ds + (i % STAGES) * BQ;
    // P^T = exp2(S^T * scale - lse[q]); queries past Sq masked
    wgmma_wait<2>();
    fence_regs(s);
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = fast_exp2(s[j] * a.scale_log2 - Lt[acc_col(j, lane)]);
    if (q0 + BQ > a.Sq) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
        if (q0 + acc_col(j, lane) >= a.Sq) s[j] = 0.f;
    }
    // dS^T = P^T * (dP^T - D_i[q])
    wgmma_wait<1>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < NS; ++j) dp[j] = s[j] * (dp[j] - Dt[acc_col(j, lane)]);
    wgmma_wait<0>();  // dV/dK(i-1) done: pa, dsa and its q stage are free
    fence_regs(dv);
    fence_regs(dk);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      a_frag(pa[kk], s, kk);
      a_frag(dsa[kk], dp, kk);
    }

    if (i + 1 < nq) {
      ready(i + 1);
      cp_async_wait<STAGES - 3>();
      __syncthreads();  // every warp is past dV/dK(i-1): its stage is free
      if (i + STAGES - 1 < nq) load_q_side(i + STAGES - 1);
      else cp_async_commit();
      issue_s_dp(i + 1);
    }
    // dV += P^T G_e and dK += dS^T Q, G_e and Q read MN-major
    const bf16* Qt = Qs + (i % STAGES) * QT;
    const bf16* Gt = Gs + (i % STAGES) * QT;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      Wgmma<DN>::template rs<1>(dv, pa[kk], desc_mnmajor<BQ>(Gt, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      Wgmma<DN>::template rs<1>(dk, dsa[kk], desc_mnmajor<BQ>(Qt, kk), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(dv);
  fence_regs(dk);

  // the 1/sqrt(D) of dK is applied once, here
  store_rows<DN>(dk, a, dkp, idk, b, h, kv0 + 64 * wg, Skv, a.sm_scale, warp, lane);
  store_rows<DN>(dv, a, dvp, idv, b, h, kv0 + 64 * wg, Skv, 1.f, warp, lane);
}

// ---------------------------------------------------------------------------
// fp32 (parity mode): SIMT, a warp per row, D over the lanes
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// D_i of one query row, every lane holding the result
template <int DPL>
__device__ __forceinline__ float di_row_f32(const BwdArgs& a, int b, int row, int h,
                                            int src, float s_b, int lane) {
  const float* gr = row_ptr<float>(a, a.g, G_, b, row, h);
  const float* orow = row_ptr<float>(a, a.o, O_, b, row, h);
  const float* o2r = a.nsrc == 2 ? row_ptr<float>(a, a.o2, O2_, b, row, h) : nullptr;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d >= a.D) continue;
    if (a.nsrc == 1) acc += gr[d] * orow[d];
    else if (src == 1) acc += gr[d] * o2r[d];
    else acc += gr[d] * (orow[d] - s_b * o2r[d]);
  }
  acc = warp_sum(acc);
  return (a.nsrc == 2 && src == 1) ? s_b * acc : acc;
}

template <int DPL>
__global__ void __launch_bounds__(NTH) flash_bwd_dkv_f32(const BwdArgs a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z, D = a.D;
  const int nkb0 = (a.Skv + NTH / 32 - 1) / (NTH / 32);
  const int src = (int)blockIdx.x >= nkb0 ? 1 : 0;
  const int kj = ((int)blockIdx.x - src * nkb0) * (NTH / 32) + warp;
  const int Skv = src ? a.Skv_ref : a.Skv;
  if (kj >= Skv) return;
  const float s_b = a.nsrc == 2 ? a.ref_scale[b] : 0.f;
  const float coeff = src ? s_b : 1.f;
  float* dkr = row_ptr_w<float>(a, src ? a.dkr : a.dk, src ? DKR_ : DK_, b, kj, h);
  float* dvr = row_ptr_w<float>(a, src ? a.dvr : a.dv, src ? DVR_ : DV_, b, kj, h);
  float kv[DPL], vv[DPL], dk[DPL], dv[DPL];
  const float* kr = row_ptr<float>(a, src ? a.kr : a.k, src ? KR_ : K_, b, kj, h);
  const float* vr = row_ptr<float>(a, src ? a.vr : a.v, src ? VR_ : V_, b, kj, h);
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    kv[i] = d < D ? kr[d] : 0.f;
    vv[i] = d < D ? vr[d] : 0.f;
    dk[i] = dv[i] = 0.f;
  }
  if (!(src == 1 && s_b == 0.f)) {  // a scale-0 reference row contributes 0
    const float* lse_b = a.lse + ((long long)(b * a.H + h) * a.nsrc + src) * a.Sq;
    for (int qi = 0; qi < a.Sq; ++qi) {
      const float* qr = row_ptr<float>(a, a.q, Q_, b, qi, h);
      const float* gr = row_ptr<float>(a, a.g, G_, b, qi, h);
      float qv[DPL], gv[DPL], sdot = 0.f, dpdot = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        qv[i] = d < D ? qr[d] : 0.f;
        gv[i] = d < D ? coeff * gr[d] : 0.f;
        sdot += qv[i] * kv[i];
        dpdot += gv[i] * vv[i];
      }
      sdot = warp_sum(sdot);
      dpdot = warp_sum(dpdot);
      const float p = exp2f(sdot * a.scale_log2 - lse_b[qi]);
      const float ds = p * (dpdot - di_row_f32<DPL>(a, b, qi, h, src, s_b, lane));
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        dv[i] += p * gv[i];
        dk[i] += ds * qv[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) {
      dkr[d] = a.sm_scale * dk[i];
      dvr[d] = dv[i];
    }
  }
}

template <int DPL>
__global__ void __launch_bounds__(NTH) flash_bwd_dq_f32(const BwdArgs a) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (NTH / 32) + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z, D = a.D;
  if (qi >= a.Sq) return;
  const float s_b = a.nsrc == 2 ? a.ref_scale[b] : 0.f;
  const float* qr = row_ptr<float>(a, a.q, Q_, b, qi, h);
  const float* gr = row_ptr<float>(a, a.g, G_, b, qi, h);
  float qv[DPL], gv[DPL], dq[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? qr[d] : 0.f;
    gv[i] = d < D ? gr[d] : 0.f;
    dq[i] = 0.f;
  }
  for (int src = 0; src < a.nsrc; ++src) {
    const float di = di_row_f32<DPL>(a, b, qi, h, src, s_b, lane);
    if (lane == 0) a.delta[stat_row(a, b, h, src) + qi] = di;
    if (src == 1 && s_b == 0.f) break;
    const float coeff = src ? s_b : 1.f;
    const int Skv = src ? a.Skv_ref : a.Skv;
    const float lse = a.lse[stat_row(a, b, h, src) + qi];
    for (int kj = 0; kj < Skv; ++kj) {
      const float* kr = row_ptr<float>(a, src ? a.kr : a.k, src ? KR_ : K_, b, kj, h);
      const float* vr = row_ptr<float>(a, src ? a.vr : a.v, src ? VR_ : V_, b, kj, h);
      float kv[DPL], sdot = 0.f, dpdot = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        kv[i] = d < D ? kr[d] : 0.f;
        sdot += qv[i] * kv[i];
        dpdot += coeff * gv[i] * (d < D ? vr[d] : 0.f);
      }
      sdot = warp_sum(sdot);
      dpdot = warp_sum(dpdot);
      const float ds = exp2f(sdot * a.scale_log2 - lse) * (dpdot - di);
#pragma unroll
      for (int i = 0; i < DPL; ++i) dq[i] += ds * kv[i];
    }
  }
  float* out = row_ptr_w<float>(a, a.dq, DQ_, b, qi, h);
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) out[d] = a.sm_scale * dq[i];
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// A map over operand `idx` whose box is one tile of `rows` rows x `chunks`
// column chunks (make_bshd_map)
bool make_map(CUtensorMap* map, const BwdArgs& a, const void* base, int idx, int S, int rows,
              int chunks) {
  return make_bshd_map(map, base, a.st[idx], a.B, S, a.H, a.D, rows, chunks);
}

// q and g with boxes of q_rows rows, k v (kr vr) of kv_rows rows
bool make_maps(Maps* m, const BwdArgs& a, int q_rows, int kv_rows, int chunks) {
  bool ok = make_map(&m->q, a, a.q, Q_, a.Sq, q_rows, chunks) &&
            make_map(&m->g, a, a.g, G_, a.Sq, q_rows, chunks) &&
            make_map(&m->k, a, a.k, K_, a.Skv, kv_rows, chunks) &&
            make_map(&m->v, a, a.v, V_, a.Skv, kv_rows, chunks);
  if (ok && a.nsrc == 2)
    ok = make_map(&m->kr, a, a.kr, KR_, a.Skv_ref, kv_rows, chunks) &&
         make_map(&m->vr, a, a.vr, VR_, a.Skv_ref, kv_rows, chunks);
  return ok;
}

template <int DN>
int launch_dq_bf16(const BwdArgs& a, cudaStream_t st) {
  constexpr int DK = (DN + 15) / 16 * 16;
  constexpr int BQ = 64 * WGS;
  constexpr int STAGES = ring_stages(DN);
  const size_t smem = (size_t)(2 * BQ + 2 * STAGES * BKV) * DK * sizeof(bf16) +
                      STAGES * sizeof(uint64_t);
  Maps m;
  if (!make_maps(&m, a, BQ, BKV, DK / 8)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<DN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_wgmma<DN>
      <<<dim3((a.Sq + BQ - 1) / BQ, a.H, a.B), NTH * WGS, smem, st>>>(a, m);
  return (int)cudaGetLastError();
}

template <int DN>
int launch_dkv_bf16(const BwdArgs& a, cudaStream_t st) {
  constexpr int DK = (DN + 15) / 16 * 16;
  constexpr int BQ = DN <= 80 ? 64 : 32;
  constexpr int BK = 64 * WGS;
  constexpr int STAGES = ring_stages(DN);
  const size_t smem = (size_t)(2 * BK + 2 * STAGES * BQ) * DK * sizeof(bf16) +
                      2 * STAGES * BQ * sizeof(float) + STAGES * sizeof(uint64_t);
  Maps m;
  if (!make_maps(&m, a, BQ, BK, DK / 8)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma<DN, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.Skv + BK - 1) / BK + (a.nsrc == 2 ? (a.Skv_ref + BK - 1) / BK : 0);
  flash_bwd_dkv_wgmma<DN, BQ>
      <<<dim3(tiles, a.H, a.B), NTH * WGS, smem, st>>>(a, m);
  return (int)cudaGetLastError();
}

// The N width of the D-wide products: the smallest instantiated width >= D
// (the columns past D read the zero-filled padding chunks and are not
// stored).
template <template <int> class F>
int by_width(const BwdArgs& a, cudaStream_t st) {
  if (a.D <= 16) return F<16>::run(a, st);
  if (a.D <= 32) return F<32>::run(a, st);
  if (a.D <= 40) return F<40>::run(a, st);
  if (a.D <= 64) return F<64>::run(a, st);
  if (a.D <= 80) return F<80>::run(a, st);
  if (a.D <= 128) return F<128>::run(a, st);
  return F<160>::run(a, st);
}
template <int DN>
struct DqBf16 {
  static int run(const BwdArgs& a, cudaStream_t st) { return launch_dq_bf16<DN>(a, st); }
};
template <int DN>
struct DkvBf16 {
  static int run(const BwdArgs& a, cudaStream_t st) { return launch_dkv_bf16<DN>(a, st); }
};

template <int DPL>
int launch_dkv_f32(const BwdArgs& a, cudaStream_t st) {
  constexpr int RPB = NTH / 32;
  const int blocks = (a.Skv + RPB - 1) / RPB + (a.nsrc == 2 ? (a.Skv_ref + RPB - 1) / RPB : 0);
  flash_bwd_dkv_f32<DPL><<<dim3(blocks, a.H, a.B), NTH, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <int DPL>
int launch_dq_f32(const BwdArgs& a, cudaStream_t st) {
  flash_bwd_dq_f32<DPL><<<dim3((a.Sq + NTH / 32 - 1) / (NTH / 32), a.H, a.B), NTH, 0, st>>>(a);
  return (int)cudaGetLastError();
}

BwdArgs make_args(const void* const* ptrs, const float* lse, const float* ref_scale,
                  float* delta, const int* dims, const long long* strides,
                  float scale_log2, float sm_scale) {
  BwdArgs a;
  a.q = ptrs[0]; a.k = ptrs[1]; a.v = ptrs[2]; a.kr = ptrs[3]; a.vr = ptrs[4];
  a.g = ptrs[5]; a.o = ptrs[6]; a.o2 = ptrs[7];
  a.dq = const_cast<void*>(ptrs[8]);
  a.dk = const_cast<void*>(ptrs[9]);
  a.dv = const_cast<void*>(ptrs[10]);
  a.dkr = const_cast<void*>(ptrs[11]);
  a.dvr = const_cast<void*>(ptrs[12]);
  a.lse = lse; a.ref_scale = ref_scale; a.delta = delta;
  a.B = dims[0]; a.H = dims[1]; a.Sq = dims[2]; a.Skv = dims[3];
  a.Skv_ref = dims[4]; a.D = dims[5]; a.nsrc = dims[6];
  for (int i = 0; i < 13; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[i * 3 + j];
  a.scale_log2 = scale_log2;
  a.sm_scale = sm_scale;
  return a;
}

}  // namespace

// ptrs: 13 device pointers (q k v kr vr g o o2 dq dk dv dkr dvr; the
// reference ones null with one source); delta: the (B, H, nsrc, Sq) fp32 D_i
// buffer, written by the dq launch and read by the dkv launch (bf16), which
// must come after it on the stream; dims: B H Sq Skv Skv_ref D nsrc; strides:
// 13 (batch, seq, head) triples in the same order. Each returns a CUDA error
// code; 1 (cudaErrorInvalidValue) for an unsupported D.
#define BWD_ARGS                                                               \
  const void *const *ptrs, const float *lse, const float *ref_scale,           \
      float *delta, const int *dims, const long long *strides,                 \
      float scale_log2, float sm_scale, void *stream
#define MAKE_BWD                                                               \
  const BwdArgs a = make_args(ptrs, lse, ref_scale, delta, dims, strides,      \
                              scale_log2, sm_scale);                           \
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);                    \
  if (a.D % 8 != 0 || a.D > 160) return (int)cudaErrorInvalidValue;

extern "C" int flash_bwd_dq_bf16_launch(BWD_ARGS) {
  MAKE_BWD
  return by_width<DqBf16>(a, st);
}

extern "C" int flash_bwd_dkv_bf16_launch(BWD_ARGS) {
  MAKE_BWD
  return by_width<DkvBf16>(a, st);
}

extern "C" int flash_bwd_dkv_f32_launch(BWD_ARGS) {
  MAKE_BWD
  if (a.D <= 64) return launch_dkv_f32<2>(a, st);
  if (a.D <= 96) return launch_dkv_f32<3>(a, st);
  return launch_dkv_f32<5>(a, st);
}

extern "C" int flash_bwd_dq_f32_launch(BWD_ARGS) {
  MAKE_BWD
  if (a.D <= 64) return launch_dq_f32<2>(a, st);
  if (a.D <= 96) return launch_dq_f32<3>(a, st);
  return launch_dq_f32<5>(a, st);
}
