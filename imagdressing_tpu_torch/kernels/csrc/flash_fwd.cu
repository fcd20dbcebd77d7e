// Flash attention forward over one or two KV sources:
//   out = SDPA(q, k, v) + s_b * SDPA(q, k_ref, v_ref)      (per batch b)
// q/k/v (B, S, H, D) read by strides; a separate (k_ref, v_ref) pointer pair
// replaces the concatenated KV axis of the Pallas kernels.
//
// Replaces imagdressing_tpu/kernels/flash_attention.py:_flash_kernel (K1,
// the inference forward: one online softmax per source, fp32 accumulation,
// the whole reference pass skipped where s_b == 0 -- the uncond half of the
// CFG batch -- and a single-source mode) and :_flash_res_kernel (K5, the
// training forward, residual mode below).
//
// Bound on the H100: the bytes (q, k, v, out once each) are far below the
// operations. Per (q, k) pair and source run there is one exp2 on the
// special-function units (16 per clock per SM) and 4 * D tensor-core FLOPs
// (989 TFLOP/s dense bf16). At D = 40 the exp2 term is the larger (0.150
// against 0.102 ms at (2,5120,8,40) dual with one skipped row); from D = 80
// on the tensor work is. So the design keeps the exp2 of one tile running
// while the tensor cores work on another.
//
// Design (bf16, sm_90a):
//  * A block is one producer warp and two consumer warpgroups (one for
//    64-row blocks), each consumer owning 64 query rows of one (b, h). One
//    producer thread loads the q tile once and streams the key / value
//    tiles of both sources through a ring of stages in shared memory, each
//    stage with a "full" mbarrier (the tensor unit's byte count) and an
//    "empty" one (the consumers' release); it asks for a whole tile with one
//    instruction, through a 5-D tensor map over the (B, S, H, D) strides.
//    The unit zero-fills the rows past the sequence end and the columns of
//    the D padding (40 -> 48 on the contraction). Every key tile serves all
//    the block's q rows.
//  * Products on wgmma m64nNk16: S = Q K^T with both operands in shared
//    memory (N = BKV keys, chosen per shape by
//    `kernels/flash_attention.py:flash_plan`); P is rounded to bf16 in
//    registers as the A fragment of O += P V, whose B operand is the row-
//    major V tile read MN-major (wgmma's transpose bit): no transposed copy.
//  * Overlap: step t issues S(t) into a fresh accumulator, rescales O and
//    issues O += P(t-1) V(t-1), then runs the softmax of S(t). The two
//    consumer warpgroups take turns to issue (named barriers 1 and 2,
//    PINGPONG), so one's softmax runs under the other's products. Within a
//    warpgroup only the row max runs under PV(t-1): ptxas holds the exp2s,
//    which write S's registers in place, until PV(t-1) has landed. No
//    instruction but a wgmma defines an accumulator while a product is in
//    flight: ptxas would otherwise serialize every wgmma of the kernel.
//  * The softmax is base 2 in fp32: the running max is kept on the raw fp32
//    scores and each probability is exp2(s * c - m * c), one FFMA into
//    ex2.approx, c = log2(e) / sqrt(D) in fp32 (never folded into bf16 q,
//    unlike the TPU kernel). The row sums are per-thread partials, reduced
//    once per source.
//  * Two sources: source 0's normalized output waits in registers (D <= 128)
//    or in shared memory (wider) while the reference source runs. Where
//    s_b == 0 the block never asks for a reference tile, and out is exactly
//    o0 (no 0/0). The grid's batch rows with a reference pass start first,
//    so the blocks of half the work (the CFG uncond half) fill the tail.
//  * D = 512 (the VAE mid attention, one head, two launches per image): a
//    block covers 256 output columns with 64 rows and 32-key tiles, and runs
//    S over all 512; two blocks per q tile, so twice the QK work.
//  * No atomics: every output element is written once by one thread, so
//    repeats are bit-equal.
//
// Residual mode (RES, K5): the same kernel additionally writes each
// source's base-2 log-sum-exp lse = m * c + log2(l) (layout (B, H,
// n_sources, Sq), fp32) and, with two sources, O2 = the reference source's
// normalized output (B, Sq, H, D) in bf16. It never skips the reference pass
// of a scale-0 row: d out / d s = O2 must exist there. D <= 160 (the
// backward's limit).
//
// The fp32 variants (parity mode) are a SIMT kernel: one warp per query
// row, D spread over the lanes, the same base-2 online softmax.
#include "common.cuh"
#include "flash_tiles.cuh"
#include "sm90.cuh"
#include "wgmma.cuh"

namespace {

constexpr int NTH = 128;  // threads of a warpgroup, and of the other kernels
// The two consumer warpgroups take turns to issue their products.
constexpr bool PINGPONG = true;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* kr;
  const void* vr;
  const float* ref_scale;  // (B,) fp32 on the device, or null
  void* out;
  float* lse;  // residual mode: (B, H, n_sources, Sq) fp32, else null
  void* o2;    // residual mode with two sources: (B, Sq, H, D), else null
  int B, H, Sq, Skv, Skv_ref, D;
  int stages;  // depth of the key / value ring (wgmma kernel)
  // element strides (batch, seq, head) of q, k, v, k_ref, v_ref, out, o2
  long long st[7][3];
  float scale_log2;  // log2(e) / sqrt(D), fp32
};

enum { Q_ = 0, K_, V_, KR_, VR_, OUT_, O2_ };

// Tensor maps of the tiled operands: q with boxes of the block's rows, the
// key / value tiles with boxes of BKV rows; kr / vr unset with one source.
struct FwdMaps {
  CUtensorMap q, k, v, kr, vr;
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The batch row of grid row z: with a skip, the rows with a reference pass
// (s_b != 0) first, each group in batch order.
__device__ int batch_of(const FlashArgs& a, int z, bool skip) {
  if (!skip) return z;
  int dual = 0;
  for (int i = 0; i < a.B; ++i) dual += a.ref_scale[i] != 0.f;
  const bool want = z < dual;
  int k = want ? z : z - dual;
  for (int i = 0; i < a.B; ++i)
    if ((a.ref_scale[i] != 0.f) == want && k-- == 0) return i;
  return z;
}

__device__ __forceinline__ bf16* elem(const FlashArgs& a, void* base, int idx, int b, int row,
                                      int h) {
  return static_cast<bf16*>(base) + b * a.st[idx][0] + (long long)row * a.st[idx][1] +
         h * a.st[idx][2];
}

__host__ __device__ constexpr int contraction(int dn) { return (dn + 15) / 16 * 16; }

// Shared memory of the wgmma kernel (kernels/flash_attention.py:fwd_smem
// computes the same): the q tile, the ring of key (DK columns) and value (DN
// columns) tiles, source 0's output where it does not stay in registers
// (two sources, DN > 128), the barriers.
__host__ __device__ constexpr size_t fwd_smem(int dn, int dk, int bkv, int wgs, int stages,
                                              bool dual) {
  return (size_t)(64 * wgs * dk + stages * bkv * (dk + dn)) * 2 +
         (dual && dn > 128 ? (size_t)64 * wgs * dn * 4 : 0) + (size_t)(2 * stages + 1) * 8;
}

// ---------------------------------------------------------------------------
// K1 and K5, bf16: one q tile of 64 * WGS rows over both sources
// ---------------------------------------------------------------------------
//
// DN output columns per block (from col0), DK the contraction (D padded):
// at D <= 160 one block covers every column (DK = D padded to 16); at D = 512
// two blocks of 256 columns each run S = Q K^T over all 512 (twice the QK
// work, not the four times of 128-column chunks). Key tile t (the source-0
// tiles, then the reference ones) lands in stage t % stages. Warpgroups 0
// .. WGS-1 consume, the warp after them produces.

template <int DN, int DK, int BKV, int WGS, bool RES>
__global__ void __launch_bounds__(NTH * WGS + 32, 1)
    flash_fwd_wgmma(const FlashArgs a, const __grid_constant__ FwdMaps mp) {
  constexpr int NC = NTH * WGS;   // consumer threads
  constexpr int BQ = 64 * WGS;    // q rows of the block
  constexpr int QT = BQ * DK;     // elements of the q tile
  constexpr int KTILE = BKV * DK;  // elements of a key tile
  constexpr int VTILE = BKV * DN;  // elements of a value tile (the block's columns)
  constexpr int NS = BKV / 2;     // score floats of a thread
  constexpr int NO = DN / 2;      // output floats of a thread
  constexpr bool SMEM_O0 = DN > 128;
  const int stages = a.stages;
  const bool dual = a.kr != nullptr;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + QT;               // [stages]
  bf16* Vs = Ks + stages * KTILE;   // [stages]
  float* O0s = reinterpret_cast<float*>(Vs + stages * VTILE);  // [NO][NC] (SMEM_O0, dual)
  uint64_t* full = reinterpret_cast<uint64_t*>(O0s + (SMEM_O0 && dual ? NO * NC : 0));
  uint64_t* empty = full + stages;
  uint64_t* qbar = empty + stages;

  const int tid = threadIdx.x;
  const int b = batch_of(a, blockIdx.z, dual && !RES);
  const int ncb = (a.D + DN - 1) / DN;  // column blocks per q tile
  const int q0 = (blockIdx.x / ncb) * BQ, col0 = (blockIdx.x % ncb) * DN, h = blockIdx.y;
  const float s_b = dual ? a.ref_scale[b] : 0.f;
  const int n0 = (a.Skv + BKV - 1) / BKV;
  const int nt = n0 + (dual && (RES || s_b != 0.f) ? (a.Skv_ref + BKV - 1) / BKV : 0);

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i]);
      mbar_init(&empty[i], WGS);  // one arrival per consumer warpgroup
    }
    mbar_init(qbar);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= NC) {  // the producer warp: one thread asks for every tile
    if (tid == NC) {
      mbar_expect(qbar, QT * 2);
      tma_tile(Qs, &mp.q, h, q0, b, qbar);
      for (int t = 0, st = 0, ph = 0; t < nt; ++t) {  // tile t in stage st, phase ph
        const int src = t >= n0 ? 1 : 0;
        const int kv0 = (t - src * n0) * BKV;
        if (t >= stages) mbar_wait(&empty[st], ph ^ 1);
        mbar_expect(&full[st], 2 * (KTILE + VTILE));
        tma_tile(Ks + st * KTILE, src ? &mp.kr : &mp.k, h, kv0, b, &full[st]);
        tma_tile(Vs + st * VTILE, src ? &mp.vr : &mp.v, h, kv0, b, &full[st], col0 / 8);
        if (++st == stages) st = 0, ph ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup wg: rows q0 + 64 wg .., this thread's r0 and r1
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = q0 + 64 * wg + 16 * warp + (lane >> 2), r1 = r0 + 8;
  const float c = a.scale_log2;
  const bf16* Qw = Qs + tile_at<BQ>(64 * wg, 0);
  constexpr bool PP = PINGPONG && WGS == 2;

  // o: the output, rescaled while S(t) is in flight; pf: P of the tile
  // whose O += P V comes next, bf16 A fragments (packed once that product's
  // predecessor has landed)
  float o[NO], o0[SMEM_O0 ? 1 : NO];
  uint32_t pf[BKV / 16][4];
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;  // m on the raw scores
  float corr0 = 1.f, corr1 = 1.f;  // o's rescale before the next O += P V
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j] = 0.f;

  // S = Q K^T of the key tile in stage st (this warpgroup's 64 rows) into a fresh
  // accumulator, one group (an accumulator that another instruction defines
  // while a product is in flight makes ptxas serialize every wgmma)
  auto issue_s = [&](float (&s)[NS], int st) {
    const bf16* Kt = Ks + st * KTILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      Wgmma<BKV>::template ss<0, 0>(s, desc_kmajor<BQ>(Qw, kk), desc_kmajor<BKV>(Kt, kk), kk);
    wgmma_commit();
  };
  // O += P V of the value tile in stage st, P from pf, V read MN-major;
  // one group
  auto issue_pv = [&](int st) {
    const bf16* Vt = Vs + st * VTILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      Wgmma<DN>::template rs<1>(o, pf[kk], desc_mnmajor<BKV>(Vt, kk), 1);
    wgmma_commit();
  };

  // The online softmax of S(t) in place (rows r0: j % 4 < 2, and r1), keys
  // past the end at -1e30: the running max and sums, o's next rescale, and
  // P in s
  auto softmax = [&](float (&s)[NS], int t) {
    const int src = t >= n0 ? 1 : 0;
    const int kv0 = (t - src * n0) * BKV, Skv = src ? a.Skv_ref : a.Skv;
    if (kv0 + BKV > Skv) {  // the last tile of a source
#pragma unroll
      for (int j = 0; j < NS; ++j)
        if (kv0 + acc_col(j, lane) >= Skv) s[j] = -1e30f;
    }
    // (softmax begins)
    // the row max and sums in 8 independent chains (element j in chain j % 8:
    // chains 0, 1, 4, 5 hold row r0), so that two warps per scheduler keep
    // the pipes busy
    float xm[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) xm[i] = (i & 2) ? m1 : m0;
#pragma unroll
    for (int j = 0; j < NS; ++j) xm[j & 7] = fmaxf(xm[j & 7], s[j]);
    float x0 = fmaxf(fmaxf(xm[0], xm[1]), fmaxf(xm[4], xm[5]));
    float x1 = fmaxf(fmaxf(xm[2], xm[3]), fmaxf(xm[6], xm[7]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
    }
    corr0 = fast_exp2((m0 - x0) * c);
    corr1 = fast_exp2((m1 - x1) * c);
    const float mc0 = x0 * c, mc1 = x1 * c;
    m0 = x0;
    m1 = x1;
    float ls[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j] = fast_exp2(fmaf(s[j], c, (j & 2) ? -mc1 : -mc0));
      ls[j & 7] += s[j];
    }
    l0 = l0 * corr0 + ((ls[0] + ls[1]) + (ls[4] + ls[5]));
    l1 = l1 * corr1 + ((ls[2] + ls[3]) + (ls[6] + ls[7]));
    // (softmax ends)
  };

  // The end of source src: o / l, then either kept for the reference source
  // (`keep`), or written as out (the sum with the kept source 0 where src is
  // 1), with the lse and O2 in residual mode.
  auto finish = [&](int src, bool keep, float fm0, float fm1, float fl0, float fl1) {
    float lt0 = fl0, lt1 = fl1;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      lt0 += __shfl_xor_sync(0xffffffffu, lt0, off);
      lt1 += __shfl_xor_sync(0xffffffffu, lt1, off);
    }
    if (RES && (lane & 3) == 0) {
      float* lb = a.lse + ((long long)(b * a.H + h) * (dual ? 2 : 1) + src) * a.Sq;
      if (r0 < a.Sq) lb[r0] = fm0 * c + log2f(lt0);
      if (r1 < a.Sq) lb[r1] = fm1 * c + log2f(lt1);
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] = __fdiv_rn(o[j], (j & 2) ? lt1 : lt0);
    if (keep) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        if constexpr (SMEM_O0) O0s[j * NC + tid] = o[j];
        else o0[j] = o[j];
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < NO; j += 2) {
      const int row = (j & 2) ? r1 : r0, col = col0 + acc_col(j, lane);
      if (row >= a.Sq || col >= a.D) continue;
      float y0 = o[j], y1 = o[j + 1];
      if (src == 1) {
        if (RES)
          *reinterpret_cast<__nv_bfloat162*>(elem(a, a.o2, O2_, b, row, h) + col) =
              __floats2bfloat162_rn(y0, y1);
        float x0, x1;
        if constexpr (SMEM_O0) {
          x0 = O0s[j * NC + tid];
          x1 = O0s[(j + 1) * NC + tid];
        } else {
          x0 = o0[j];
          x1 = o0[j + 1];
        }
        // the plain version's order: o0 + (s_b * o1), two roundings
        y0 = __fadd_rn(x0, __fmul_rn(s_b, y0));
        y1 = __fadd_rn(x1, __fmul_rn(s_b, y1));
      }
      *reinterpret_cast<__nv_bfloat162*>(elem(a, a.out, OUT_, b, row, h) + col) =
          __floats2bfloat162_rn(y0, y1);
    }
  };

  // Step t: S(t) is issued, o rescaled, PV(t-1) issued, then the softmax
  // of S(t). With two warpgroups they take turns to issue (PP), so one's
  // softmax runs under the other's products.
  mbar_wait(qbar, 0);
  if (PP && wg == 1) named_arrive(1, NC);  // warpgroup 0 issues first
  {
    float s[NS];
    mbar_wait(&full[0], 0);
    if (PP) named_sync(1 + wg, NC);
    issue_s(s, 0);
    if (PP) named_arrive(2 - wg, NC);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(s, 0);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) a_frag(pf[kk], s, kk);
  }
  float sm0 = 0.f, sm1 = 0.f, sl0 = 0.f, sl1 = 0.f;  // source 0's m and l
  int pst = 0, st = 0, ph = 0;  // the stages of tiles t - 1 and t, t's phase
  for (int t = 1; t < nt; ++t) {
    pst = st;
    if (++st == stages) st = 0, ph ^= 1;
    if (t == n0) {  // the reference source starts from scratch
      sm0 = m0;
      sm1 = m1;
      sl0 = l0;
      sl1 = l1;
      m0 = m1 = -1e30f;
      l0 = l1 = 0.f;
    }
    float s[NS];
    mbar_wait(&full[st], ph);
    if (PP) named_sync(1 + wg, NC);
    issue_s(s, st);
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] *= (j & 2) ? corr1 : corr0;
    issue_pv(pst);
    if (PP) named_arrive(2 - wg, NC);
    wgmma_wait<1>();  // S(t) has landed; PV(t-1) may still run
    fence_regs(s);
    softmax(s, t);
    wgmma_wait<0>();  // PV(t-1) has landed: o, pf and its stage are free
    fence_regs(o);
    if ((tid & 127) == 0) mbar_arrive(&empty[pst]);
    if (t == n0) {  // source 0 is complete
      finish(0, true, sm0, sm1, sl0, sl1);
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) a_frag(pf[kk], s, kk);
  }
  if (PP) named_sync(1 + wg, NC);
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j] *= (j & 2) ? corr1 : corr0;
  issue_pv(st);
  if (PP) named_arrive(2 - wg, NC);
  wgmma_wait<0>();
  fence_regs(o);
  finish(nt > n0 ? 1 : 0, false, m0, m1, l0, l1);
  if (PP && wg == 0) named_sync(1, NC);  // the last turn warpgroup 1 handed over
}

// ---------------------------------------------------------------------------
// fp32 (parity mode): SIMT, a warp per query row, D over the lanes
// ---------------------------------------------------------------------------

template <int DPL, bool RES>
__global__ void __launch_bounds__(NTH) flash_fwd_f32(const FlashArgs a) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (NTH / 32) + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z, D = a.D;
  if (qi >= a.Sq) return;
  const float* qrow = static_cast<const float*>(a.q) + b * a.st[0][0] +
                      (long long)qi * a.st[0][1] + h * a.st[0][2];
  float qv[DPL], res[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? qrow[d] : 0.f;
    res[i] = 0.f;
  }
  const float s_ref = a.kr != nullptr ? a.ref_scale[b] : 0.f;
  const int nsrc_all = a.kr != nullptr ? 2 : 1;
  const int nsrc = (RES || s_ref != 0.f) ? nsrc_all : 1;
  for (int src = 0; src < nsrc; ++src) {
    const int ik = src == 0 ? 1 : 3, iv = ik + 1;
    const float* kb = static_cast<const float*>(src == 0 ? a.k : a.kr) +
                      b * a.st[ik][0] + h * a.st[ik][2];
    const float* vb = static_cast<const float*>(src == 0 ? a.v : a.vr) +
                      b * a.st[iv][0] + h * a.st[iv][2];
    const int Skv = src == 0 ? a.Skv : a.Skv_ref;
    float m = -1e30f, l = 0.f, acc[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
    for (int j = 0; j < Skv; ++j) {
      const float* kj = kb + (long long)j * a.st[ik][1];
      const float* vj = vb + (long long)j * a.st[iv][1];
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) p += qv[i] * kj[d];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      p *= a.scale_log2;
      const float mn = fmaxf(m, p);
      const float corr = exp2f(m - mn), e = exp2f(p - mn);
      l = l * corr + e;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        acc[i] = acc[i] * corr + (d < D ? e * vj[d] : 0.f);
      }
      m = mn;
    }
    if (RES) {
      if (lane == 0)
        a.lse[((long long)(b * a.H + h) * nsrc_all + src) * a.Sq + qi] = m + log2f(l);
      const float inv = 1.f / l, w = src == 0 ? 1.f : s_ref;
      float* o2row = src == 1 ? static_cast<float*>(a.o2) + b * a.st[6][0] +
                                    (long long)qi * a.st[6][1] + h * a.st[6][2]
                              : nullptr;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        const float on = acc[i] * inv;
        if (o2row != nullptr && d < D) o2row[d] = on;
        res[i] += w * on;
      }
    } else {
      const float w = (src == 0 ? 1.f : s_ref) / l;
#pragma unroll
      for (int i = 0; i < DPL; ++i) res[i] += w * acc[i];
    }
  }
  float* orow = static_cast<float*>(a.out) + b * a.st[5][0] +
                (long long)qi * a.st[5][1] + h * a.st[5][2];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) orow[d] = res[i];
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int DN, int DK, int BKV, int WGS, bool RES>
int launch_wgmma(const FlashArgs& a, cudaStream_t st) {
  const bool dual = a.kr != nullptr;
  const size_t smem = fwd_smem(DN, DK, BKV, WGS, a.stages, dual);
  FwdMaps m;
  bool ok = make_bshd_map(&m.q, a.q, a.st[Q_], a.B, a.Sq, a.H, a.D, 64 * WGS, DK / 8) &&
            make_bshd_map(&m.k, a.k, a.st[K_], a.B, a.Skv, a.H, a.D, BKV, DK / 8) &&
            make_bshd_map(&m.v, a.v, a.st[V_], a.B, a.Skv, a.H, a.D, BKV, DN / 8);
  if (ok && dual)
    ok = make_bshd_map(&m.kr, a.kr, a.st[KR_], a.B, a.Skv_ref, a.H, a.D, BKV, DK / 8) &&
         make_bshd_map(&m.vr, a.vr, a.st[VR_], a.B, a.Skv_ref, a.H, a.D, BKV, DN / 8);
  if (!ok || a.stages < 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<DN, DK, BKV, WGS, RES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.Sq + 64 * WGS - 1) / (64 * WGS) * ((a.D + DN - 1) / DN);
  flash_fwd_wgmma<DN, DK, BKV, WGS, RES>
      <<<dim3(blocks, a.H, a.B), NTH * WGS + 32, smem, st>>>(a, m);
  return (int)cudaGetLastError();
}

// The plan's rows per block (64 * WGS) and keys per tile; 128-key tiles up
// to D = 80 only (registers).
template <int DN, bool RES>
int by_tiles(const FlashArgs& a, int rows, int bkv, cudaStream_t st) {
  constexpr int DK = contraction(DN);
  if (bkv == 64 && rows == 128) return launch_wgmma<DN, DK, 64, 2, RES>(a, st);
  if (bkv == 64 && rows == 64) return launch_wgmma<DN, DK, 64, 1, RES>(a, st);
  if constexpr (DN <= 80) {
    if (bkv == 128 && rows == 128) return launch_wgmma<DN, DK, 128, 2, RES>(a, st);
    if (bkv == 128 && rows == 64) return launch_wgmma<DN, DK, 128, 1, RES>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The N width of O += P V: the smallest instantiated width >= D (the
// columns past D read the zero-filled padding chunks and are not stored);
// above D = 160 (K1 only) blocks of 256 columns over a 512-wide contraction,
// 64 rows and 32-key tiles.
template <bool RES>
int by_width(const FlashArgs& a, int rows, int bkv, cudaStream_t st) {
  if (a.D <= 16) return by_tiles<16, RES>(a, rows, bkv, st);
  if (a.D <= 32) return by_tiles<32, RES>(a, rows, bkv, st);
  if (a.D <= 40) return by_tiles<40, RES>(a, rows, bkv, st);
  if (a.D <= 64) return by_tiles<64, RES>(a, rows, bkv, st);
  if (a.D <= 80) return by_tiles<80, RES>(a, rows, bkv, st);
  if (a.D <= 128) return by_tiles<128, RES>(a, rows, bkv, st);
  if (a.D <= 160) return by_tiles<160, RES>(a, rows, bkv, st);
  if constexpr (!RES) {
    if (a.D <= 512 && rows == 64 && bkv == 32) return launch_wgmma<256, 512, 32, 1, false>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int DPL, bool RES>
int launch_f32(const FlashArgs& a, cudaStream_t st) {
  dim3 grid((a.Sq + NTH / 32 - 1) / (NTH / 32), a.H, a.B);
  flash_fwd_f32<DPL, RES><<<grid, NTH, 0, st>>>(a);
  return (int)cudaGetLastError();
}

FlashArgs make_args(const void* q, const void* k, const void* v, const void* kr,
                    const void* vr, const float* ref_scale, void* out, float* lse, void* o2,
                    int B, int H, int Sq, int Skv, int Skv_ref, int D, const long long* strides,
                    int n_strided, float scale_log2, int stages) {
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.kr = kr; a.vr = vr;
  a.ref_scale = ref_scale; a.out = out; a.lse = lse; a.o2 = o2;
  a.B = B; a.H = H; a.Sq = Sq; a.Skv = Skv; a.Skv_ref = Skv_ref; a.D = D;
  a.stages = stages;
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = i < n_strided ? strides[i * 3 + j] : 0;
  a.scale_log2 = scale_log2;
  return a;
}

}  // namespace

// q k v kr vr: device pointers (kr vr null with one source); ref_scale: the
// (B,) fp32 vector or null; strides: (batch, seq, head) triples of q k v kr
// vr out (and o2); plan: rows per block, keys per tile and ring depth of
// the bf16 wgmma kernel (kernels/flash_attention.py:flash_plan), ignored
// in fp32. Each returns a CUDA error code; 1 (cudaErrorInvalidValue) for an
// unsupported D or plan.
#define FLASH_ARGS                                                            \
  const void *q, const void *k, const void *v, const void *kr, const void *vr, \
      const float *ref_scale, void *out, int B, int H, int Sq, int Skv,        \
      int Skv_ref, int D, const long long *strides, float scale_log2,          \
      const int *plan, void *stream

extern "C" int flash_fwd_bf16_launch(FLASH_ARGS) {
  const FlashArgs a = make_args(q, k, v, kr, vr, ref_scale, out, nullptr, nullptr, B, H, Sq,
                                Skv, Skv_ref, D, strides, 6, scale_log2, plan[2]);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || D > 512) return (int)cudaErrorInvalidValue;
  return by_width<false>(a, plan[0], plan[1], st);
}

extern "C" int flash_fwd_f32_launch(FLASH_ARGS) {
  const FlashArgs a = make_args(q, k, v, kr, vr, ref_scale, out, nullptr, nullptr, B, H, Sq,
                                Skv, Skv_ref, D, strides, 6, scale_log2, 0);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D <= 64) return launch_f32<2, false>(a, st);
  if (D <= 96) return launch_f32<3, false>(a, st);
  if (D <= 160) return launch_f32<5, false>(a, st);
  if (D <= 512) return launch_f32<16, false>(a, st);
  return (int)cudaErrorInvalidValue;
}

// Residual mode (K5): also lse (B, H, n_sources, Sq) and, with two sources,
// o2; `strides` holds 7 triples (the 7th is o2's, ignored without it).
extern "C" int flash_fwd_res_bf16_launch(FLASH_ARGS, float* lse, void* o2) {
  const FlashArgs a = make_args(q, k, v, kr, vr, ref_scale, out, lse, o2, B, H, Sq, Skv,
                                Skv_ref, D, strides, 7, scale_log2, plan[2]);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || D > 160) return (int)cudaErrorInvalidValue;
  return by_width<true>(a, plan[0], plan[1], st);
}

extern "C" int flash_fwd_res_f32_launch(FLASH_ARGS, float* lse, void* o2) {
  const FlashArgs a = make_args(q, k, v, kr, vr, ref_scale, out, lse, o2, B, H, Sq, Skv,
                                Skv_ref, D, strides, 7, scale_log2, 0);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D <= 64) return launch_f32<2, true>(a, st);
  if (D <= 96) return launch_f32<3, true>(a, st);
  if (D <= 160) return launch_f32<5, true>(a, st);
  return (int)cudaErrorInvalidValue;
}
