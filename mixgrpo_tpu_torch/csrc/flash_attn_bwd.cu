// Flash attention backward for Hopper, sm_90a: dq, dk, dv from the saved
// logsumexp, in three modes.
//
// Replaces the three TPU backward kernels of mixgrpo_tpu/ops/flash_attention.py:
//   `_dkv_kernel` (lines 123-183, call 522-547)        -> mode DKV
//   `_dq_kernel` (lines 257-295, call 554-570)         -> mode DQ
//   `_fused_bwd_kernel` (lines 186-254, call 478-505)  -> mode FUSED
// Contract, identical to the TPU kernels (q arrives pre-scaled by 1/sqrt(D),
// so dq is taken with respect to the scaled q and no scale appears here):
//   s  = q.k^T in f32, plus the optional (B, Sk) f32 key bias;
//   p  = exp(s - lse), set to 0 where key >= kv_len or query row >= S;
//   dv = p^T.do with p cast to the input dtype, f32 sums;
//   dp = do.v^T in f32; delta = rowsum(o * do) in f32;
//   ds = p * (dp - delta);
//   dk = ds^T.q and dq = ds.k with ds cast to the input dtype, f32 sums;
//   dq, dk, dv are written in the input dtype; the bias gets no gradient.
//
// Bound on an H100 at the update's shapes: operations.  DKV does 4 products,
// DQ 3 and FUSED 5, each 2*B*H*S*kv_len*D FLOP, against some 12 bytes of
// bf16 traffic per (row, d) element: hundreds of FLOP per byte at S = 2560,
// far above the card's ~295 FLOP/byte ridge.  So every product runs on the
// tensor cores and no S x Sk matrix ever reaches device memory.  At H = 24,
// D = 128 and 989 TFLOP/s: DKV's bound is 1.055 ms and DQ's 0.791 ms at
// B = 2, S = 4608, and FUSED's 2.421 ms at B = 12, S = 2560, kv_len = 2537.
//
// Every mode starts with a pre-pass (`bwd_stats_kernel`) that writes, per
// 64-row q tile, the 64 values lse*log2(e) and the 64 values delta =
// rowsum(o * do) into an f32 scratch buffer that the wrapper allocates; rows
// past S get lse = +inf, so their p is exactly 0 with no compare.
//
// DKV and FUSED (`flash_bwd_kernel<D, kFused>`, wgmma fed by a TMA ring; the
// FA3-style dk/dv and dq/dk/dv passes): one block per (batch*head, 128-key
// tile), warp-specialised as the forward: one producer warpgroup (setmaxnreg
// 24) and two consumer
// warpgroups (240), each owning 64 keys and keeping their dk and dv rows in
// f32 registers (64 + 64 a thread at D = 128).  One lane of the producer
// loads the block's K and V tiles once and walks the 64-row tiles of q and
// do, with their 512 bytes of lse and delta (one bulk copy), through a
// 3-stage ring with full/empty mbarriers; both consumer warpgroups read every
// stage.  Per q tile, four wgmma products:
//   (1) s^T = k.q^T, m64n64k16 with k and q both K-major in shared memory;
//   (2) dp^T = v.do^T, the same, issued before the softmax of (1) so that
//       the two overlap;
//   (3) dv += p^T.do, m64nDk16 with p^T from registers (the s^T accumulator
//       packed to bf16 is wgmma's A fragment) and do read MN-major;
//   (4) dk += ds^T.q, the same with q read MN-major.
// lse and delta are indexed by the accumulator's column (query): each
// thread reads its 16 columns' values from the stage with 8-byte shared
// loads.  Key masks are per row of s^T: each thread folds the key bias
// (times log2 e) or -inf past kv_len into one additive term per key row,
// so p = ex2(s*log2e + kadd - lse*log2e) has no compare on any tile.
// Key tiles at or past kv_len load nothing, store zeros to dk and dv (the
// outputs come from torch.empty) and add nothing to dq.  The tensor maps are
// 4-D over (D, S, H, B) with the byte strides the wrapper passes, so bhsd,
// bshd and projection views run one code path; TMA zero-fills rows past S
// or Sk.  dk and dv have no atomics: two launches on the same inputs give
// identical dk and dv.  166,456 B of shared memory at D = 128 (DKV).
// FUSED adds the fifth product per q tile:
//   (5) dq = ds.k over the block's 128 keys.  Each consumer warpgroup writes
//       its ds^T fragment (64 keys x 64 queries, the bf16 A fragments of (4))
//       into one shared 128 x 64 tile, swizzled as TMA would write it and
//       double-buffered over q tiles; the two warpgroups meet at a named
//       barrier (the producer warpgroup is elsewhere), and each then runs
//       m64n(D/2)k16 x 8 over its own D/2 columns of dq, with ds read
//       MN-major from the ds^T tile (the transpose bit of A) and k MN-major
//       from the resident K tile.  It is issued right behind (4), so the
//       wait at the barrier overlaps (4); its 32 accumulators at D = 128 are
//       live only after s^T and dp^T are dead (beside dk, dv and the A
//       fragments of (3) and (4): 192 values a thread).
// dq is summed across key blocks in f32: each warpgroup stages its 64 x D/2
// partial in shared memory (swizzled as TMA reads it) and one of its threads
// adds the tile to the wrapper's zeroed f32 buffer with a TMA reduce-add
// (cp.reduce.async.bulk.tensor, add.f32) through a map over (D, S, H, B)
// like the inputs'; TMA skips rows past S.  That thread waits for the
// reduce to read the staging tile (cp.async.bulk.wait_group.read) a q tile
// later, before the barrier after which the tile is written again.
// blockIdx.x is the key tile, so the key blocks of one (batch, head) run
// together and their dq rows stay in L2 while they are summed.  The order of
// the reduce-adds changes from run to run, so FUSED's dq reproduces only to
// f32 rounding before its cast to bf16; dk and dv stay bit-identical.
// 231,992 B of shared memory at D = 128 (of the 232,448 a block may have).
// Against the limits of the mma.sync design both modes replaced (4 warps,
// 64-key blocks, 32-row q steps):
// (1) mma.sync -> wgmma; (2) operands loaded through registers with two
// __syncthreads per q tile -> TMA from one thread, overlapped with compute
// through the ring; (3) scalar 32-bit fragment loads -> wgmma reads each
// operand from swizzled shared memory; (4) delta recomputed from o by every
// key block (72 reads of each o row at S = 4608) -> computed once by the
// pre-pass; (5) the q-row and kv_len compares on every element -> folded
// into lse and the per-key term; (6) FUSED's dq added by one scalar f32
// atomicAdd per element, 16 columns at a time -> one TMA reduce-add per
// 64 x 32 f32 box.
//
// DQ (`flash_bwd_dq_kernel<D>`, wgmma fed by a TMA ring over key tiles; the
// forward's orientation: q rows stay, keys stream past).  Its pre-pass writes
// the stats of two 64-row q tiles per block (an even tile count; rows past S
// as above), then (`key_term_kernel`) one additive term per key, padded to
// whole 64-key tiles: log2(e) * bias, 0, or -inf past kv_len.  Then one
// block per (batch*head, 128-row q tile), blockIdx.x the q tile: one
// producer warpgroup (setmaxnreg 24) and two consumer warpgroups (240) of 64
// q rows each, which keep their dq rows in f32 registers (64 a thread at
// D = 128).  One lane of the producer loads the block's Q and dO tiles and
// their 1 KB of stats once, then walks the 64-key tiles of K and V below
// kv_len, each with its 256 bytes of key terms (one bulk copy), through a
// 4-stage ring with full/empty mbarriers; both consumer warpgroups read every
// stage.  Each thread reads the lse*log2e and delta of its two rows into
// registers once.  Per key tile, three wgmma products:
//   (1) s = q.k^T, m64n64k16 with q and k both K-major in shared memory;
//   (2) dp = do.v^T, the same, issued right behind (1), so that it runs
//       under the softmax of (1);
//   (3) dq += ds.k, m64nDk16 with ds from registers (the s accumulator, now
//       p (dp - delta), packed to bf16 is wgmma's A fragment) and k read
//       MN-major from the same resident stage.
// p = ex2(s*log2e + kterm - lse*log2e) takes each thread's 16 key terms of
// the tile from the stage (8-byte shared loads), so no tile compares.  The
// stage goes back to the producer once (3) is done; the two consumer
// warpgroups run unsynchronised, so one's softmax overlaps the other's
// products.  dq is written once, in bf16, from registers through its element
// strides; rows past S are skipped.  No atomics: two launches give identical
// dq.  199,752 B of shared memory at D = 128.
// Against the limits of the mma.sync design it replaced (4 warps per 64-row
// q tile, 64-key tiles): (1) mma.sync m16n8k16 -> wgmma; (2) K and V loaded
// through registers into padded tiles with two __syncthreads per key tile
// and nothing in flight -> TMA from one thread through a 4-stage ring;
// (3) fragments read by scalar 32-bit shared loads and ldmatrix.trans ->
// wgmma reads q, do, k and v from swizzled shared memory, k both ways; (4)
// delta recomputed from o by every q block -> read from the pre-pass; (5) a
// kv_len compare and a bias load on every element -> one additive term per
// key from the stage.
//
// Plain C interface for ctypes: flash_attn_bwd(mode, ...) launches on
// `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError(), or kEncodeError + the CUresult when a tensor map
// cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using M = Mma<bf16>;

enum Mode { kDkv = 0, kFused = 1, kDq = 2 };

struct Ax {
  int64_t b, h, s;  // element strides of the batch, head, sequence axes
};

struct Args {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;    // (B, H, S), contiguous
  const float* kbias;  // (B, Sk), contiguous, or null
  void* dq;            // bf16 (DQ) or the f32 accumulator (FUSED)
  bf16 *dk, *dv;
  Ax ao, ado, adq, adk, adv;
  int H, S, Sk, kv_len;
};

// ---- the stats pre-pass; DKV and FUSED: wgmma fed by a TMA ring ----------------------

constexpr int kWgKeys = 64;                          // keys per consumer warpgroup
constexpr int kWgConsumers = 2;                      // consumer warpgroups
constexpr int kWgBlockN = kWgKeys * kWgConsumers;    // keys per block
constexpr int kWgBlockM = 64;                        // q rows per ring stage
constexpr int kWgStages = 3;                         // depth of the q/do ring
constexpr int kWgConsumerThreads = 128 * kWgConsumers;
constexpr int kWgThreads = kWgConsumerThreads + 128;  // + the producer warpgroup
constexpr int kStatBytes = 2 * kWgBlockM * 4;        // lse*log2e and delta of a q tile
constexpr int kStatsThreads = 256;                   // threads of a pre-pass block
constexpr int kBarConsumers = 1;                     // named barrier of both consumer warpgroups
constexpr int kBarWarpgroup = 2;                     // + wg: named barrier of one of them

template <int D>
using KTile = Tile<D, kWgBlockN>;  // K and V: 128 rows
template <int D>
using QTile = Tile<D, kWgBlockM>;  // q and do: 64 rows
using DsTile = Tile<kWgBlockM, kWgBlockN>;  // FUSED's ds^T: 128 keys x 64 queries
template <int D>
using DqTile = F32Tile<D / 2, kWgBlockM>;  // one warpgroup's f32 dq partial

template <int D, bool kFused>
constexpr int bwd_smem_bytes() {
  // 1024 bytes of slack to align the tiles to the swizzle atom, then K, V,
  // q[stages], do[stages], FUSED's ds^T[2] and dq staging tiles, the stats
  // of each stage, then the barriers
  return 1024 + 2 * KTile<D>::kBytes + 2 * kWgStages * QTile<D>::kBytes +
         (kFused ? 2 * DsTile::kBytes + kWgConsumers * DqTile<D>::kBytes : 0) +
         kWgStages * kStatBytes + 8 * (1 + 2 * kWgStages);
}

struct BwdArgs {
  const float* kbias;  // (B, Sk), contiguous, or null
  const float* stats;  // (B*H, n_qt, 2, kWgBlockM): lse*log2e, then delta
  bf16 *dk, *dv;
  Ax adk, adv;
  int H, Sk, kv_len, n_qt;
};

// The pre-pass: for every q row of every (batch, head), lse*log2e and delta
// = rowsum(o * do) (f32) into the stats layout the ring loads, 64 rows of
// each per q tile; rows at or past S (the last tile's tail) get lse = +inf
// and delta = 0.  D/8 lanes share a row, 16 bytes of o and do each.
template <int D>
__global__ void __launch_bounds__(kStatsThreads)
    bwd_stats_kernel(const Args a, float* __restrict__ stats, int n_qt) {
  constexpr int kLanes = D / 8;
  constexpr int kRows = kStatsThreads / kLanes;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int row = blockIdx.x * kRows + threadIdx.x / kLanes;
  const int c = threadIdx.x % kLanes;
  float acc = 0.f;
  if (row < a.S) {
    const uint4 ov =
        *reinterpret_cast<const uint4*>(a.o + b * a.ao.b + h * a.ao.h + row * a.ao.s + c * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(a.dout + b * a.ado.b + h * a.ado.h +
                                                     row * a.ado.s + c * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(o2[e]);
      const float2 df = __bfloat1622float2(d2[e]);
      acc += of.x * df.x + of.y * df.y;
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (c == 0) {
    float* tile = stats + (static_cast<int64_t>(bh) * n_qt + row / kWgBlockM) * (2 * kWgBlockM);
    tile[row % kWgBlockM] =
        row < a.S ? a.lse[static_cast<int64_t>(bh) * a.S + row] * kLog2e : INFINITY;
    tile[kWgBlockM + row % kWgBlockM] = acc;
  }
}

// threadIdx.x, read afresh where it is called: what FUSED derives from it
// is then computed at its use instead of being held in registers through
// the loop's peak (dk, dv, s^T, dp^T and p^T live together), where the
// consumers have no register to spare.
__device__ __forceinline__ int tid_now() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

template <int D, bool kFused>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdq, const BwdArgs a) {
  using KT = KTile<D>;
  using QT = QTile<D>;
  using DT = DqTile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base;
  const uint32_t sv = sk + KT::kBytes;
  const uint32_t sq = sv + KT::kBytes;                 // + stage * QT::kBytes
  const uint32_t sdo = sq + kWgStages * QT::kBytes;    // + stage * QT::kBytes
  const uint32_t sds = sdo + kWgStages * QT::kBytes;   // FUSED: + (qt & 1) * DsTile::kBytes
  const uint32_t sdq = sds + (kFused ? 2 * DsTile::kBytes : 0);  // FUSED: + wg * DT::kBytes
  const uint32_t sstat = sdq + (kFused ? kWgConsumers * DT::kBytes : 0);  // + stage * kStatBytes
  const uint32_t kv_full = sstat + kWgStages * kStatBytes;
  const uint32_t full = kv_full + 8;                   // + 8 * stage
  const uint32_t empty = full + 8 * kWgStages;         // + 8 * stage

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int k0 = blockIdx.x * kWgBlockN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // key tiles at or past kv_len load nothing and store zeros
  const int n_qt = k0 < a.kv_len ? a.n_qt : 0;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kWgConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kWgConsumerThreads / 32) {
    // ---- producer warpgroup: gives up registers; one lane issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kWgConsumerThreads / 32 && lane == 0 && n_qt > 0) {
      mbar_expect_tx(kv_full, 2 * KT::kBytes);
#pragma unroll
      for (int p = 0; p < KT::kParts; ++p) {
        tma_load(sk + p * KT::kPartBytes, &tk, p * KT::kBox, k0, h, b, kv_full);
        tma_load(sv + p * KT::kPartBytes, &tv, p * KT::kBox, k0, h, b, kv_full);
      }
      const float* stats = a.stats + static_cast<int64_t>(bh) * a.n_qt * (2 * kWgBlockM);
      for (int qt = 0; qt < n_qt; ++qt) {
        const int st = qt % kWgStages;
        mbar_wait(empty + 8 * st, ((qt / kWgStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, 2 * QT::kBytes + kStatBytes);
#pragma unroll
        for (int p = 0; p < QT::kParts; ++p) {
          tma_load(sq + st * QT::kBytes + p * QT::kPartBytes, &tq, p * QT::kBox,
                   qt * kWgBlockM, h, b, bar);
          tma_load(sdo + st * QT::kBytes + p * QT::kPartBytes, &tdo, p * QT::kBox,
                   qt * kWgBlockM, h, b, bar);
        }
        bulk_load(sstat + st * kStatBytes, stats + qt * (2 * kWgBlockM), kStatBytes, bar);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each, sharing every q/do stage ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int g = lane >> 2;   // row group of the accumulator fragments
  const int tig = lane & 3;  // thread within the group
  // consumer warp w holds keys 16w + g and 16w + g + 8 of the block
  const int key0 = k0 + warp * 16 + g;
  constexpr int kDqCols = D / 2;  // FUSED: dq columns per warpgroup

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n_qt > 0) {
    // this thread's two key rows: log2(e) * bias, or -inf past kv_len
    float kadd[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key0 + 8 * half;
      kadd[half] = key >= a.kv_len ? -INFINITY
                   : a.kbias != nullptr
                       ? a.kbias[static_cast<int64_t>(b) * a.Sk + key] * kLog2e
                       : 0.f;
    }
    const uint32_t sk_wg = sk + wg * kWgKeys * KT::kRowBytes;  // this warpgroup's keys
    const uint32_t sv_wg = sv + wg * kWgKeys * KT::kRowBytes;
    const float* stat_s = reinterpret_cast<const float*>(smem_raw + (sstat - raw));

    mbar_wait(kv_full, 0);
    for (int qt = 0; qt < n_qt; ++qt) {
      const int st = qt % kWgStages;
      const uint32_t q_st = sq + st * QT::kBytes;
      const uint32_t do_st = sdo + st * QT::kBytes;
      const float* lse_st = stat_s + st * (2 * kWgBlockM);
      const float* delta_st = lse_st + kWgBlockM;
      mbar_wait(full + 8 * st, (qt / kWgStages) & 1);

      // (1) s^T = k.q^T and (2) dp^T = v.do^T, two groups in flight
      float s[kWgBlockM / 2], dp[kWgBlockM / 2];
#pragma unroll
      for (int i = 0; i < kWgBlockM / 2; ++i) s[i] = dp[i] = 0.f;
      fence_operands(s);
      fence_operands(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, kmajor_desc<KT>(sk_wg, kk), kmajor_desc<QT>(q_st, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, kmajor_desc<KT>(sv_wg, kk), kmajor_desc<QT>(do_st, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_operands(s);

      // p^T = exp(s^T + bias - lse): s[4j + 2*half + e] is key row g + 8*half,
      // query column 8j + 2*tig + e
#pragma unroll
      for (int j = 0; j < kWgBlockM / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_st + 8 * j + 2 * tig);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          s[4 * j + 2 * half] = ex2(fmaf(s[4 * j + 2 * half], kLog2e, kadd[half] - l.x));
          s[4 * j + 2 * half + 1] =
              ex2(fmaf(s[4 * j + 2 * half + 1], kLog2e, kadd[half] - l.y));
        }
      }
      // p^T in bf16: the accumulators of column blocks 2t and 2t + 1 are the
      // A fragment of k16 step t
      uint32_t pa[kWgBlockM / 16][4];
#pragma unroll
      for (int t = 0; t < kWgBlockM / 16; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[t][i] = M::pack(s[8 * t + 2 * i], s[8 * t + 2 * i + 1]);

      // (3) dv += p^T.do
      fence_operands(dv);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kWgBlockM / 16; ++t)
        WgmmaRS<D>::run(dv, pa[t], mnmajor_desc<QT>(do_st, t));
      wgmma_commit();
      wgmma_wait<1>();
      fence_operands(dp);

      // ds^T = p^T (dp^T - delta), in place of dp^T
#pragma unroll
      for (int j = 0; j < kWgBlockM / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(delta_st + 8 * j + 2 * tig);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          dp[4 * j + 2 * half] = s[4 * j + 2 * half] * (dp[4 * j + 2 * half] - dl.x);
          dp[4 * j + 2 * half + 1] = s[4 * j + 2 * half + 1] * (dp[4 * j + 2 * half + 1] - dl.y);
        }
      }
      uint32_t da[kWgBlockM / 16][4];
#pragma unroll
      for (int t = 0; t < kWgBlockM / 16; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) da[t][i] = M::pack(dp[8 * t + 2 * i], dp[8 * t + 2 * i + 1]);

      const uint32_t ds_buf = sds + (qt & 1) * DsTile::kBytes;
      if constexpr (kFused) {
        // ds^T into the shared tile for (5), before (4) reads the same
        // fragments: da[t][i] is key row g + 8*(i & 1) of this warp, queries
        // 16t + 8*(i >> 1) + 2*tig and + 1, i.e. 16-byte chunk 2t + (i >> 1)
        // of the row, which the swizzle puts at chunk ^ (row % 8) = chunk ^ g
        const uint32_t row = ds_buf + (warp * 16 + g) * DsTile::kRowBytes + 4 * tig;
#pragma unroll
        for (int t = 0; t < kWgBlockM / 16; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            st_shared(row + (i & 1) * 8 * DsTile::kRowBytes + (((2 * t + (i >> 1)) ^ g) << 4),
                      da[t][i]);
      }

      // (4) dk += ds^T.q
      fence_operands(dk);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kWgBlockM / 16; ++t)
        WgmmaRS<D>::run(dk, da[t], mnmajor_desc<QT>(q_st, t));
      wgmma_commit();
      float dq[kFused ? kDqCols / 2 : 1];
      if constexpr (kFused) {
        // (5) dq = ds.k over the block's 128 keys, this warpgroup's D/2
        // columns, issued behind (4): the barrier's wait overlaps (4).  The
        // warpgroup's lead thread issues and waits for its reduce-adds.
        const int t5 = tid_now();
        if ((t5 & 127) == 0) bulk_wait_read();  // the last reduce-add has read the staging tile
        fence_proxy_async();                    // this thread's ds^T stores, for wgmma
        named_barrier_sync(kBarConsumers, kWgConsumerThreads);  // all of ds^T is in place
        const int c0 = t5 / 128 * kDqCols;
        const uint32_t sk_dq = sk + (c0 / KT::kBox) * KT::kPartBytes + (c0 % KT::kBox) * 2;
#pragma unroll
        for (int i = 0; i < kDqCols / 2; ++i) dq[i] = 0.f;
        fence_operands(dq);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < kWgBlockN / 16; ++t)
          WgmmaSST<kDqCols>::run(dq, mnmajor_desc<DsTile>(ds_buf, t), mnmajor_desc<KT>(sk_dq, t),
                                 t > 0);
        wgmma_commit();
        wgmma_wait<1>();  // (3) and (4) are done
      } else {
        wgmma_wait<0>();
      }
      fence_operands(dv);
      fence_operands(dk);
      fence_operands(pa);  // the A fragments stay live until their products are done
      fence_operands(da);
      mbar_arrive(empty + 8 * st);  // (5) reads no q or do

      if constexpr (kFused) {
        wgmma_wait<0>();
        fence_operands(dq);

        // the partial in f32, swizzled as TMA reads it: dq[4j + 2*half + e]
        // is q row 16*(warp % 4) + g + 8*half, column 8j + 2*tig + e
        const int t6 = tid_now();
        const uint32_t sdq_wg = sdq + t6 / 128 * DT::kBytes;
#pragma unroll
        for (int j = 0; j < kDqCols / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t o = (t6 / 32 % 4 * 16 + g + 8 * half) * DT::kRowBytes +
                               ((8 * j) % DT::kBox + 2 * tig) * 4;
            st_shared(sdq_wg + (8 * j) / DT::kBox * DT::kPartBytes +
                          swizzled<DT::kRowBytes>(o),
                      dq[4 * j + 2 * half], dq[4 * j + 2 * half + 1]);
          }
        fence_proxy_async();  // for the TMA read
        named_barrier_sync(kBarWarpgroup + t6 / 128, 128);
        if ((t6 & 127) == 0) {
#pragma unroll
          for (int p = 0; p < DT::kParts; ++p)
            tma_reduce_add(&tdq, sdq_wg + p * DT::kPartBytes, t6 / 128 * kDqCols + p * DT::kBox,
                           qt * kWgBlockM, h, b);
          bulk_commit();
        }
      }
    }
    // the staging tiles must outlive the last reduce-add's read
    if (kFused && (tid_now() & 127) == 0) bulk_wait();
  }

  bf16* dkb = a.dk + b * a.adk.b + h * a.adk.h;
  bf16* dvb = a.dv + b * a.adv.b + h * a.adv.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key0 + 8 * half;
    if (key >= a.Sk) continue;
    bf16* krow = dkb + key * a.adk.s + 2 * tig;
    bf16* vrow = dvb + key * a.adv.s + 2 * tig;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8) =
          M::pack(dk[4 * n + 2 * half], dk[4 * n + 2 * half + 1]);
      *reinterpret_cast<uint32_t*>(vrow + n * 8) =
          M::pack(dv[4 * n + 2 * half], dv[4 * n + 2 * half + 1]);
    }
  }
}

// ---- DQ: wgmma fed by a TMA ring over key tiles ------------------------------------------

constexpr int kDqBlockM = 64 * kWgConsumers;  // q rows per block, 64 per consumer warpgroup
constexpr int kDqBlockN = 64;                 // keys per ring stage
constexpr int kDqStages = 4;                  // depth of the k/v ring
constexpr int kTermBytes = kDqBlockN * 4;     // the key terms of a stage
constexpr int kDqStatTiles = kDqBlockM / kWgBlockM;  // stats tiles of a block

template <int D>
using DqQTile = Tile<D, kDqBlockM>;  // q and do: 128 rows
template <int D>
using DqKTile = Tile<D, kDqBlockN>;  // k and v: 64 rows

template <int D>
constexpr int dq_smem_bytes() {
  // 1024 bytes of slack to align the tiles to the swizzle atom, then q, do,
  // k[stages], v[stages], the block's stats, the key terms of each stage,
  // then the barriers
  return 1024 + 2 * DqQTile<D>::kBytes + 2 * kDqStages * DqKTile<D>::kBytes +
         kDqStatTiles * kStatBytes + kDqStages * kTermBytes + 8 * (1 + 2 * kDqStages);
}

struct DqArgs {
  const float* stats;  // (B*H, n_qt, 2, kWgBlockM), n_qt a multiple of kDqStatTiles
  const float* kterm;  // (B, n_kt * kDqBlockN)
  bf16* dq;
  Ax adq;
  int H, S, kv_len, n_qt, n_kt;
};

// DQ's key terms: for every key of every batch row, padded to whole key
// tiles, log2(e) * bias, 0 without a bias, or -inf at or past kv_len.
__global__ void __launch_bounds__(kDqBlockN)
    key_term_kernel(const float* __restrict__ kbias, float* __restrict__ kterm, int Sk,
                    int kv_len, int n_kt) {
  const int b = blockIdx.y;
  const int key = blockIdx.x * kDqBlockN + threadIdx.x;
  kterm[static_cast<int64_t>(b) * n_kt * kDqBlockN + key] =
      key >= kv_len     ? -INFINITY
      : kbias != nullptr ? kbias[static_cast<int64_t>(b) * Sk + key] * kLog2e
                         : 0.f;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const DqArgs a) {
  using QT = DqQTile<D>;
  using KT = DqKTile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sdo = sq + QT::kBytes;
  const uint32_t sk = sdo + QT::kBytes;                 // + stage * KT::kBytes
  const uint32_t sv = sk + kDqStages * KT::kBytes;      // + stage * KT::kBytes
  const uint32_t sstat = sv + kDqStages * KT::kBytes;   // + wg * kStatBytes
  const uint32_t sterm = sstat + kDqStatTiles * kStatBytes;  // + stage * kTermBytes
  const uint32_t q_full = sterm + kDqStages * kTermBytes;
  const uint32_t full = q_full + 8;                     // + 8 * stage
  const uint32_t empty = full + 8 * kDqStages;          // + 8 * stage

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = blockIdx.x * kDqBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // key tiles at or past kv_len are never loaded
  const int n_tiles = (a.kv_len + kDqBlockN - 1) / kDqBlockN;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kDqStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kWgConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kWgConsumerThreads / 32) {
    // ---- producer warpgroup: gives up registers; one lane issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kWgConsumerThreads / 32 && lane == 0) {
      mbar_expect_tx(q_full, 2 * QT::kBytes + kDqStatTiles * kStatBytes);
#pragma unroll
      for (int p = 0; p < QT::kParts; ++p) {
        tma_load(sq + p * QT::kPartBytes, &tq, p * QT::kBox, q0, h, b, q_full);
        tma_load(sdo + p * QT::kPartBytes, &tdo, p * QT::kBox, q0, h, b, q_full);
      }
      bulk_load(sstat,
                a.stats + (static_cast<int64_t>(bh) * a.n_qt + blockIdx.x * kDqStatTiles) *
                              (2 * kWgBlockM),
                kDqStatTiles * kStatBytes, q_full);
      const float* kterm = a.kterm + static_cast<int64_t>(b) * a.n_kt * kDqBlockN;
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kDqStages;
        mbar_wait(empty + 8 * st, ((kt / kDqStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, 2 * KT::kBytes + kTermBytes);
#pragma unroll
        for (int p = 0; p < KT::kParts; ++p) {
          tma_load(sk + st * KT::kBytes + p * KT::kPartBytes, &tk, p * KT::kBox,
                   kt * kDqBlockN, h, b, bar);
          tma_load(sv + st * KT::kBytes + p * KT::kPartBytes, &tv, p * KT::kBox,
                   kt * kDqBlockN, h, b, bar);
        }
        bulk_load(sterm + st * kTermBytes, kterm + kt * kDqBlockN, kTermBytes, bar);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 q rows each, sharing every k/v stage ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int g = lane >> 2;   // row group of the accumulator fragments
  const int tig = lane & 3;  // thread within the group
  // consumer warp w holds rows 16w + g and 16w + g + 8 of the block
  const int row0 = warp * 16 + g;
  const uint32_t sq_wg = sq + wg * 64 * QT::kRowBytes;  // this warpgroup's q and do rows
  const uint32_t sdo_wg = sdo + wg * 64 * QT::kRowBytes;
  const float* term_s = reinterpret_cast<const float*>(smem_raw + (sterm - raw));

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(q_full, 0);
  // lse*log2e and delta of this thread's two rows: row row0 % 64 of the
  // warpgroup's stats tile, and 8 rows on
  const float* stat_s =
      reinterpret_cast<const float*>(smem_raw + (sstat - raw + wg * kStatBytes));
  float lse2[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    lse2[half] = stat_s[row0 % 64 + 8 * half];
    delta[half] = stat_s[kWgBlockM + row0 % 64 + 8 * half];
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % kDqStages;
    const uint32_t k_st = sk + st * KT::kBytes;
    const uint32_t v_st = sv + st * KT::kBytes;
    const float* term_st = term_s + st * kDqBlockN;
    mbar_wait(full + 8 * st, (kt / kDqStages) & 1);

    // (1) s = q.k^T and (2) dp = do.v^T, two groups in flight
    float s[kDqBlockN / 2], dp[kDqBlockN / 2];
#pragma unroll
    for (int i = 0; i < kDqBlockN / 2; ++i) s[i] = dp[i] = 0.f;
    fence_operands(s);
    fence_operands(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc<QT>(sq_wg, kk), kmajor_desc<KT>(k_st, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, kmajor_desc<QT>(sdo_wg, kk), kmajor_desc<KT>(v_st, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(s);

    // p = exp(s + bias - lse), zero past kv_len: s[4j + 2*half + e] is row
    // row0 + 8*half, key 8j + 2*tig + e of the tile
#pragma unroll
    for (int j = 0; j < kDqBlockN / 8; ++j) {
      const float2 t = *reinterpret_cast<const float2*>(term_st + 8 * j + 2 * tig);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        s[4 * j + 2 * half] = ex2(fmaf(s[4 * j + 2 * half], kLog2e, t.x) - lse2[half]);
        s[4 * j + 2 * half + 1] = ex2(fmaf(s[4 * j + 2 * half + 1], kLog2e, t.y) - lse2[half]);
      }
    }
    wgmma_wait<0>();
    fence_operands(dp);

    // ds = p (dp - delta) in bf16: the accumulators of key blocks 2t and
    // 2t + 1 are the A fragment of k16 step t; da[t][i] is row half i & 1
    uint32_t da[kDqBlockN / 16][4];
#pragma unroll
    for (int t = 0; t < kDqBlockN / 16; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * t + 2 * i;
        const float dl = delta[i & 1];
        da[t][i] = M::pack(s[c] * (dp[c] - dl), s[c + 1] * (dp[c + 1] - dl));
      }

    // (3) dq += ds.k, k read MN-major from the resident stage
    fence_operands(dq);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kDqBlockN / 16; ++t)
      WgmmaRS<D>::run(dq, da[t], mnmajor_desc<KT>(k_st, t));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dq);
    fence_operands(da);  // the A fragments stay live until (3) is done
    mbar_arrive(empty + 8 * st);
  }

  // dq[4n + 2*half + e] is row row0 + 8*half, column 8n + 2*tig + e
  bf16* dqb = a.dq + b * a.adq.b + h * a.adq.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + row0 + 8 * half;
    if (row >= a.S) continue;
    bf16* drow = dqb + row * a.adq.s + 2 * tig;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8) =
          M::pack(dq[4 * n + 2 * half], dq[4 * n + 2 * half + 1]);
  }
}

// ---- host side ------------------------------------------------------------------------

// The stats pre-pass of every mode: lse*log2e and delta of n_qt 64-row q
// tiles of every (batch, head) into `stats`, (B*H, n_qt, 2, 64).
template <int D>
int launch_stats(const Args& a, float* stats, int n_qt, int B, cudaStream_t stream) {
  constexpr int kRows = kStatsThreads / (D / 8);  // divides kWgBlockM
  bwd_stats_kernel<D><<<dim3(n_qt * kWgBlockM / kRows, B * a.H), kStatsThreads, 0, stream>>>(
      a, stats, n_qt);
  return static_cast<int>(cudaGetLastError());
}

// Modes DKV and FUSED: the stats pre-pass, then the wgmma kernel, on one
// stream.  geom: seven int64 values for each of q, k, v and do in that order
// (the dims (D, S, H, B) and the byte strides of the S, H and B axes), and
// for FUSED seven more for the f32 dq accumulator; stats: the f32 scratch of
// (B*H, ceil(S / 64), 2, 64) values.
template <int D, bool kFused>
int launch_wgmma(const Args& a, const int64_t* geom, float* stats, int B,
                 cudaStream_t stream) {
  CUtensorMap maps[5];
  int err = encode<QTile<D>>(&maps[0], a.q, geom);
  if (err == 0) err = encode<KTile<D>>(&maps[1], a.k, geom + 7);
  if (err == 0) err = encode<KTile<D>>(&maps[2], a.v, geom + 14);
  if (err == 0) err = encode<QTile<D>>(&maps[3], a.dout, geom + 21);
  if (err == 0) {
    if (kFused)
      err = encode<DqTile<D>>(&maps[4], a.dq, geom + 28);
    else
      maps[4] = maps[0];  // DKV reads no dq map
  }
  if (err != 0) return err;
  const int n_qt = (a.S + kWgBlockM - 1) / kWgBlockM;
  err = launch_stats<D>(a, stats, n_qt, B, stream);
  if (err != 0) return err;
  const BwdArgs d{a.kbias, stats, a.dk, a.dv, a.adk, a.adv, a.H, a.Sk, a.kv_len, n_qt};
  // above the 48 KB default, so opt in (per device, per call: the call costs
  // far less than the launch)
  constexpr int smem = bwd_smem_bytes<D, kFused>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_kernel<D, kFused>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Sk + kWgBlockN - 1) / kWgBlockN, B * a.H);
  flash_bwd_kernel<D, kFused><<<grid, kWgThreads, smem, stream>>>(maps[0], maps[1], maps[2],
                                                                  maps[3], maps[4], d);
  return static_cast<int>(cudaGetLastError());
}

// Mode DQ: the stats pre-pass over a whole number of 128-row blocks, the key
// terms, then the wgmma kernel, on one stream.  geom as for DKV; scratch: the
// stats, (B*H, 2 * ceil(S / 128), 2, 64), then the key terms, (B, ceil(Sk /
// 64) * 64).
template <int D>
int launch_dq(const Args& a, const int64_t* geom, float* scratch, int B, cudaStream_t stream) {
  CUtensorMap maps[4];
  int err = encode<DqQTile<D>>(&maps[0], a.q, geom);
  if (err == 0) err = encode<DqKTile<D>>(&maps[1], a.k, geom + 7);
  if (err == 0) err = encode<DqKTile<D>>(&maps[2], a.v, geom + 14);
  if (err == 0) err = encode<DqQTile<D>>(&maps[3], a.dout, geom + 21);
  if (err != 0) return err;
  const int n_blocks = (a.S + kDqBlockM - 1) / kDqBlockM;
  const int n_qt = n_blocks * kDqStatTiles;
  const int n_kt = (a.Sk + kDqBlockN - 1) / kDqBlockN;
  float* kterm = scratch + static_cast<int64_t>(B) * a.H * n_qt * (2 * kWgBlockM);
  err = launch_stats<D>(a, scratch, n_qt, B, stream);
  if (err != 0) return err;
  key_term_kernel<<<dim3(n_kt, B), kDqBlockN, 0, stream>>>(a.kbias, kterm, a.Sk, a.kv_len,
                                                          n_kt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const DqArgs d{scratch, kterm, static_cast<bf16*>(a.dq), a.adq, a.H, a.S, a.kv_len, n_qt, n_kt};
  constexpr int smem = dq_smem_bytes<D>();
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_kernel<D><<<dim3(n_blocks, B * a.H), kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], d);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int mode, const Args& a, const int64_t* geom, float* scratch, int B,
           cudaStream_t stream) {
  if (mode == kDkv) return launch_wgmma<D, false>(a, geom, scratch, B, stream);
  if (mode == kFused) return launch_wgmma<D, true>(a, geom, scratch, B, stream);
  return launch_dq<D>(a, geom, scratch, B, stream);
}

int per_head_dim(int D, int d32, int d64, int d128) {
  return D == 32 ? d32 : D == 64 ? d64 : D == 128 ? d128 : -1;
}

}  // namespace

// mode 0 = DKV (dk, dv), 1 = FUSED (dk, dv, and dq added into the f32 buffer
// `dq`), 2 = DQ (dq in bf16).  `strides` holds (batch, head, sequence)
// element strides of o, do, dq, dk, dv in that order (15 values).  `geom` is
// the TMA geometry of q, k, v and do (28 int64), and for FUSED of the f32 dq
// after them (35; see launch_wgmma); every mode writes its pre-pass into
// `scratch` (see launch_wgmma and launch_dq).
extern "C" int flash_attn_bwd(int mode, const void* q, const void* k,
                              const void* v, const void* o, const void* dout,
                              const void* lse, const void* kbias, void* dq,
                              void* dk, void* dv, const int64_t* strides,
                              const int64_t* geom, void* scratch, int B,
                              int H, int S, int Sk, int D, int kv_len,
                              void* stream) {
  if (mode < kDkv || mode > kDq || geom == nullptr || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.kbias = static_cast<const float*>(kbias);
  a.dq = dq;
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  Ax* axes[5] = {&a.ao, &a.ado, &a.adq, &a.adk, &a.adv};
  for (int i = 0; i < 5; ++i)
    *axes[i] = Ax{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.H = H;
  a.S = S;
  a.Sk = Sk;
  a.kv_len = kv_len;
  float* sc = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(mode, a, geom, sc, B, st);
    case 64:
      return launch<64>(mode, a, geom, sc, B, st);
    case 128:
      return launch<128>(mode, a, geom, sc, B, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one block of each mode at head dim D, in bytes
// (-1 for a head dim the kernels do not take); read by reports, never by a
// launch.
extern "C" int flash_attn_bwd_dkv_smem_bytes(int D) {
  return per_head_dim(D, bwd_smem_bytes<32, false>(), bwd_smem_bytes<64, false>(),
                      bwd_smem_bytes<128, false>());
}
extern "C" int flash_attn_bwd_fused_smem_bytes(int D) {
  return per_head_dim(D, bwd_smem_bytes<32, true>(), bwd_smem_bytes<64, true>(),
                      bwd_smem_bytes<128, true>());
}
extern "C" int flash_attn_bwd_dq_smem_bytes(int D) {
  return per_head_dim(D, dq_smem_bytes<32>(), dq_smem_bytes<64>(), dq_smem_bytes<128>());
}
