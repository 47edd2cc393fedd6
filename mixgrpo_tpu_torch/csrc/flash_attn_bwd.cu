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
// tensor cores and no S x Sk matrix ever reaches device memory.  At B = 2,
// S = 4608, H = 24, D = 128, DKV's bound is 1.055 ms at 989 TFLOP/s.
//
// DKV (`flash_dkv_kernel`, wgmma fed by a TMA ring; the FA3-style dk/dv
// pass).  A pre-pass (`dkv_stats_kernel`) writes, per 64-row q tile, the 64
// values lse*log2(e) and the 64 values delta = rowsum(o * do) into an f32
// scratch buffer that the wrapper allocates; rows past S get lse = +inf, so
// their p is exactly 0 with no compare.  Then one block per (batch*head,
// 128-key tile), warp-specialised as the forward: one producer warpgroup
// (setmaxnreg 24) and two consumer warpgroups (240), each owning 64 keys and
// keeping their dk and dv rows in f32 registers (64 + 64 a thread at D =
// 128).  One lane of the producer loads the block's K and V tiles once and
// walks the 64-row tiles of q and do, with their 512 bytes of lse and delta
// (one bulk copy), through a 3-stage ring with full/empty mbarriers; both
// consumer warpgroups read every stage.  Per q tile, four wgmma products:
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
// Key tiles at or past kv_len load nothing and store zeros (the outputs come
// from torch.empty).  The tensor maps are 4-D over (D, S, H, B) with the
// byte strides the wrapper passes, so bhsd, bshd and projection views run
// one code path; TMA zero-fills rows past S or Sk.  There are no atomics:
// two launches on the same inputs give identical dk and dv.
// Against the limits of the mma.sync design it replaced (4 warps, 64-key
// blocks, 32-row q steps): (1) mma.sync -> wgmma; (2) operands loaded
// through registers with two __syncthreads per q tile -> TMA from one
// thread, overlapped with compute through the ring; (3) scalar 32-bit
// fragment loads -> wgmma reads each operand from swizzled shared memory;
// (4) delta recomputed from o by every key block (72 reads of each o row at
// S = 4608) -> computed once by the pre-pass; (5) the q-row and kv_len
// compares on every element -> folded into lse and the per-key term.
//
// FUSED (`flash_bwd_dkv_kernel<D, true>`, mma.sync): one block of 4 warps
// per (batch*head, 64-key tile); each warp owns 16 keys and keeps their f32
// dk and dv rows in registers (2 x 16 x D / 32 lanes = 128 floats a thread
// at D = 128, the register budget that fixes the tile sizes).  K and V stay
// in shared memory; a loop walks 32-row q tiles (q, do, lse, and delta from
// the o tile, staged in shared memory).  The scores are computed
// transposed, s^T = k.q^T, so that every product of the loop keeps its
// operand in registers: p^T is the A fragment of dv += p^T.do, ds^T the A
// fragment of dk += ds^T.q, and do and q enter as B through ldmatrix.trans.
// For dq = ds.k, ds^T goes through shared memory as bf16 (read back
// transposed by ldmatrix), each warp forms a 16 x D/2 slice of the tile's dq
// partial, 16 columns at a time (more would not fit beside dk and dv: at D =
// 128 the whole slice spilled), and adds it with f32 atomicAdd into a (B, H,
// S, D)-shaped f32 buffer that the wrapper zeroes and casts.  The atomics'
// order changes from run to run, so FUSED's dq is reproducible only to f32
// rounding before its cast to bf16.  Key tiles at or past kv_len skip the
// loop and store zeros.
//
// DQ (`flash_bwd_dq_kernel`, mma.sync): one block of 4 warps per
// (batch*head, 64-row q tile), each warp 16 rows with f32 dq rows in
// registers; a loop walks the 64-key tiles below kv_len (K and V in shared
// memory), recomputes s and p in the forward's orientation, and dp =
// do.v^T; ds is the A fragment of dq += ds.k, k entering as B through
// ldmatrix.trans.
//
// FUSED and DQ take element strides (in elements) for the batch, head and
// sequence axes of every tensor, so (B, H, S, D) and (B, S, H, D) run the
// same code with no transposes; the last axis must be contiguous.  Their
// ragged S and Sk tails are handled with predicates.
//
// Plain C interface for ctypes: flash_attn_bwd(mode, ...) launches on
// `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError(), or kEncodeError + the CUresult when a tensor map of
// mode DKV cannot be encoded.

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

constexpr int kThreads = 128;  // 4 warps (FUSED and DQ)
constexpr int kDkvBlockK = 64;  // keys per FUSED block, 16 per warp
constexpr int kDkvBlockQ = 32;  // q rows per step of the FUSED loop
constexpr int kDqBlockQ = 64;   // q rows per DQ block, 16 per warp
constexpr int kDqBlockK = 64;   // keys per step of the DQ loop

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
  Ax aq, ak, av, ao, ado, adq, adk, adv;
  int H, S, Sk, kv_len;
};

// rows [r0, r0 + ROWS) of one head's (rows, D) matrix into a padded shared
// tile; rows at or past n load as zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t rs, int r0, int n, int tid) {
  constexpr int LD = D + 8;
  constexpr int kChunks = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = tid; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = zero;
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

// lse and delta = rowsum(o * do) (f32) of q rows [q0, q0 + ROWS); rows at or
// past S get 0.  kThreads / ROWS consecutive lanes share a row.
template <int D, int ROWS>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const Args& a, const bf16* ob,
                                               const bf16* dob, int bh, int q0,
                                               int tid) {
  constexpr int kPer = kThreads / ROWS;
  const int r = tid / kPer;
  const int part = tid % kPer;
  const int row = q0 + r;
  float acc = 0.f;
  if (row < a.S) {
    for (int c = part; c < D / 8; c += kPer) {
      const uint4 ov = *reinterpret_cast<const uint4*>(ob + row * a.ao.s + c * 8);
      const uint4 dv = *reinterpret_cast<const uint4*>(dob + row * a.ado.s + c * 8);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(o2[e]);
        const float2 df = __bfloat1622float2(d2[e]);
        acc += of.x * df.x + of.y * df.y;
      }
    }
  }
#pragma unroll
  for (int off = 1; off < kPer; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) {
    delta_s[r] = acc;
    lse_s[r] = row < a.S ? a.lse[static_cast<int64_t>(bh) * a.S + row] : 0.f;
  }
}

template <int D, bool kIsFused>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  constexpr int LD = D + 8;
  constexpr int BK = kDkvBlockK;
  constexpr int BQ = kDkvBlockQ;
  constexpr int LDS = BQ + 8;  // row of the bf16 ds^T tile (FUSED)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * LD;
  bf16* Qs = Vs + BK * LD;
  bf16* dOs = Qs + BQ * LD;
  bf16* dSs = dOs + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dSs + (kIsFused ? BK * LDS : 0));
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int mi = lane >> 3;
  const int rr = lane & 7;
  const int kr0 = warp * 16;  // this warp's first key row in the tile

  const bf16* qb = a.q + b * a.aq.b + h * a.aq.h;
  const bf16* kb = a.k + b * a.ak.b + h * a.ak.h;
  const bf16* vb = a.v + b * a.av.b + h * a.av.h;
  const bf16* ob = a.o + b * a.ao.b + h * a.ao.h;
  const bf16* dob = a.dout + b * a.ado.b + h * a.ado.h;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  if (k0 < a.kv_len) {
    load_tile<D, BK>(Ks, kb, a.ak.s, k0, a.Sk, tid);
    load_tile<D, BK>(Vs, vb, a.av.s, k0, a.Sk, tid);
    bool kvalid[2];
    float kadd[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = k0 + kr0 + g + 8 * half;
      kvalid[half] = key < a.kv_len;
      kadd[half] = (a.kbias != nullptr && kvalid[half])
                       ? a.kbias[static_cast<int64_t>(b) * a.Sk + key]
                       : 0.f;
    }

    for (int q0 = 0; q0 < a.S; q0 += BQ) {
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<D, BQ>(Qs, qb, a.aq.s, q0, a.S, tid);
      load_tile<D, BQ>(dOs, dob, a.ado.s, q0, a.S, tid);
      load_row_stats<D, BQ>(lse_s, delta_s, a, ob, dob, bh, q0, tid);
      __syncthreads();

      // s^T = k.q^T: this warp's 16 keys x BQ queries.
      float p[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const bf16* pa = Ks + (kr0 + g) * LD + kk * 16 + 2 * tig;
          const uint32_t af[4] = {lds32(pa), lds32(pa + 8 * LD), lds32(pa + 8),
                                  lds32(pa + 8 * LD + 8)};
          const bf16* pb = Qs + (j * 8 + g) * LD + kk * 16 + 2 * tig;
          const uint32_t bf[2] = {lds32(pb), lds32(pb + 8)};
          M::run(p[j], af, bf);
        }
      }
      // p^T = exp(s^T + bias - lse), zero for invalid keys or rows.
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = j * 8 + 2 * tig + (i & 1);
          const int half = i >> 1;
          const bool valid = kvalid[half] && (q0 + qc < a.S);
          p[j][i] = valid ? __expf(p[j][i] + kadd[half] - lse_s[qc]) : 0.f;
        }
      }
      // dv += p^T.do (p in bf16), k16 steps over the q tile.
#pragma unroll
      for (int t = 0; t < BQ / 16; ++t) {
        const uint32_t af[4] = {M::pack(p[2 * t][0], p[2 * t][1]),
                                M::pack(p[2 * t][2], p[2 * t][3]),
                                M::pack(p[2 * t + 1][0], p[2 * t + 1][1]),
                                M::pack(p[2 * t + 1][2], p[2 * t + 1][3])};
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(
              bv, dOs + (t * 16 + (mi & 1) * 8 + rr) * LD + np * 16 + (mi >> 1) * 8);
          M::run(dv[2 * np], af, bv);
          M::run(dv[2 * np + 1], af, bv + 2);
        }
      }
      // dp^T = v.do^T, then ds^T = p^T (dp^T - delta) in place.
      float ds[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const bf16* pa = Vs + (kr0 + g) * LD + kk * 16 + 2 * tig;
          const uint32_t af[4] = {lds32(pa), lds32(pa + 8 * LD), lds32(pa + 8),
                                  lds32(pa + 8 * LD + 8)};
          const bf16* pb = dOs + (j * 8 + g) * LD + kk * 16 + 2 * tig;
          const uint32_t bf[2] = {lds32(pb), lds32(pb + 8)};
          M::run(ds[j], af, bf);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ds[j][i] = p[j][i] * (ds[j][i] - delta_s[j * 8 + 2 * tig + (i & 1)]);
      }
      // dk += ds^T.q (ds in bf16).
#pragma unroll
      for (int t = 0; t < BQ / 16; ++t) {
        const uint32_t af[4] = {M::pack(ds[2 * t][0], ds[2 * t][1]),
                                M::pack(ds[2 * t][2], ds[2 * t][3]),
                                M::pack(ds[2 * t + 1][0], ds[2 * t + 1][1]),
                                M::pack(ds[2 * t + 1][2], ds[2 * t + 1][3])};
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bq[4];
          ldmatrix_x4_trans(
              bq, Qs + (t * 16 + (mi & 1) * 8 + rr) * LD + np * 16 + (mi >> 1) * 8);
          M::run(dk[2 * np], af, bq);
          M::run(dk[2 * np + 1], af, bq + 2);
        }
      }

      if constexpr (kIsFused) {
        // ds^T to shared memory as bf16, then dq[q0 + .., :] += ds.k.
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<uint32_t*>(dSs + (kr0 + g + 8 * half) * LDS + j * 8 +
                                         2 * tig) =
                M::pack(ds[j][2 * half], ds[j][2 * half + 1]);
        __syncthreads();
        const int mt = warp & 1;              // q rows mt*16 .. +15 of the tile
        const int d0 = (warp >> 1) * (D / 2);  // d columns d0 .. d0 + D/2 - 1
        float* dqb = static_cast<float*>(a.dq) + b * a.adq.b + h * a.adq.h;
        // two 8-column tiles at a time, each added out before the next, so
        // that only 8 partial sums join the 128 of dk and dv in registers
#pragma unroll
        for (int np = 0; np < D / 32; ++np) {
          float dq[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks) {
            uint32_t af[4], bk[4];
            ldmatrix_x4_trans(
                af, dSs + (ks * 16 + (mi >> 1) * 8 + rr) * LDS + mt * 16 + (mi & 1) * 8);
            ldmatrix_x4_trans(bk, Ks + (ks * 16 + (mi & 1) * 8 + rr) * LD + d0 +
                                      np * 16 + (mi >> 1) * 8);
            M::run(dq[0], af, bk);
            M::run(dq[1], af, bk + 2);
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = q0 + mt * 16 + g + 8 * half;
            if (row >= a.S) continue;
            float* drow = dqb + row * a.adq.s + d0 + np * 16 + 2 * tig;
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              atomicAdd(drow + n * 8, dq[n][2 * half]);
              atomicAdd(drow + n * 8 + 1, dq[n][2 * half + 1]);
            }
          }
        }
      }
    }
  }

  bf16* dkb = a.dk + b * a.adk.b + h * a.adk.h;
  bf16* dvb = a.dv + b * a.adv.b + h * a.adv.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + kr0 + g + 8 * half;
    if (key >= a.Sk) continue;
    bf16* krow = dkb + key * a.adk.s + 2 * tig;
    bf16* vrow = dvb + key * a.adv.s + 2 * tig;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8) =
          M::pack(dk[n][2 * half], dk[n][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(vrow + n * 8) =
          M::pack(dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int LD = D + 8;
  constexpr int BQ = kDqBlockQ;
  constexpr int BK = kDqBlockK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + BK * LD);
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int mi = lane >> 3;
  const int rr = lane & 7;
  const int r0 = warp * 16;

  const bf16* kb = a.k + b * a.ak.b + h * a.ak.h;
  const bf16* vb = a.v + b * a.av.b + h * a.av.h;
  const bf16* ob = a.o + b * a.ao.b + h * a.ao.h;
  const bf16* dob = a.dout + b * a.ado.b + h * a.ado.h;
  const float* bias = a.kbias ? a.kbias + static_cast<int64_t>(b) * a.Sk : nullptr;

  load_tile<D, BQ>(Qs, a.q + b * a.aq.b + h * a.aq.h, a.aq.s, q0, a.S, tid);
  load_tile<D, BQ>(dOs, dob, a.ado.s, q0, a.S, tid);
  load_row_stats<D, BQ>(lse_s, delta_s, a, ob, dob, bh, q0, tid);
  __syncthreads();
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    lse_r[half] = lse_s[r0 + g + 8 * half];
    delta_r[half] = delta_s[r0 + g + 8 * half];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_tiles = (a.kv_len + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, BK>(Ks, kb, a.ak.s, k0, a.Sk, tid);
    load_tile<D, BK>(Vs, vb, a.av.s, k0, a.Sk, tid);
    __syncthreads();

    // s = q.k^T and p = exp(s + bias - lse), zero past kv_len.
    float p[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* pa = Qs + (r0 + g) * LD + kk * 16 + 2 * tig;
        const uint32_t af[4] = {lds32(pa), lds32(pa + 8 * LD), lds32(pa + 8),
                                lds32(pa + 8 * LD + 8)};
        const bf16* pb = Ks + (j * 8 + g) * LD + kk * 16 + 2 * tig;
        const uint32_t bf[2] = {lds32(pb), lds32(pb + 8)};
        M::run(p[j], af, bf);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + j * 8 + 2 * tig + e;
        const bool valid = col < a.kv_len;
        const float add = (bias != nullptr && valid) ? bias[col] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 2 * half + e;
          p[j][i] = valid ? __expf(p[j][i] + add - lse_r[half]) : 0.f;
        }
      }
    }
    // dp = do.v^T, then ds = p (dp - delta) in place.
    float ds[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* pa = dOs + (r0 + g) * LD + kk * 16 + 2 * tig;
        const uint32_t af[4] = {lds32(pa), lds32(pa + 8 * LD), lds32(pa + 8),
                                lds32(pa + 8 * LD + 8)};
        const bf16* pb = Vs + (j * 8 + g) * LD + kk * 16 + 2 * tig;
        const uint32_t bf[2] = {lds32(pb), lds32(pb + 8)};
        M::run(ds[j], af, bf);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[j][i] = p[j][i] * (ds[j][i] - delta_r[i >> 1]);
    }
    // dq += ds.k (ds in bf16).
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint32_t af[4] = {M::pack(ds[2 * t][0], ds[2 * t][1]),
                              M::pack(ds[2 * t][2], ds[2 * t][3]),
                              M::pack(ds[2 * t + 1][0], ds[2 * t + 1][1]),
                              M::pack(ds[2 * t + 1][2], ds[2 * t + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4_trans(
            bk, Ks + (t * 16 + (mi & 1) * 8 + rr) * LD + np * 16 + (mi >> 1) * 8);
        M::run(acc[2 * np], af, bk);
        M::run(acc[2 * np + 1], af, bk + 2);
      }
    }
  }

  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.adq.b + h * a.adq.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + 8 * half;
    if (row >= a.S) continue;
    bf16* drow = dqb + row * a.adq.s + 2 * tig;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8) =
          M::pack(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

// ---- DKV: wgmma fed by a TMA ring ------------------------------------------------

constexpr int kWgKeys = 64;                          // keys per consumer warpgroup
constexpr int kWgConsumers = 2;                      // consumer warpgroups
constexpr int kWgBlockN = kWgKeys * kWgConsumers;    // keys per block
constexpr int kWgBlockM = 64;                        // q rows per ring stage
constexpr int kWgStages = 3;                         // depth of the q/do ring
constexpr int kWgConsumerThreads = 128 * kWgConsumers;
constexpr int kWgThreads = kWgConsumerThreads + 128;  // + the producer warpgroup
constexpr int kStatBytes = 2 * kWgBlockM * 4;        // lse*log2e and delta of a q tile
constexpr int kStatsThreads = 256;                   // threads of a pre-pass block

template <int D>
using KTile = Tile<D, kWgBlockN>;  // K and V: 128 rows
template <int D>
using QTile = Tile<D, kWgBlockM>;  // q and do: 64 rows

template <int D>
constexpr int dkv_smem_bytes() {
  // 1024 bytes of slack to align the tiles to the swizzle atom, then K, V,
  // q[stages], do[stages], the stats of each stage, then the barriers
  return 1024 + 2 * KTile<D>::kBytes + 2 * kWgStages * QTile<D>::kBytes +
         kWgStages * kStatBytes + 8 * (1 + 2 * kWgStages);
}

struct DkvArgs {
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
    dkv_stats_kernel(const Args a, float* __restrict__ stats, int n_qt) {
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

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const DkvArgs a) {
  using KT = KTile<D>;
  using QT = QTile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base;
  const uint32_t sv = sk + KT::kBytes;
  const uint32_t sq = sv + KT::kBytes;                 // + stage * QT::kBytes
  const uint32_t sdo = sq + kWgStages * QT::kBytes;    // + stage * QT::kBytes
  const uint32_t sstat = sdo + kWgStages * QT::kBytes;  // + stage * kStatBytes
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

      // (4) dk += ds^T.q
      fence_operands(dk);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kWgBlockM / 16; ++t)
        WgmmaRS<D>::run(dk, da[t], mnmajor_desc<QT>(q_st, t));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dv);
      fence_operands(dk);
      fence_operands(pa);  // the A fragments stay live until their products are done
      fence_operands(da);
      mbar_arrive(empty + 8 * st);
    }
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

// Mode DKV: the stats pre-pass, then the dk/dv kernel, on one stream.  geom:
// 28 int64 values, seven for each of q, k, v and do in that order (the dims
// (D, S, H, B) and the byte strides of the S, H and B axes); stats: the f32
// scratch of (B*H, ceil(S / 64), 2, 64) values.
template <int D>
int launch_dkv(const Args& a, const int64_t* geom, float* stats, int B, cudaStream_t stream) {
  CUtensorMap maps[4];
  int err = encode<QTile<D>>(&maps[0], a.q, geom);
  if (err == 0) err = encode<KTile<D>>(&maps[1], a.k, geom + 7);
  if (err == 0) err = encode<KTile<D>>(&maps[2], a.v, geom + 14);
  if (err == 0) err = encode<QTile<D>>(&maps[3], a.dout, geom + 21);
  if (err != 0) return err;
  const int n_qt = (a.S + kWgBlockM - 1) / kWgBlockM;
  constexpr int kRows = kStatsThreads / (D / 8);  // divides kWgBlockM
  dkv_stats_kernel<D><<<dim3(n_qt * kWgBlockM / kRows, B * a.H), kStatsThreads, 0, stream>>>(
      a, stats, n_qt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const DkvArgs d{a.kbias, stats, a.dk, a.dv, a.adk, a.adv, a.H, a.Sk, a.kv_len, n_qt};
  // 166 KB at D = 128: above the 48 KB default, so opt in (per device, per
  // call: the call costs far less than the launch)
  constexpr int smem = dkv_smem_bytes<D>();
  e = cudaFuncSetAttribute(flash_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Sk + kWgBlockN - 1) / kWgBlockN, B * a.H);
  flash_dkv_kernel<D><<<grid, kWgThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], d);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, int smem, const Args& a,
                          cudaStream_t stream) {
  // above the 48 KB default at D = 128, so opt in (per device, per call:
  // the call costs far less than the launch)
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
int launch(int mode, const Args& a, const int64_t* geom, float* stats, int B,
           cudaStream_t stream) {
  constexpr int LD = D + 8;
  if (mode == kDkv) return launch_dkv<D>(a, geom, stats, B, stream);
  if (mode == kDq) {
    constexpr int smem =
        (2 * kDqBlockQ + 2 * kDqBlockK) * LD * sizeof(bf16) + 2 * kDqBlockQ * sizeof(float);
    dim3 grid((a.S + kDqBlockQ - 1) / kDqBlockQ, B * a.H);
    return static_cast<int>(launch_kernel(flash_bwd_dq_kernel<D>, grid, smem, a, stream));
  }
  constexpr int smem = (2 * kDkvBlockK + 2 * kDkvBlockQ) * LD * sizeof(bf16) +
                       2 * kDkvBlockQ * sizeof(float) +
                       kDkvBlockK * (kDkvBlockQ + 8) * sizeof(bf16);
  dim3 grid((a.Sk + kDkvBlockK - 1) / kDkvBlockK, B * a.H);
  return static_cast<int>(launch_kernel(flash_bwd_dkv_kernel<D, true>, grid, smem, a, stream));
}

}  // namespace

// mode 0 = DKV (dk, dv), 1 = FUSED (dk, dv, and dq added into the f32 buffer
// `dq`), 2 = DQ (dq in bf16).  `strides` holds (batch, head, sequence)
// element strides of q, k, v, o, do, dq, dk, dv in that order (24 values).
// DKV also reads `geom` (28 int64: the TMA geometry of q, k, v and do, see
// launch_dkv) and writes its stats into `scratch`; the other modes ignore
// both.
extern "C" int flash_attn_bwd(int mode, const void* q, const void* k,
                              const void* v, const void* o, const void* dout,
                              const void* lse, const void* kbias, void* dq,
                              void* dk, void* dv, const int64_t* strides,
                              const int64_t* geom, void* scratch, int B,
                              int H, int S, int Sk, int D, int kv_len,
                              void* stream) {
  if (mode < kDkv || mode > kDq) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kDkv && (geom == nullptr || scratch == nullptr))
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
  Ax* axes[8] = {&a.aq, &a.ak, &a.av, &a.ao, &a.ado, &a.adq, &a.adk, &a.adv};
  for (int i = 0; i < 8; ++i)
    *axes[i] = Ax{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.H = H;
  a.S = S;
  a.Sk = Sk;
  a.kv_len = kv_len;
  float* stats = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(mode, a, geom, stats, B, st);
    case 64:
      return launch<64>(mode, a, geom, stats, B, st);
    case 128:
      return launch<128>(mode, a, geom, stats, B, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one DKV block at head dim D, in bytes (-1 for a
// head dim the kernel does not take); read by reports, never by a launch.
extern "C" int flash_attn_bwd_dkv_smem_bytes(int D) {
  switch (D) {
    case 32:
      return dkv_smem_bytes<32>();
    case 64:
      return dkv_smem_bytes<64>();
    case 128:
      return dkv_smem_bytes<128>();
    default:
      return -1;
  }
}
