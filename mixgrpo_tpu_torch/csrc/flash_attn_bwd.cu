// Flash attention backward for Hopper, sm_90a: dq, dk, dv from the saved
// logsumexp, in two kernels and three modes.
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
//   dp = do.v^T in f32; delta = rowsum(o * do) in f32, from the o tile;
//   ds = p * (dp - delta);
//   dk = ds^T.q and dq = ds.k with ds cast to the input dtype, f32 sums;
//   dq, dk, dv are written in the input dtype; the bias gets no gradient.
//
// Bound on an H100 at the update's shapes: compute.  DKV does 4 products,
// DQ 3 and FUSED 5, each 2*B*H*S*kv_len*D FLOP, against some 12 bytes of
// bf16 traffic per (row, d) element: hundreds of FLOP per byte at S = 2560,
// far above the card's ~295 FLOP/byte ridge.  So every product runs on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 out, fragments as in
// flash_common.cuh) and no S x Sk matrix ever reaches device memory.
//
// DKV and FUSED (one kernel, `flash_bwd_dkv_kernel`): one block of 4 warps
// per (batch*head, 64-key tile); each warp owns 16 keys and keeps their f32
// dk and dv rows in registers (2 x 16 x D / 32 lanes = 128 floats a thread
// at D = 128, the register budget that fixes the tile sizes).  K and V stay
// in shared memory; a loop walks 32-row q tiles (q, do, lse, delta staged in
// shared memory).  The scores are computed transposed, s^T = k.q^T, so that
// every product of the loop keeps its operand in registers: p^T is the A
// fragment of dv += p^T.do, ds^T the A fragment of dk += ds^T.q, and do and
// q enter as B through ldmatrix.trans.  FUSED also needs ds.k for dq: ds^T
// goes through shared memory as bf16 (read back transposed by ldmatrix), each
// warp forms a 16 x D/2 slice of the tile's dq partial, 16 columns at a time
// (more would not fit beside dk and dv: at D = 128 the whole slice spilled),
// and adds it with f32 atomicAdd into a (B, H, S, D)-shaped f32 buffer that
// the wrapper zeroes and casts.  The atomics' order changes from run to run,
// so FUSED's dq is reproducible only to f32 rounding before its cast to
// bf16.  Key tiles at or past kv_len skip the loop and store zeros (the
// outputs come from torch.empty; the TPU kernel writes zeros there through
// p = 0).
//
// DQ (`flash_bwd_dq_kernel`): one block of 4 warps per (batch*head, 64-row q
// tile), each warp 16 rows with f32 dq rows in registers; a loop walks the
// 64-key tiles below kv_len (K and V in shared memory), recomputes s and p in
// the forward's orientation, and dp = do.v^T; ds is the A fragment of
// dq += ds.k, k entering as B through ldmatrix.trans.
//
// Strides (in elements) for the batch, head and sequence axes of every
// tensor are arguments, so (B, H, S, D) and (B, S, H, D) run the same code
// with no transposes; the last axis must be contiguous.  Ragged S and Sk
// tails are handled with predicates, as in the forward.  wgmma, TMA and
// pipelined loads are left for later work.
//
// Plain C interface for ctypes: flash_attn_bwd(mode, ...) launches on
// `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using M = Mma<bf16>;

constexpr int kThreads = 128;  // 4 warps
constexpr int kDkvBlockK = 64;  // keys per DKV/FUSED block, 16 per warp
constexpr int kDkvBlockQ = 32;  // q rows per step of the DKV/FUSED loop
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
cudaError_t launch(int mode, const Args& a, int B, cudaStream_t stream) {
  constexpr int LD = D + 8;
  if (mode == kDq) {
    constexpr int smem =
        (2 * kDqBlockQ + 2 * kDqBlockK) * LD * sizeof(bf16) + 2 * kDqBlockQ * sizeof(float);
    dim3 grid((a.S + kDqBlockQ - 1) / kDqBlockQ, B * a.H);
    return launch_kernel(flash_bwd_dq_kernel<D>, grid, smem, a, stream);
  }
  constexpr int base =
      (2 * kDkvBlockK + 2 * kDkvBlockQ) * LD * sizeof(bf16) + 2 * kDkvBlockQ * sizeof(float);
  dim3 grid((a.Sk + kDkvBlockK - 1) / kDkvBlockK, B * a.H);
  if (mode == kFused) {
    constexpr int smem = base + kDkvBlockK * (kDkvBlockQ + 8) * sizeof(bf16);
    return launch_kernel(flash_bwd_dkv_kernel<D, true>, grid, smem, a, stream);
  }
  return launch_kernel(flash_bwd_dkv_kernel<D, false>, grid, base, a, stream);
}

}  // namespace

// mode 0 = DKV (dk, dv), 1 = FUSED (dk, dv, and dq added into the f32 buffer
// `dq`), 2 = DQ (dq in bf16).  `strides` holds (batch, head, sequence)
// element strides of q, k, v, o, do, dq, dk, dv in that order (24 values).
extern "C" int flash_attn_bwd(int mode, const void* q, const void* k,
                              const void* v, const void* o, const void* dout,
                              const void* lse, const void* kbias, void* dq,
                              void* dk, void* dv, const int64_t* strides, int B,
                              int H, int S, int Sk, int D, int kv_len,
                              void* stream) {
  if (mode < kDkv || mode > kDq) return static_cast<int>(cudaErrorInvalidValue);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return static_cast<int>(launch<32>(mode, a, B, st));
    case 64:
      return static_cast<int>(launch<64>(mode, a, B, st));
    case 128:
      return static_cast<int>(launch<128>(mode, a, B, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
