// Flash attention forward for Hopper, sm_90a, with an optional logsumexp.
//
// Replaces the TPU kernel `_fwd_kernel` of mixgrpo_tpu/ops/flash_attention.py
// (lines 61-120, launched by `_fwd_impl`) in both its variants: without the
// logsumexp (`_flash`, the forward that every DiT block of the sampling path
// runs) and with it (`_flash_fwd`, the PPO update's forward, whose lse the
// backward kernels of flash_attn_bwd.cu read).  One kernel serves both: a
// null `lse` pointer is the variant without it.  Contract, identical to the
// TPU kernel:
//   q arrives pre-scaled by 1/sqrt(D) in its own dtype (the wrapper folds the
//   scale in), so the kernel applies no scale;
//   s = q.k^T in f32, plus an optional (B, Sk) f32 key bias (0 or -1e30),
//   then s = -1e30 where col >= kv_len;
//   online softmax with a running max m and sum l (both f32);
//   acc += p.v with p cast to v's dtype and f32 accumulation;
//   o = acc / max(l, 1e-30), written in q's dtype;
//   lse = m + log(max(l, 1e-30)) in f32, one value per (b, h, row), stored
//   as a contiguous (B, H, S) array (the TPU kernel broadcast it over 128
//   lanes; the extra 4 bytes per row are negligible here, so nothing is
//   broadcast).
//
// Bound on an H100 at FLUX shapes: compute.  The two products cost
// 4*B*H*S*Sk*D FLOP against (3*S + S)*D*2 bytes per head, about S/2
// FLOP per byte (2304 at S=4608), far above the card's ~295 FLOP/byte ridge.
// So the design keeps every product on the tensor cores and keeps the S x Sk
// score matrix out of device memory:
//   one block of 4 warps per (batch*head, 64-row query tile); each warp owns
//   16 query rows.  Q is staged once in shared memory and its fragments are
//   held in registers; a loop walks 64-key tiles of K and V through shared
//   memory; S = Q.K^T and O += P.V run as mma.sync m16n8k16 (bf16 inputs,
//   f32 accumulation); the softmax statistics stay in registers and
//   P goes from the S accumulator to the A operand without touching memory;
//   exp is __expf (ex2.approx), whose error is far below bf16's rounding of p.
//   Shared-memory rows are padded by 8 elements so fragment loads and
//   ldmatrix are free of bank conflicts.
// Strides (in elements) for the batch, head and sequence axes of q, k, v and
// o are arguments, so (B, H, S, D) and (B, S, H, D) run the same kernel with
// no transpose copies; the last axis must be contiguous.  Ragged S and Sk
// tails are handled with predicates: out-of-range rows load as zeros, and
// key tiles past kv_len are not visited (they would add exactly nothing).
// wgmma, TMA and a warp-specialised pipeline are left for later work.
//
// Plain C interface for ctypes: flash_attn_fwd(...) launches on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, const float* __restrict__ kbias,
                     Strides st, int H, int S, int Sk, int kv_len) {
  constexpr int LD = D + 8;       // padded shared-memory row, in elements
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBlockQ * LD;
  T* Vs = Ks + kBlockK * LD;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // row group of the mma fragments
  const int tig = lane & 3;  // thread within the group

  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  T* ob = o + b * st.ob + h * st.oh;
  const float* bias = kbias ? kbias + static_cast<int64_t>(b) * Sk : nullptr;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = tid; c < kBlockQ * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = zero;
    if (q0 + r < S)
      val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * st.qs + col);
    *reinterpret_cast<uint4*>(Qs + r * LD + col) = val;
  }
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const T* p = Qs + (r0 + g) * LD + kk * 16 + 2 * tig;
    qf[kk][0] = lds32(p);
    qf[kk][1] = lds32(p + 8 * LD);
    qf[kk][2] = lds32(p + 8);
    qf[kk][3] = lds32(p + 8 * LD + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = (kv_len + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int c = tid; c < kBlockK * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * st.ks + col);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * st.vs + col);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + col) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LD + col) = vv;
    }
    __syncthreads();

    // S = Q.K^T for this warp's 16 rows x 64 keys.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const T* p = Ks + (j * 8 + g) * LD + kk * 16 + 2 * tig;
        const uint32_t bf[2] = {lds32(p), lds32(p + 8)};
        Mma<T>::run(s[j], qf[kk], bf);
      }
    }

    // Key bias, prefix mask and the row maxima (rows g and g + 8).
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + j * 8 + 2 * tig + e;
        const bool valid = col < kv_len;
        const float add = (bias != nullptr && valid) ? bias[col] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float x = s[j][2 * half + e] + add;
          x = valid ? x : kNegInf;
          s[j][2 * half + e] = x;
          mx[half] = fmaxf(mx[half], x);
        }
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      alpha[half] = __expf(m_run[half] - mx[half]);
    }
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = __expf(s[j][i] - mx[i >> 1]);
        s[j][i] = p;
        rsum[i >> 1] += p;
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      rsum[half] += __shfl_xor_sync(0xffffffffu, rsum[half], 1);
      rsum[half] += __shfl_xor_sync(0xffffffffu, rsum[half], 2);
      l_run[half] = l_run[half] * alpha[half] + rsum[half];
      m_run[half] = mx[half];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P.V: the S accumulators of key tiles 2t and 2t+1 form the A
    // operand of the k16 step t.
    const int mi = lane >> 3;
    const int rr = lane & 7;
#pragma unroll
    for (int t = 0; t < kBlockK / 16; ++t) {
      const uint32_t a[4] = {
          Mma<T>::pack(s[2 * t][0], s[2 * t][1]),
          Mma<T>::pack(s[2 * t][2], s[2 * t][3]),
          Mma<T>::pack(s[2 * t + 1][0], s[2 * t + 1][1]),
          Mma<T>::pack(s[2 * t + 1][2], s[2 * t + 1][3]),
      };
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bv[4];
        const T* p =
            Vs + (t * 16 + (mi & 1) * 8 + rr) * LD + np * 16 + (mi >> 1) * 8;
        ldmatrix_x4_trans(bv, p);
        Mma<T>::run(acc[2 * np], a, bv);
        Mma<T>::run(acc[2 * np + 1], a, bv + 2);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + 8 * half;
    if (row >= S) continue;
    const float l = fmaxf(l_run[half], 1e-30f);
    if (lse != nullptr && tig == 0)  // the row's four lanes hold equal m, l
      lse[static_cast<int64_t>(bh) * S + row] = m_run[half] + logf(l);
    T* orow = ob + row * st.os + 2 * tig;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          Mma<T>::pack(acc[n][2 * half] / l, acc[n][2 * half + 1] / l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const float* kbias, const Strides& st, int B,
                   int H, int S, int Sk, int kv_len, cudaStream_t stream) {
  // 52 KB at D = 128: above the 48 KB default, so opt in (per device, per
  // call: the call costs far less than the launch).
  constexpr int smem = (kBlockQ + 2 * kBlockK) * (D + 8) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, kbias, st, H, S, Sk,
      kv_len);
  return cudaGetLastError();
}

cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, float* lse, const float* kbias,
                       const Strides& st, int B, int H, int S, int Sk,
                       int kv_len, cudaStream_t stream) {
  using T = __nv_bfloat16;
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, kbias, st, B, H, S, Sk, kv_len,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, kbias, st, B, H, S, Sk, kv_len,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, kbias, st, B, H, S, Sk, kv_len,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* kbias, int64_t qb,
                              int64_t qh, int64_t qs, int64_t kb, int64_t kh,
                              int64_t ks, int64_t vb, int64_t vh, int64_t vs,
                              int64_t ob, int64_t oh, int64_t os, int B, int H,
                              int S, int Sk, int D, int kv_len, void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  return static_cast<int>(dispatch_d(D, q, k, v, o, static_cast<float*>(lse),
                                     static_cast<const float*>(kbias), st, B,
                                     H, S, Sk, kv_len,
                                     static_cast<cudaStream_t>(stream)));
}
