// QK RMSNorm + RoPE + joint [text | image] layout for the FLUX blocks, forward
// and backward, for Hopper (sm_90a; nothing here needs more than sm_80).
//
// Replaces no TPU kernel: in the JAX package XLA fused the QK-norm, the
// rotation and the concatenation of a block into the attention's input, so
// mixgrpo_tpu/ has no Pallas call for it.  The port ran them as eager
// PyTorch (`layers.rms_norm`, `rope.apply_rope`, `torch.cat`): six to eight
// full-size f32 passes over a strided view for each of q and k, and three
// concatenations a double block.  This file does the same arithmetic in one
// pass; ops/qk_rope.py keeps that eager composition as the plain version.
//
// Function.  Input: one or two bf16 (or f32) projection outputs ("streams"),
// each (B, L_i, >= 3*H*D) read through its batch and row strides, q in
// columns [0, HD), k in [HD, 2HD), v in [2HD, 3HD); the joint sequence is
// [stream 0 | stream 1], S = L_0 + L_1.  Per (batch, token, head) row of D:
//   r = rsqrt(mean(x^2) + eps) in f32 (a warp-shuffle sum over the row);
//   n = round(x * r); y = round(n * scale)            (layers.rms_norm's roundings)
//   z_2j   = round(y_2j cos_2j - y_2j+1 sin_2j)        (rope.apply_rope's, in f32,
//   z_2j+1 = round(y_2j+1 cos_2j+1 + y_2j sin_2j+1)     product by product)
// for q and k (each stream has its own two scales), v copied as it is; q, k
// and v are written into new tensors in the attention layout (bhsd or bshd,
// the strides the wrapper passes), whose base and rows are 16-byte aligned
// as the flash kernels' TMA maps need.  Pad rows and HunyuanVideo's text rows
// get the identity rotation from the tables (cos 1, sin 0): no special case.
// With a gradient to come, the per-row r of q and of k is stored as f32
// (B, H, S): 8 bytes a row against 768 bytes of q, k and v at D = 128.
// Products and sums go through __fmul_rn / __fadd_rn so that nvcc contracts
// nothing into an FMA the eager ops do not make: the forward equals the plain
// version bit for bit except where the sum of squares, taken in another
// order, moves r by an f32 ulp and a rounding to bf16 with it (one bf16 ulp).
//
// Backward, per row (the chain rule of the same roundings, as autograd takes
// it through the eager ops): the rotation by -theta,
//   dy_2j = round(g_2j cos_2j + g_2j+1 sin_2j+1), dy_2j+1 = round(g_2j+1 cos_2j+1 - g_2j sin_2j);
//   dn = round(dy * scale); n recomputed from x and the stored r;
//   dx = dn r - x r^3 sum(dn x) / D, rounded once;
// dv copied; d(qkv) written straight into one contiguous (B, L_i, 3HD) tensor
// per stream, so autograd runs no chunk, transpose or cat backward.  When a
// scale needs its gradient, d(scale) = sum over rows of round(dy n) in f32:
// each lane keeps its columns' sums in registers, a block adds its lanes into
// shared memory with shared atomics and writes one (4, D) partial (stream x
// q/k), and a second small kernel sums the partials in block order, so the
// result does not depend on scheduling.
//
// Bound on an H100: bytes (a handful of FLOP per byte).  Forward: q, k, v read
// once and written once, 12*B*S*H*D bytes in bf16, plus the f32 tables
// 8*S*D (read once from memory; the H heads of a token share them through
// the caches).  FLUX at 720px (B = 2, S = 2560, H = 24, D = 128): 191 MB,
// 57 us at 3.35 TB/s.  Backward: dq, dk, dv and x_q, x_k read, d(qkv)
// written: 16*B*S*H*D bytes plus the tables, 255 MB, 76 us.
//
// Design.  A row of D values is LANES = D / (16 / sizeof(T)) lanes of one
// warp, each lane holding one 16-byte vector of q, of k and of v (8 bf16 or
// 4 f32): one 16-byte load and one 16-byte store per lane and tensor, the
// row's sum of squares in log2(LANES) shuffles within the lane group.
// Consecutive lane groups take consecutive heads of one token, so the loads
// of a warp cover whole contiguous spans of the projection row and the
// token's table row is read once from memory and then hit in L1.  256
// threads a block, a grid of at most 8 blocks per SM walking the rows in a
// grid-stride loop (the wrapper computes the grid: `_grid`), so the d(scale)
// partials have a fixed, small count.
//
// Plain C interface for ctypes: qk_rope_fwd(...) and qk_rope_bwd(...) launch
// on `stream`, allocate nothing, do not synchronise, and return
// cudaGetLastError() (cudaErrorInvalidValue for a head dim or dtype they do
// not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// 16 bytes of T as floats, and the rounding to T.
template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ uint32_t bits(float x) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
  }
  static __device__ __forceinline__ float round(float x) {
    return __uint_as_float(bits(x) << 16);
  }
  static __device__ __forceinline__ void unpack(const uint4& w, float* v) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = bits(v[2 * i]) | (bits(v[2 * i + 1]) << 16);
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

template <>
struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void unpack(const uint4& w, float* v) {
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <typename T>
__device__ __forceinline__ uint4 ld16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__device__ __forceinline__ void st16(T* p, uint4 w) {
  *reinterpret_cast<uint4*>(p) = w;
}

template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 w = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = w.x;
    v[4 * i + 1] = w.y;
    v[4 * i + 2] = w.z;
    v[4 * i + 3] = w.w;
  }
}

// Sum over the LANES lanes of this lane's group (`mask` names them).
template <int LANES>
__device__ __forceinline__ float group_sum(float x, unsigned mask) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) x += __shfl_xor_sync(mask, x, o, LANES);
  return x;
}

template <int LANES>
__device__ __forceinline__ unsigned group_mask(int lane) {
  if constexpr (LANES == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << LANES) - 1u) << (lane / LANES * LANES);
  }
}

// Where a (batch, token, head) row comes from and goes to.
struct Row {
  int b, s, h, i, l;  // batch, joint token, head, stream, token within the stream
};

__device__ __forceinline__ Row locate(int row, int H, int S, int L0) {
  Row r;
  r.h = row % H;
  const int t = row / H;
  r.s = t % S;
  r.b = t / S;
  r.i = r.s < L0 ? 0 : 1;
  r.l = r.i ? r.s - L0 : r.s;
  return r;
}

struct FwdArgs {
  const void* x0;  // stream 0 (the joint sequence's first L0 tokens)
  const void* x1;  // stream 1, or null
  const void* qs0;
  const void* ks0;
  const void* qs1;
  const void* ks1;
  int64_t bs0, rs0, bs1, rs1;  // batch and row strides of the streams (elements)
  int64_t ob, oh, os;          // output strides of (batch, head, token) (elements)
  const float* cos;            // (S, D)
  const float* sin;
  void* q;
  void* k;
  void* v;
  float* rq;  // (B, H, S) or null
  float* rk;
  int B, H, S, L0;
  float eps;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) qk_norm_rope_fwd_kernel(const FwdArgs a) {
  using P = Pack<T>;
  constexpr int N = P::N, LANES = D / N, PER_WARP = 32 / LANES;
  const int lane = threadIdx.x & 31, d0 = lane % LANES * N;
  const unsigned mask = group_mask<LANES>(lane);
  const int64_t HD = static_cast<int64_t>(a.H) * D;
  const int rows = a.B * a.S * a.H;  // below 2^31 (the wrapper checks)
  const int warp = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int step = gridDim.x * (kThreads / 32) * PER_WARP;
  for (int row = warp * PER_WARP + lane / LANES; row < rows; row += step) {
    const Row r = locate(row, a.H, a.S, a.L0);
    const T* x = static_cast<const T*>(r.i ? a.x1 : a.x0) + r.b * (r.i ? a.bs1 : a.bs0) +
                 r.l * (r.i ? a.rs1 : a.rs0) + r.h * D + d0;
    const T* qscale = static_cast<const T*>(r.i ? a.qs1 : a.qs0) + d0;
    const T* kscale = static_cast<const T*>(r.i ? a.ks1 : a.ks0) + d0;
    const uint4 wq = ld16(x), wk = ld16(x + HD), wv = ld16(x + 2 * HD);
    const uint4 wqs = ld16(qscale), wks = ld16(kscale);
    float c[N], sn[N];
    load_f32<N>(a.cos + static_cast<int64_t>(r.s) * D + d0, c);
    load_f32<N>(a.sin + static_cast<int64_t>(r.s) * D + d0, sn);
    const int64_t out = r.b * a.ob + r.h * a.oh + static_cast<int64_t>(r.s) * a.os + d0;
    st16(static_cast<T*>(a.v) + out, wv);

    float q[N], k[N], qs[N], ks[N];
    P::unpack(wq, q);
    P::unpack(wk, k);
    P::unpack(wqs, qs);
    P::unpack(wks, ks);
    float sq = 0.f, sk = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      sq += q[j] * q[j];
      sk += k[j] * k[j];
    }
    sq = group_sum<LANES>(sq, mask);
    sk = group_sum<LANES>(sk, mask);
    const float rq = rsqrtf(__fadd_rn(__fmul_rn(sq, 1.f / D), a.eps));
    const float rk = rsqrtf(__fadd_rn(__fmul_rn(sk, 1.f / D), a.eps));
#pragma unroll
    for (int j = 0; j < N; ++j) {
      q[j] = P::round(__fmul_rn(P::round(__fmul_rn(q[j], rq)), qs[j]));
      k[j] = P::round(__fmul_rn(P::round(__fmul_rn(k[j], rk)), ks[j]));
    }
    float zq[N], zk[N];
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      zq[j] = __fadd_rn(__fmul_rn(q[j], c[j]), -__fmul_rn(q[j + 1], sn[j]));
      zq[j + 1] = __fadd_rn(__fmul_rn(q[j + 1], c[j + 1]), __fmul_rn(q[j], sn[j + 1]));
      zk[j] = __fadd_rn(__fmul_rn(k[j], c[j]), -__fmul_rn(k[j + 1], sn[j]));
      zk[j + 1] = __fadd_rn(__fmul_rn(k[j + 1], c[j + 1]), __fmul_rn(k[j], sn[j + 1]));
    }
    st16(static_cast<T*>(a.q) + out, P::pack(zq));
    st16(static_cast<T*>(a.k) + out, P::pack(zk));
    if (a.rq != nullptr && lane % LANES == 0) {
      const int64_t at = (static_cast<int64_t>(r.b) * a.H + r.h) * a.S + r.s;
      a.rq[at] = rq;
      a.rk[at] = rk;
    }
  }
}

struct BwdArgs {
  const void* x0;  // the forward's inputs
  const void* x1;
  const void* qs0;
  const void* ks0;
  const void* qs1;
  const void* ks1;
  int64_t bs0, rs0, bs1, rs1;
  int64_t gs[9];  // (batch, head, token) strides of dq, dk, dv (elements)
  const float* cos;
  const float* sin;
  const float* rq;  // (B, H, S)
  const float* rk;
  const void* dq;
  const void* dk;
  const void* dv;
  void* g0;      // d(stream 0), contiguous (B, L0, 3HD)
  void* g1;      // d(stream 1), contiguous (B, S - L0, 3HD), or null
  float* part;   // (gridDim.x, 4, D) d(scale) partials, or null
  int B, H, S, L0;
};

// One row of q or k backward: g is the incoming gradient, x the forward's
// input, sc the scale, r the stored rsqrt; returns dx in g and adds round(dy n)
// into acc when acc is not null.
template <typename T, int D, int N, int LANES>
__device__ __forceinline__ void norm_rope_bwd(float* g, const float* x, const float* sc,
                                              const float* c, const float* sn, float r,
                                              unsigned mask, float* acc) {
  using P = Pack<T>;
  float dn[N];
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    const float dy0 = P::round(__fadd_rn(__fmul_rn(g[j], c[j]), __fmul_rn(g[j + 1], sn[j + 1])));
    const float dy1 = P::round(__fadd_rn(__fmul_rn(g[j + 1], c[j + 1]), -__fmul_rn(g[j], sn[j])));
    dn[j] = P::round(__fmul_rn(dy0, sc[j]));
    dn[j + 1] = P::round(__fmul_rn(dy1, sc[j + 1]));
    if (acc != nullptr) {
      acc[j] += P::round(__fmul_rn(dy0, P::round(__fmul_rn(x[j], r))));
      acc[j + 1] += P::round(__fmul_rn(dy1, P::round(__fmul_rn(x[j + 1], r))));
    }
  }
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) dot += dn[j] * x[j];
  dot = group_sum<LANES>(dot, mask);
  const float coef = -dot * (r * r * r) * (1.f / D);
#pragma unroll
  for (int j = 0; j < N; ++j) g[j] = __fadd_rn(__fmul_rn(dn[j], r), __fmul_rn(x[j], coef));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) qk_norm_rope_bwd_kernel(const BwdArgs a) {
  using P = Pack<T>;
  constexpr int N = P::N, LANES = D / N, PER_WARP = 32 / LANES;
  __shared__ float red[4 * D];
  const int lane = threadIdx.x & 31, d0 = lane % LANES * N;
  const unsigned mask = group_mask<LANES>(lane);
  const bool want_scale = a.part != nullptr;
  if (want_scale) {
    for (int j = threadIdx.x; j < 4 * D; j += kThreads) red[j] = 0.f;
    __syncthreads();
  }
  float acc[4][N];  // stream 0 q, stream 0 k, stream 1 q, stream 1 k
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[u][j] = 0.f;
  const int64_t HD = static_cast<int64_t>(a.H) * D;
  const int rows = a.B * a.S * a.H;  // below 2^31 (the wrapper checks)
  const int warp = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int step = gridDim.x * (kThreads / 32) * PER_WARP;
  for (int row = warp * PER_WARP + lane / LANES; row < rows; row += step) {
    const Row r = locate(row, a.H, a.S, a.L0);
    const T* x = static_cast<const T*>(r.i ? a.x1 : a.x0) + r.b * (r.i ? a.bs1 : a.bs0) +
                 r.l * (r.i ? a.rs1 : a.rs0) + r.h * D + d0;
    const T* qscale = static_cast<const T*>(r.i ? a.qs1 : a.qs0) + d0;
    const T* kscale = static_cast<const T*>(r.i ? a.ks1 : a.ks0) + d0;
    const uint4 wgq = ld16(static_cast<const T*>(a.dq) + r.b * a.gs[0] + r.h * a.gs[1] +
                           r.s * a.gs[2] + d0);
    const uint4 wgk = ld16(static_cast<const T*>(a.dk) + r.b * a.gs[3] + r.h * a.gs[4] +
                           r.s * a.gs[5] + d0);
    const uint4 wgv = ld16(static_cast<const T*>(a.dv) + r.b * a.gs[6] + r.h * a.gs[7] +
                           r.s * a.gs[8] + d0);
    const uint4 wq = ld16(x), wk = ld16(x + HD);
    const uint4 wqs = ld16(qscale), wks = ld16(kscale);
    float c[N], sn[N];
    load_f32<N>(a.cos + static_cast<int64_t>(r.s) * D + d0, c);
    load_f32<N>(a.sin + static_cast<int64_t>(r.s) * D + d0, sn);
    const int64_t at = (static_cast<int64_t>(r.b) * a.H + r.h) * a.S + r.s;
    const float rq = a.rq[at], rk = a.rk[at];
    const int64_t L = r.i ? a.S - a.L0 : a.L0;
    T* out = static_cast<T*>(r.i ? a.g1 : a.g0) + (r.b * L + r.l) * 3 * HD + r.h * D + d0;
    st16(out + 2 * HD, wgv);

    float gq[N], gk[N], q[N], k[N], qs[N], ks[N];
    P::unpack(wgq, gq);
    P::unpack(wgk, gk);
    P::unpack(wq, q);
    P::unpack(wk, k);
    P::unpack(wqs, qs);
    P::unpack(wks, ks);
    if (want_scale && r.i == 0) {
      norm_rope_bwd<T, D, N, LANES>(gq, q, qs, c, sn, rq, mask, acc[0]);
      norm_rope_bwd<T, D, N, LANES>(gk, k, ks, c, sn, rk, mask, acc[1]);
    } else if (want_scale) {
      norm_rope_bwd<T, D, N, LANES>(gq, q, qs, c, sn, rq, mask, acc[2]);
      norm_rope_bwd<T, D, N, LANES>(gk, k, ks, c, sn, rk, mask, acc[3]);
    } else {
      norm_rope_bwd<T, D, N, LANES>(gq, q, qs, c, sn, rq, mask, nullptr);
      norm_rope_bwd<T, D, N, LANES>(gk, k, ks, c, sn, rk, mask, nullptr);
    }
    st16(out, P::pack(gq));
    st16(out + HD, P::pack(gk));
  }
  if (want_scale) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < N; ++j) atomicAdd(&red[u * D + d0 + j], acc[u][j]);
    __syncthreads();
    float* part = a.part + static_cast<int64_t>(blockIdx.x) * 4 * D;
    for (int j = threadIdx.x; j < 4 * D; j += kThreads) part[j] = red[j];
  }
}

// out[j] = sum over the blocks' partials, in block order.
__global__ void qk_norm_rope_dscale_kernel(const float* part, int blocks, int n, float* out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[static_cast<int64_t>(b) * n + j];
  out[j] = s;
}

template <typename T, int D>
int launch_fwd(const FwdArgs& a, int grid, cudaStream_t st) {
  qk_norm_rope_fwd_kernel<T, D><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const BwdArgs& a, int grid, float* dscale, cudaStream_t st) {
  qk_norm_rope_bwd_kernel<T, D><<<grid, kThreads, 0, st>>>(a);
  if (a.part != nullptr) {
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    qk_norm_rope_dscale_kernel<<<(4 * D + 255) / 256, 256, 0, st>>>(a.part, grid, 4 * D, dscale);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 bf16, 1 f32.
template <typename F32, typename BF16>
int dispatch(int dtype, int D, F32 f32, BF16 bf16) {
  if (dtype == 0) {
    switch (D) {
      case 32: return bf16(std::integral_constant<int, 32>());
      case 64: return bf16(std::integral_constant<int, 64>());
      case 128: return bf16(std::integral_constant<int, 128>());
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return f32(std::integral_constant<int, 32>());
      case 64: return f32(std::integral_constant<int, 64>());
      case 128: return f32(std::integral_constant<int, 128>());
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// geom: bs0, rs0, bs1, rs1 (the streams' batch and row strides), ob, oh, os
// (the outputs' batch, head and token strides), all in elements.
extern "C" int qk_rope_fwd(int dtype, int D, const void* x0, const void* x1, const void* qs0,
                           const void* ks0, const void* qs1, const void* ks1,
                           const int64_t* geom, const float* cos, const float* sin, void* q,
                           void* k, void* v, float* rq, float* rk, int B, int H, int S, int L0,
                           float eps, int grid, void* stream) {
  const FwdArgs a{x0,      x1,      qs0,     ks0,     qs1, ks1, geom[0], geom[1], geom[2],
                  geom[3], geom[4], geom[5], geom[6], cos, sin, q,       k,       v,
                  rq,      rk,      B,       H,       S,   L0,  eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(
      dtype, D,
      [&](auto d) { return launch_fwd<float, decltype(d)::value>(a, grid, st); },
      [&](auto d) { return launch_fwd<__nv_bfloat16, decltype(d)::value>(a, grid, st); });
}

// geom: bs0, rs0, bs1, rs1, then the (batch, head, token) strides of dq, dk
// and dv, all in elements.  part: (grid, 4, D) f32 scratch and dscale: (4, D)
// f32, both null when no scale needs its gradient.
extern "C" int qk_rope_bwd(int dtype, int D, const void* x0, const void* x1, const void* qs0,
                           const void* ks0, const void* qs1, const void* ks1,
                           const int64_t* geom, const float* cos, const float* sin,
                           const float* rq, const float* rk, const void* dq, const void* dk,
                           const void* dv, void* g0, void* g1, float* part, float* dscale,
                           int B, int H, int S, int L0, int grid, void* stream) {
  BwdArgs a{};
  a.x0 = x0;
  a.x1 = x1;
  a.qs0 = qs0;
  a.ks0 = ks0;
  a.qs1 = qs1;
  a.ks1 = ks1;
  a.bs0 = geom[0];
  a.rs0 = geom[1];
  a.bs1 = geom[2];
  a.rs1 = geom[3];
  for (int i = 0; i < 9; ++i) a.gs[i] = geom[4 + i];
  a.cos = cos;
  a.sin = sin;
  a.rq = rq;
  a.rk = rk;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.g0 = g0;
  a.g1 = g1;
  a.part = part;
  a.B = B;
  a.H = H;
  a.S = S;
  a.L0 = L0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(
      dtype, D,
      [&](auto d) { return launch_bwd<float, decltype(d)::value>(a, grid, dscale, st); },
      [&](auto d) { return launch_bwd<__nv_bfloat16, decltype(d)::value>(a, grid, dscale, st); });
}
