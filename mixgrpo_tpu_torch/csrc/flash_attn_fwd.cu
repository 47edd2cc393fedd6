// Flash attention forward for Hopper, sm_90a, with an optional logsumexp:
// wgmma fed by a TMA ring.
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
//   acc += p.v with p cast to bf16 and f32 accumulation;
//   o = acc / max(l, 1e-30), written in bf16;
//   lse = m + log(max(l, 1e-30)) in f32, one value per (b, h, row), stored
//   as a contiguous (B, H, S) array.
//
// Bound on an H100 at FLUX shapes: operations.  The two products cost
// 4*B*H*S*kv_len*D FLOP against about 4*S*D*2 bytes per head, some S/2 FLOP
// per byte (2304 at S = 4608), far above the card's ~295 FLOP/byte ridge; at
// B = 2, S = 4608, H = 24, D = 128 the bound is 0.528 ms at 989 TFLOP/s.
//
// Design.  One block per (batch*head, 128-row query tile), warp-specialised:
// one producer warpgroup, which drops to 24 registers a thread with
// setmaxnreg, and two consumer warpgroups (64 query rows each, 4 warps of 16
// rows), which rise to 240; one block per SM.
//   Loads: one lane of the producer loads the Q tile once and walks the
//   128-key tiles of K and V through a 2-stage ring in shared memory with
//   TMA (cp.async.bulk.tensor), each stage guarded by a full/empty mbarrier
//   pair (K and V have a full barrier each, so Q.K^T starts before V
//   lands); both consumer warpgroups read every stage, and tile t+1 is in
//   flight while tile t is computed.  The tensor maps are 4-D over
//   (D, S, H, B) with the byte strides the wrapper passes, so bhsd, bshd and
//   projection views of a packed qkv run one code path, with no transposes;
//   TMA zero-fills rows past S or Sk, which replaces load predicates.  Tiles
//   are stored with the 128-byte swizzle (64-byte at D = 32) as boxes of
//   128 rows x 64 columns (128 bytes a row), so a D = 128 tile is two boxes.
//   Products: S = Q.K^T as wgmma m64n128k16 with both operands in shared
//   memory (K-major); O += P.V as wgmma m64nDk16 with P from registers (the
//   S accumulator packed to bf16 is already wgmma's A fragment layout) and
//   V from shared memory read MN-major (the transpose bit), never copied.
//   Softmax: on the accumulator registers; each thread holds two rows, g
//   and g + 8 of its warp's 16, and the row max and sum take two shuffles.
//   exp is ex2.approx with log2(e) folded into one FMA.
//   Masks: decided per tile.  The kv_len compare runs only on the tile that
//   straddles kv_len (or Sk), the bias add only when a bias is given; every
//   other tile takes the unmasked instantiation.  Key tiles at or past
//   kv_len are never loaded (they would add exactly nothing).
//   Epilogue: o and lse go from registers straight to global memory.
// Against the five limits of the mma.sync design this kernel replaced:
// (1) mma.sync m16n8k16 -> wgmma, the only path to the full tensor-core rate;
// (2) loads through registers with two __syncthreads per tile -> TMA issued by
//     one thread of a producer warpgroup, overlapped with compute through the
//     mbarrier ring;
// (3) K fragments read 4x per tile by scalar shared loads -> wgmma reads each
//     operand from shared memory once per warpgroup, conflict-free (swizzle),
//     and two warpgroups share each K/V stage;
// (4) mask work on every tile -> only on the straddling tile and with a bias;
// (5) 64 x 64 tiles in 52 KB -> 128 x 128 tiles in 161 KB (Q 32 KB +
//     2 stages x (K + V) 64 KB at D = 128); the two consumer warpgroups
//     interleave, so one's softmax overlaps the other's products.
// Registers: S 64 + O D/2 f32 accumulators and 32 packed P registers a
// consumer thread (ptxas reports the 168 of __launch_bounds__(384, 1); the
// consumers run with setmaxnreg's 240).  Not done yet: the explicit
// ping-pong of the two warpgroups and the overlap of one tile's softmax with
// the next tile's Q.K^T inside a warpgroup.
//
// cuTensorMapEncodeTiled is a driver API function: it is fetched at first use
// with cudaGetDriverEntryPoint (its form with a cudaDriverEntryPointQueryResult
// argument), so the library links only the CUDA runtime.
//
// Plain C interface for ctypes: flash_attn_fwd(...) launches on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError(),
// or kEncodeError + the CUresult when a tensor map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumerWGs = 2;                // consumer warpgroups
constexpr int kBlockQ = 64 * kConsumerWGs;     // query rows per block
constexpr int kBlockN = 128;                   // keys per tile
constexpr int kStages = 2;                     // depth of the K/V ring
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kThreads = kConsumers + 128;     // + the producer warpgroup
// setmaxnreg budgets: 128 x 24 + 256 x 240 = 64,512 of the SM's 65,536
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeError = 10000;
static_assert(kBlockQ == kBlockN, "Q and K/V tiles share one box shape");

// Shared-memory geometry of a 128-row, D-wide bf16 tile (Q, K or V) as TMA
// writes it: kParts boxes of 128 rows x kBox columns, each row kRowBytes
// long and swizzled in atoms of 8 rows.
template <int D>
struct Tile {
  static constexpr int kBox = D < 64 ? D : 64;
  static constexpr int kParts = D / kBox;
  static constexpr int kRowBytes = kBox * 2;        // 128, or 64 at D = 32
  static constexpr int kAtom = 8 * kRowBytes;       // 8 rows
  static constexpr int kPartBytes = kBlockN * kRowBytes;
  static constexpr int kBytes = kParts * kPartBytes;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // B128 / B64
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

template <int D>
constexpr int smem_bytes() {
  // 1024 bytes of slack to align the tiles to the swizzle atom, then
  // Q, K[kStages], V[kStages], then the barriers
  return 1024 + (1 + 2 * kStages) * Tile<D>::kBytes + 8 * (1 + 3 * kStages);
}

// ---- mbarrier, TMA, wgmma ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// K-major operand (Q as A, K as B of S = Q.K^T), k16 step kk along D: inside
// a swizzled row the step advances the start address by 32 bytes; past the
// first 64 columns it moves to the next box.  SBO = one 8-row atom; LBO is
// not used by swizzled K-major layouts.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using T = Tile<D>;
  const int e = kk * 16;
  return make_desc(tile + (e / T::kBox) * T::kPartBytes + (e % T::kBox) * 2, 16, T::kAtom,
                   T::kLayout);
}

// MN-major operand (V as B of O = P.V: k = keys, n = D contiguous), k16 step
// t over keys: 16 keys are two 8-row atoms.  LBO = the next 64-column box
// along D (N = 128 spans two); SBO = the next 8 keys.
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int t) {
  using T = Tile<D>;
  return make_desc(tile + t * 2 * T::kAtom, T::kPartBytes, T::kAtom, T::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses to wgmma's registers across the
// fence, commit and wait.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S (64 x 128, f32) = A (64 x 16) . B (128 x 16)^T, both K-major in shared
// memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// O (64 x N, f32) += A (64 x 16, bf16 registers) . B (16 x N), B MN-major in
// shared memory (transpose bit set).
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : D8(0), D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : D8(0), D8(8), D8(16), D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef D8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- the online softmax of one key tile ------------------------------------
//
// s holds this thread's scores of the tile in wgmma's accumulator layout:
// s[4j + e] (e = 0, 1) is row g, key 8j + 2*tig + e; s[4j + 2 + e] row g + 8.
// kMask: the tile straddles kv_len; kBias: a key bias is given.  On return
// s holds p = exp(s - m_new), and alpha the factor that rescales the old
// accumulator.
template <bool kMask, bool kBias>
__device__ __forceinline__ void softmax_tile(float (&s)[kBlockN / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2],
                                             const float* bias, int k0, int kv_len,
                                             int tig) {
  if (kMask || kBias) {
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + j * 8 + 2 * tig + e;
        const bool valid = !kMask || col < kv_len;
        const float add = (kBias && valid) ? __ldg(bias + col) : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float x = s[4 * j + 2 * half + e] + add;
          s[4 * j + 2 * half + e] = valid ? x : kNegInf;
        }
      }
    }
  }
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float ms[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
    ms[half] = mx[half] * kLog2e;
    alpha[half] = ex2(fmaf(m_run[half], kLog2e, -ms[half]));
  }
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) {
    const int half = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], kLog2e, -ms[half]));
    rsum[half] += s[i];
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    rsum[half] += __shfl_xor_sync(0xffffffffu, rsum[half], 1);
    rsum[half] += __shfl_xor_sync(0xffffffffu, rsum[half], 2);
    l_run[half] = l_run[half] * alpha[half] + rsum[half];
    m_run[half] = mx[half];
  }
}

// ---- the kernel ---------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                     float* __restrict__ lse, const float* __restrict__ kbias,
                     int64_t ob, int64_t oh, int64_t os, int H, int S, int Sk,
                     int kv_len) {
  using T = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + T::kBytes;                  // + stage * T::kBytes
  const uint32_t sv = sk + kStages * T::kBytes;        // + stage * T::kBytes
  const uint32_t bars = sv + kStages * T::kBytes;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;                    // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tiles = (kv_len + kBlockN - 1) / kBlockN;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ---- producer warpgroup: gives up registers; one lane issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect_tx(q_full, T::kBytes);
#pragma unroll
      for (int p = 0; p < T::kParts; ++p)
        tma_load(sq + p * T::kPartBytes, &tq, p * T::kBox, q0, h, b, q_full);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kStages;
        mbar_wait(empty + 8 * st, ((kt / kStages) & 1) ^ 1);
        const int k0 = kt * kBlockN;
        mbar_expect_tx(k_full + 8 * st, T::kBytes);
#pragma unroll
        for (int p = 0; p < T::kParts; ++p)
          tma_load(sk + st * T::kBytes + p * T::kPartBytes, &tk, p * T::kBox, k0, h, b,
                   k_full + 8 * st);
        mbar_expect_tx(v_full + 8 * st, T::kBytes);
#pragma unroll
        for (int p = 0; p < T::kParts; ++p)
          tma_load(sv + st * T::kBytes + p * T::kPartBytes, &tv, p * T::kBox, k0, h, b,
                   v_full + 8 * st);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each, sharing every K/V stage ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const uint32_t sq_wg = sq + wg * 64 * T::kRowBytes;  // this warpgroup's Q rows
  const int g = lane >> 2;   // row group of the accumulator fragments
  const int tig = lane & 3;  // thread within the group
  const float* bias = kbias ? kbias + static_cast<int64_t>(b) * Sk : nullptr;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[kBlockN / 2];
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) s[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % kStages;
    const uint32_t parity = (kt / kStages) & 1;
    const int k0 = kt * kBlockN;

    // S = Q.K^T
    mbar_wait(k_full + 8 * st, parity);
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(s, kmajor_desc<D>(sq_wg, kk), kmajor_desc<D>(sk + st * T::kBytes, kk),
                    kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_operands(s);

    float alpha[2];
    const bool straddles = kt == n_tiles - 1 && kv_len % kBlockN != 0;
    if (bias != nullptr) {
      if (straddles)
        softmax_tile<true, true>(s, m_run, l_run, alpha, bias, k0, kv_len, tig);
      else
        softmax_tile<false, true>(s, m_run, l_run, alpha, bias, k0, kv_len, tig);
    } else {
      if (straddles)
        softmax_tile<true, false>(s, m_run, l_run, alpha, bias, k0, kv_len, tig);
      else
        softmax_tile<false, false>(s, m_run, l_run, alpha, bias, k0, kv_len, tig);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n + 0] *= alpha[0];
      acc[4 * n + 1] *= alpha[0];
      acc[4 * n + 2] *= alpha[1];
      acc[4 * n + 3] *= alpha[1];
    }
    // P in bf16: the accumulators of key blocks 2t and 2t + 1 are the A
    // fragment of k16 step t.
    uint32_t pa[kBlockN / 16][4];
#pragma unroll
    for (int t = 0; t < kBlockN / 16; ++t) {
      pa[t][0] = Mma<bf16>::pack(s[8 * t + 0], s[8 * t + 1]);
      pa[t][1] = Mma<bf16>::pack(s[8 * t + 2], s[8 * t + 3]);
      pa[t][2] = Mma<bf16>::pack(s[8 * t + 4], s[8 * t + 5]);
      pa[t][3] = Mma<bf16>::pack(s[8 * t + 6], s[8 * t + 7]);
    }

    // O += P.V
    mbar_wait(v_full + 8 * st, parity);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kBlockN / 16; ++t)
      WgmmaRS<D>::run(acc, pa[t], mnmajor_desc<D>(sv + st * T::kBytes, t));
    wgmma_commit();
    wgmma_wait();
    fence_operands(acc);
    mbar_arrive(empty + 8 * st);
  }

  const int bq = q0 + warp * 16 + g;  // consumer warp w holds rows 16w .. 16w + 15
  bf16* obh = o + b * ob + h * oh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = bq + 8 * half;
    if (row >= S) continue;
    const float l = fmaxf(l_run[half], 1e-30f);
    if (lse != nullptr && tig == 0)  // the row's four lanes hold equal m, l
      lse[static_cast<int64_t>(bh) * S + row] = m_run[half] + logf(l);
    bf16* orow = obh + row * os + 2 * tig;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          Mma<bf16>::pack(acc[4 * n + 2 * half] / l, acc[4 * n + 2 * half + 1] / l);
  }
}

// ---- host side -------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 4-D map over (D, S, H, B): geom = the four dims, then the byte strides
// of S, H and B (the wrapper's _tma_geometry).  Box: kBox columns x 128 rows.
template <int D>
int encode(CUtensorMap* map, const void* ptr, const int64_t* geom) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(geom[0]), static_cast<cuuint64_t>(geom[1]),
                              static_cast<cuuint64_t>(geom[2]), static_cast<cuuint64_t>(geom[3])};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(geom[4]),
                                 static_cast<cuuint64_t>(geom[5]),
                                 static_cast<cuuint64_t>(geom[6])};
  const cuuint32_t box[4] = {Tile<D>::kBox, kBlockN, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
         unit, CU_TENSOR_MAP_INTERLEAVE_NONE, Tile<D>::kSwizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const float* kbias, const int64_t* geom, int64_t ob, int64_t oh, int64_t os,
           int B, int H, int S, int Sk, int kv_len, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = encode<D>(&maps[i], ptrs[i], geom + 7 * i);
    if (err != 0) return err;
  }
  // 161 KB at D = 128: above the 48 KB default, so opt in (per device, per
  // call: the call costs far less than the launch).
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, kbias, ob, oh, os, H, S, Sk,
      kv_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// geom: 21 int64 values, seven for each of q, k and v in that order: the
// dims (D, S, H, B) and the byte strides of the S, H and B axes.  o's
// element strides (batch, head, sequence) follow; its last axis is contiguous.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, const void* kbias, const int64_t* geom,
                              int64_t ob, int64_t oh, int64_t os, int B, int H, int S,
                              int Sk, int D, int kv_len, void* stream) {
  float* l = static_cast<float*>(lse);
  const float* kb = static_cast<const float*>(kbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, l, kb, geom, ob, oh, os, B, H, S, Sk, kv_len, st);
    case 64:
      return launch<64>(q, k, v, o, l, kb, geom, ob, oh, os, B, H, S, Sk, kv_len, st);
    case 128:
      return launch<128>(q, k, v, o, l, kb, geom, ob, oh, os, B, H, S, Sk, kv_len, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one block at head dim D, in bytes (-1 for a head
// dim the kernel does not take); read by reports, never by a launch.
extern "C" int flash_attn_fwd_smem_bytes(int D) {
  switch (D) {
    case 32:
      return smem_bytes<32>();
    case 64:
      return smem_bytes<64>();
    case 128:
      return smem_bytes<128>();
    default:
      return -1;
  }
}
