// Hopper building blocks shared by the wgmma flash-attention kernels
// (flash_attn_fwd.cu, and the DKV and FUSED modes of flash_attn_bwd.cu): the
// shared-memory geometry of a TMA tile, mbarriers, named barriers, TMA loads
// and reduce-adds, wgmma and its shared-memory descriptors, and, on the host,
// the encoding of a 4-D tensor map.
//
// A tile is ROWS rows of a D-wide bf16 matrix (Q, K, V or dO of one head) as
// TMA writes it: kParts boxes of ROWS rows x kBox columns, each row kRowBytes
// long (128 bytes, or 64 at D = 32) and swizzled in atoms of 8 rows (the
// 128-byte swizzle, or the 64-byte one at D = 32).  A tile base must be
// aligned to 1024 bytes.  Descriptors:
//   K-major (the operand's k axis is D, contiguous in a row): a k16 step
//   advances the start by 32 bytes inside a row and jumps to the next box
//   after kBox columns; SBO = one 8-row atom; LBO is unused by swizzled
//   K-major layouts.
//   MN-major (k runs over the tile's rows, m or n over D, read with the
//   transpose bit): a k16 step is two 8-row atoms; LBO = the next box along
//   m or n (the part size, which depends on ROWS); SBO = the next 8 rows.
//   An operand narrower than a box starts inside the row: the swizzle is a
//   function of the address bits, so the start moves by the column's bytes.
// An f32 tile (F32Tile) is the same with 32-float rows (16 at COLS = 16).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEncodeError = 10000;  // + the CUresult of a failed map encode
constexpr float kLog2e = 1.4426950408889634f;
// setmaxnreg budgets of a block of one producer and two consumer
// warpgroups: 128 x 24 + 256 x 240 = 64,512 of the SM's 65,536 registers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D, int ROWS>
struct Tile {
  static constexpr int kRows = ROWS;
  static constexpr int kBox = D < 64 ? D : 64;
  static constexpr int kParts = D / kBox;
  static constexpr int kRowBytes = kBox * 2;        // 128, or 64 at D = 32
  static constexpr int kAtom = 8 * kRowBytes;       // 8 rows
  static constexpr int kPartBytes = ROWS * kRowBytes;
  static constexpr int kBytes = kParts * kPartBytes;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // B128 / B64
  static constexpr CUtensorMapDataType kDataType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

// ROWS rows x COLS columns of an f32 matrix as TMA reads it for a reduce-add.
template <int COLS, int ROWS>
struct F32Tile {
  static constexpr int kRows = ROWS;
  static constexpr int kBox = COLS < 32 ? COLS : 32;
  static constexpr int kParts = COLS / kBox;
  static constexpr int kRowBytes = kBox * 4;  // 128, or 64 at COLS = 16
  static constexpr int kPartBytes = ROWS * kRowBytes;
  static constexpr int kBytes = kParts * kPartBytes;
  static constexpr CUtensorMapDataType kDataType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

// Where byte `o` of a tile of ROW_BYTES-long rows lands under TMA's swizzle:
// the 16-byte chunk index is XORed with address bits 7-9 (128-byte swizzle)
// or 7-8 (64-byte), so row r's chunk c sits at c ^ (r % 8) in 128-byte rows.
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swizzled(uint32_t o) {
  return o ^ (((o >> 7) & (ROW_BYTES == 128 ? 7u : 3u)) << 4);
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

// Adds one box of f32 values in shared memory to a 4-D tensor map's
// elements (coordinates innermost first), in the issuing thread's bulk
// group; elements outside the map are skipped.
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map, uint32_t src, int c0,
                                               int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until this thread's bulk groups have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Waits until this thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's generic-proxy shared-memory stores visible to the
// async proxy (wgmma and TMA reads); then a barrier hands them on.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x), "f"(y) : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte aligned)
// into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
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

// K-major operand of tile type T starting at `tile`, k16 step kk along D.
template <class T>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  const int e = kk * 16;
  return make_desc(tile + (e / T::kBox) * T::kPartBytes + (e % T::kBox) * 2, 16, T::kAtom,
                   T::kLayout);
}

// MN-major operand of tile type T (k = the tile's rows, n = D), k16 step t.
template <class T>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int t) {
  return make_desc(tile + t * 2 * T::kAtom, T::kPartBytes, T::kAtom, T::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups are still in flight.
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to wgmma's registers (accumulators,
// and A fragments still being read) across the fence, commit and wait.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define D8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 128, f32) = A (64 x 16) . B (128 x 16)^T, both K-major in shared
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

// D (64 x 64, f32) = A (64 x 16) . B (64 x 16)^T, both K-major in shared
// memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x N, f32) = A (64 x 16) . B (16 x N), both MN-major in shared memory
// (both transpose bits set: A's m and B's n run along a tile row); scale_d =
// 0 overwrites d.
template <int N>
struct WgmmaSST;

template <>
struct WgmmaSST<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 1;\n}\n"
        : D8(0)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaSST<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 1, 1;\n}\n"
        : D8(0), D8(8)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaSST<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 1, 1;\n}\n"
        : D8(0), D8(8), D8(16), D8(24)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// D (64 x N, f32) += A (64 x 16, bf16 registers) . B (16 x N), B MN-major in
// shared memory (transpose bit set).  A is the accumulator fragment of an
// earlier product packed to bf16: for k16 step t, the accumulators of column
// blocks 2t and 2t + 1.
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

// ---- host side: tensor maps ---------------------------------------------------
//
// cuTensorMapEncodeTiled lives in libcuda, not in the CUDA runtime: it is
// fetched at first use through the runtime's entry-point query (the form
// with a query-result argument), so a library links only the runtime.

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

// A 4-D map over (D, S, H, B) whose box is one part of tile type T (kBox
// columns x T::kRows rows of T::kDataType): geom = the four dims, then the
// byte strides of S, H and B (the wrapper's _tma_geometry).  Rows past S
// read as zeros, and a reduce-add skips them.
template <class T>
int encode(CUtensorMap* map, const void* ptr, const int64_t* geom) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(geom[0]), static_cast<cuuint64_t>(geom[1]),
                              static_cast<cuuint64_t>(geom[2]), static_cast<cuuint64_t>(geom[3])};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(geom[4]),
                                 static_cast<cuuint64_t>(geom[5]),
                                 static_cast<cuuint64_t>(geom[6])};
  const cuuint32_t box[4] = {T::kBox, T::kRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res =
      fn(map, T::kDataType, 4, const_cast<void*>(ptr), dims, strides, box,
         unit, CU_TENSOR_MAP_INTERLEAVE_NONE, T::kSwizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

}  // namespace
