// Pieces shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the bf16 tensor-core product mma.sync m16n8k16 with f32
// accumulation, the packing of two f32 values into its bf16x2 operand, and
// the shared-memory loads that build its fragments.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same
//     cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, k x n): b0 (k 2t, 2t+1; n g), b1 (k 2t+8, 2t+9; n g);
//   C (16 x 8): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols).
// So the accumulators of two neighbouring 8-column tiles are, once packed to
// bf16, the A fragment of a k16 step over those 16 columns: a product's
// result feeds the next product without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// Four 8x8 b16 matrices from shared memory, each delivered transposed: the
// operand whose k axis is the stored tile's row axis (V of P.V, read from a
// row-major (key, d) tile).  Lanes 8i..8i+7 give the row addresses of matrix
// i, which lands in r[i].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace
