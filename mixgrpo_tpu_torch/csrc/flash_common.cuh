// Pieces shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the packing of two f32 values into one bf16x2 register.
//
// A wgmma accumulator fragment holds, for each row it owns, pairs of
// neighbouring columns (2t, 2t + 1 of every 8-column block, t = lane % 4);
// packed to bf16 pair by pair, the accumulators of two neighbouring 8-column
// blocks are the register A fragment of a k16 step over those 16 columns, so
// a product's result feeds the next product without leaving registers.

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
};

}  // namespace
