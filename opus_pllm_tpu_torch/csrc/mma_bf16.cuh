// Warp-level bf16 tensor-core helpers of the mma.sync kernels
// (int4_matmul.cu's tensor-core kernel, and int4_matmul_v1.cu's kernel kept
// for unaligned N).
//
// mma16816: one m16n8k16 product, bf16 inputs, fp32 accumulators in place.
// With lane = 4 * g + t, the A fragment holds rows g and g + 8 at columns
// 2t, 2t + 1 (+ 8); the B fragment column g at rows 2t, 2t + 1 (+ 8); the
// accumulator c[0..1] row g, c[2..3] row g + 8, at columns 2t, 2t + 1. So
// an accumulator pair of two adjacent n-tiles is already the A fragment of
// the next product (the P . V step of an online softmax).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace opus_mma {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> a bf16 pair (round to nearest even), low half first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 values -> one 32-bit register, low half first
__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

}  // namespace opus_mma
