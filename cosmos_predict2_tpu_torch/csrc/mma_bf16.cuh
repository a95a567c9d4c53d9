// Warp-level bf16 tensor-core helpers shared by the port's kernels.
//
// mma.sync.m16n8k16 (bf16 x bf16 -> fp32) with the fragment layout of the
// PTX ISA ("Matrix Fragments for mma.m16n8k16"), lane = 4 * g + t:
//   A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//     a[0] = A[g][2t, 2t+1]      a[1] = A[g+8][2t, 2t+1]
//     a[2] = A[g][2t+8, 2t+9]    a[3] = A[g+8][2t+8, 2t+9]
//   B (16 x 8, k x n):
//     b0 = B[2t, 2t+1][g]        b1 = B[2t+8, 2t+9][g]
//   C / D (16 x 8, fp32):
//     c[0], c[1] = C[g][2t, 2t+1]    c[2], c[3] = C[g+8][2t, 2t+1]
// The element with the lower column (or k) index sits in the low 16 bits.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace cosmos_kernels {

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 at consecutive addresses -> one register
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from anywhere -> one register (lo in the low half)
__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two fp32 rounded to bf16 -> one register (lo in the low half)
__device__ __forceinline__ uint32_t pack_float_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace cosmos_kernels
