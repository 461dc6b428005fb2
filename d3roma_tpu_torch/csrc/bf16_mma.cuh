// bf16 tensor-core product of the Winograd and fused-attention kernels
// (winograd_fused.cu, attention_fused_int8.cu):
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, with its fragments read from
// shared tiles whose contraction axis is contiguous in both operands.
//
// Fragments of m16n8k16 (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4, each register two bf16 values:
//   A (16 x 16, row-major): a0 = row g, k 2t..2t+1; a1 = row g + 8, same k;
//     a2 = row g, k 2t+8..2t+9; a3 = row g + 8, k 2t+8..2t+9
//   B (16 x 8, "col": stored as 8 rows of 16 k-contiguous values): b0 = row
//     g, k 2t..2t+1; b1 = row g, k 2t+8..2t+9
//   C (16 x 8, fp32): c0, c1 = row g, columns 2t, 2t + 1; c2, c3 = row g + 8.
// A row pitch of 16 bytes more than a multiple of 32 (e.g. 40 or 72 bf16)
// puts the 8 rows a fragment load touches on different banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace d3r {

// c += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [row0, row0 + 16), k [k0, k0 + 16) of a row-major
// bf16 tile with a pitch of `ld` elements.
__device__ __forceinline__ void load_a_bf16(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                            int row0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = tile + (row0 + g) * ld + k0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// The B fragment of columns [col0, col0 + 8), k [k0, k0 + 16) of a tile
// stored as rows of k-contiguous bf16 values (one row per column of B).
__device__ __forceinline__ void load_b_bf16(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* tile, int ld, int col0, int k0,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = tile + (col0 + g) * ld + k0 + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

}  // namespace d3r
