// Shared pieces of the int8 kernels (conv2d_int8.cu, attention_int8.cu,
// geglu_int8.cu): 16-byte cp.async copies and the int8 tensor-core product
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32.
//
// Fragments of m16n8k32 (PTX ISA, "Matrix fragments for mma.m16n8k32"),
// with g = lane / 4 and t = lane % 4:
//   A (16 x 32, row-major): a0 = row g, bytes 4t..4t+3; a1 = row g + 8, same
//     bytes; a2 = row g, bytes 16 + 4t..; a3 = row g + 8, bytes 16 + 4t..
//   B (32 x 8, "col": stored as 8 rows of 32 k-contiguous bytes): b0 = row g,
//     bytes 4t..4t+3; b1 = row g, bytes 16 + 4t..
//   C (16 x 8, int32): c0, c1 = row g, columns 2t, 2t + 1; c2, c3 = row g + 8.
// So both operands are read from shared memory with one aligned 32-bit load
// per register, as long as the contraction axis is contiguous in both: A
// [rows, K] and B [cols, K]. The kernels lay their shared tiles out that way,
// with rows padded by 16 bytes: a row pitch of 16 more than a multiple of 32
// bytes puts the 8 rows a fragment load touches on 8 different groups of 4
// banks, so the load has no bank conflict.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace d3r {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// c += a (16 x 32 int8, row) * b (32 x 8 int8, col), int32 accumulation.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [row0, row0 + 16), bytes [k0, k0 + 32) of a
// row-major int8 tile with a pitch of `ld` bytes.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* tile, int ld, int row0,
                                       int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int8_t* p = tile + (row0 + g) * ld + k0 + 4 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 16);
}

// The B fragment of columns [col0, col0 + 8), bytes [k0, k0 + 32) of a tile
// stored as rows of k-contiguous bytes (one row per column of B).
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const int8_t* tile, int ld,
                                       int col0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int8_t* p = tile + (col0 + g) * ld + k0 + 4 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 16);
}

}  // namespace d3r
