// The output projection of the fused self-attention kernels
// (attention_fused_int8.cu, attention_fused_bf16.cu), as the TPU kernel
// accumulates it (d3roma_tpu/ops/pallas/attention_fused.py, both bodies):
//   out = bf16(bo + sum over heads h, in head order, of o_h . Wo_h)
// o_h the bf16 attention output of head h (64 columns of o), Wo_h its 64
// input columns of Wo; bf16 products, an fp32 partial per head added to the
// fp32 sum that starts at the bias.
//
// Design: 128 x 128 output tiles of 8 warps (32 x 64 each, mma.sync
// m16n8k16), one 64-wide k step per head, the next head's o and Wo slices
// loaded by cp.async while this head's products run. The TPU kernel keeps
// its [256, C] fp32 sum in VMEM across the heads; here each block keeps its
// tile's sum in registers, and o_h comes from device memory (2 N C bytes a
// batch item), written there by the attention kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "int8_mma.cuh"

namespace d3r {

using bf16 = __nv_bfloat16;

constexpr int kOpHeadDim = 64;
constexpr int kOpBM = 128, kOpBN = 128, kOpThreads = 256;

struct OutProjArgs {
  const bf16* o;    // [rows, C]
  const bf16* wo;   // [C, C]: output column, then input (k-contiguous)
  const float* bo;  // [C]
  bf16* out;        // [rows, C]
  int rows, C, H;
};

constexpr int kOpLd = kOpHeadDim + 8;  // shared row pitch, bf16 (144 bytes)
constexpr size_t kOpStage = (size_t)(kOpBM + kOpBN) * kOpLd * sizeof(bf16);
constexpr size_t kOpSmem = 2 * kOpStage;

// grid (ceil(rows / 128), ceil(C / 128)); each warp 32 rows x 64 columns.
__global__ void __launch_bounds__(kOpThreads) out_proj_kernel(OutProjArgs a) {
  extern __shared__ __align__(128) unsigned char smemo[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kOpBM, n0 = blockIdx.y * kOpBN;

  auto load_head = [&](int buf, int h) {
    bf16* as = reinterpret_cast<bf16*>(smemo + buf * kOpStage);
    bf16* bs = as + kOpBM * kOpLd;
    for (int i = tid; i < (kOpBM + kOpBN) * (kOpHeadDim / 8); i += kOpThreads) {
      const int r = i / (kOpHeadDim / 8), v = (i % (kOpHeadDim / 8)) * 8;
      if (r < kOpBM) {
        const bool ok = m0 + r < a.rows;
        cp_async_16(as + r * kOpLd + v,
                    ok ? a.o + (long long)(m0 + r) * a.C + h * kOpHeadDim + v : a.o, ok ? 16 : 0);
      } else {
        const int rr = r - kOpBM;
        const bool ok = n0 + rr < a.C;
        cp_async_16(bs + rr * kOpLd + v,
                    ok ? a.wo + (long long)(n0 + rr) * a.C + h * kOpHeadDim + v : a.wo,
                    ok ? 16 : 0);
      }
    }
  };

  const int wm = (warp % 4) * 32, wn = (warp / 4) * 64;
  const int g = lane / 4, t = lane % 4;
  float acc[2][8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    const float b0 = col < a.C ? a.bo[col] : 0.f, b1 = col + 1 < a.C ? a.bo[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      acc[i][j][0] = acc[i][j][2] = b0;
      acc[i][j][1] = acc[i][j][3] = b1;
    }
  }

  load_head(0, 0);
  d3r::cp_async_commit();
  for (int h = 0; h < a.H; ++h) {
    d3r::cp_async_wait<0>();
    __syncthreads();  // head h has landed; every warp is done with head h - 1
    if (h + 1 < a.H) load_head((h + 1) & 1, h + 1);
    d3r::cp_async_commit();
    const bf16* as = reinterpret_cast<const bf16*>(smemo + (h & 1) * kOpStage);
    const bf16* bs = as + kOpBM * kOpLd;
    float part[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kOpHeadDim / 16; ++ks) {
      uint32_t af[2][4];
      d3r::load_a_bf16(af[0], as, kOpLd, wm, ks * 16, lane);
      d3r::load_a_bf16(af[1], as, kOpLd, wm + 16, ks * 16, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        d3r::load_b_bf16(b0, b1, bs, kOpLd, wn + j * 8, ks * 16, lane);
        d3r::mma_bf16(part[0][j], af[0], b0, b1);
        d3r::mma_bf16(part[1][j], af[1], b0, b1);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
  }
  d3r::cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    if (col >= a.C) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm + i * 16 + g + 8 * hh;
        if (row >= a.rows) continue;
        *reinterpret_cast<__nv_bfloat162*>(a.out + (long long)row * a.C + col) =
            __floats2bfloat162_rn(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
      }
    }
  }
}

// Launch on `stream`: C = 64 H, every pointer 16-byte aligned, o and out
// contiguous. Returns cudaGetLastError().
inline cudaError_t launch_out_proj(const OutProjArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(out_proj_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kOpSmem);
  if (err != cudaSuccess) return err;
  out_proj_kernel<<<dim3((a.rows + kOpBM - 1) / kOpBM, (a.C + kOpBN - 1) / kOpBN), kOpThreads,
                    kOpSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace d3r
