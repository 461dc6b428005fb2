// bf16 implicit-GEMM convolution for Hopper (sm_90a), NHWC, shared by the
// bf16 convolution (conv2d_bf16.cu) and the bf16 fused self-attention's QKV
// projection (attention_fused_bf16.cu, as a 1x1 convolution over the rows):
//   out[b, oy, ox, co] = bf16(sum over (ky, kx, ci) of
//       x[b, oy*s + ky - pt, ox*s + kx - pl, ci] * w[co, ky, kx, ci])
// bf16 products, fp32 sums, one rounding at the end, no bias.
//
// Design: the tiling of the int8 conv kernel (conv2d_int8.cu) in bf16. The
// GEMM is M = B*OH*OW pixels by N = Cout by K = KH*KW*Cin. One block of 8
// warps computes a 128 x 128 output tile, each warp a 32 x 64 part of it with
// mma.sync m16n8k16 (bf16_mma.cuh), its fp32 accumulators in registers. K is
// walked in chunks of 32 channels (64 bytes) of one tap (Cin is a multiple of
// 32); for each chunk every thread copies 32 bytes of the A tile (16 channels
// of one pixel at one tap, zero-filled outside the frame, which is the
// convolution's zero padding) and 32 bytes of the B tile (16 weights of one
// output channel) into shared memory with cp.async, four chunks in flight.
// Shared rows are 40 bf16 (80 bytes, 16 more than a multiple of 32), so a
// fragment load touches 8 different bank groups. Weights are
// [Cout, KH, KW, Cin]: B is K-contiguous, as the "col" operand of the mma
// takes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "int8_mma.cuh"

namespace d3r {

struct ConvBf16Args {
  const __nv_bfloat16* x;  // [B, H, W, Cin]
  const __nv_bfloat16* w;  // [Cout, KH, KW, Cin]
  __nv_bfloat16* out;      // [B, OH, OW, Cout]
  int B, H, W, Cin, OH, OW, Cout, KH, KW, stride, pad_t, pad_l;
};

constexpr int kCbBM = 128;     // pixels per block
constexpr int kCbBN = 128;     // output channels per block
constexpr int kCbBK = 32;      // channels of K per chunk
constexpr int kCbStages = 4;   // chunks in flight
constexpr int kCbLd = kCbBK + 8;  // shared row pitch, bf16
constexpr int kCbThreads = 256;
constexpr size_t kCbStageElems = (size_t)(kCbBM + kCbBN) * kCbLd;
constexpr size_t kCbSmemBytes = kCbStages * kCbStageElems * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(kCbThreads) conv_bf16_kernel(ConvBf16Args a) {
  extern __shared__ __align__(128) __nv_bfloat16 smem_cb[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int M = a.B * a.OH * a.OW;
  const int K = a.KH * a.KW * a.Cin;
  const int chunks_per_tap = a.Cin / kCbBK;
  const int n_chunks = a.KH * a.KW * chunks_per_tap;
  const int m0 = blockIdx.x * kCbBM;
  const int n0 = blockIdx.y * kCbBN;

  // This thread's copies: row tid / 2 of the A and of the B tile, channels
  // [16 * (tid % 2), +16) of the chunk (two 16-byte copies each).
  const int lrow = tid / 2, lc = (tid % 2) * 16;
  const int m = m0 + lrow;
  const bool m_ok = m < M;
  int pb = 0, oy = 0, ox = 0;
  if (m_ok) {
    pb = m / (a.OH * a.OW);
    const int r = m % (a.OH * a.OW);
    oy = r / a.OW;
    ox = r % a.OW;
  }
  const int iy0 = oy * a.stride - a.pad_t;
  const int ix0 = ox * a.stride - a.pad_l;
  const int n = n0 + lrow;
  const bool n_ok = n < a.Cout;
  const __nv_bfloat16* wrow = a.w + (long long)(n_ok ? n : 0) * K + lc;

  auto load_chunk = [&](int slot, int kc) {
    const int tap = kc / chunks_per_tap;
    const int c0 = (kc % chunks_per_tap) * kCbBK;
    const int ky = tap / a.KW, kx = tap % a.KW;
    const int iy = iy0 + ky, ix = ix0 + kx;
    const bool ok = m_ok && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
    const __nv_bfloat16* src =
        ok ? a.x + (((long long)pb * a.H + iy) * a.W + ix) * a.Cin + c0 + lc : a.x;
    const __nv_bfloat16* wsrc = n_ok ? wrow + tap * a.Cin + c0 : a.w;
    __nv_bfloat16* st = smem_cb + slot * kCbStageElems;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      cp_async_16(st + lrow * kCbLd + lc + 8 * v, ok ? src + 8 * v : a.x, ok ? 16 : 0);
      cp_async_16(st + (kCbBM + lrow) * kCbLd + lc + 8 * v, n_ok ? wsrc + 8 * v : a.w,
                  n_ok ? 16 : 0);
    }
  };

  const int wm = (warp % 4) * 32;  // this warp's 32 rows of the tile
  const int wn = (warp / 4) * 64;  // and its 64 columns
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kCbStages - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < n_chunks; ++kc) {
    cp_async_wait<kCbStages - 2>();
    __syncthreads();  // chunk kc has landed; every warp is done with chunk kc - 1
    const int next = kc + kCbStages - 1;
    if (next < n_chunks) load_chunk(next % kCbStages, next);
    cp_async_commit();

    const __nv_bfloat16* as = smem_cb + (kc % kCbStages) * kCbStageElems;
    const __nv_bfloat16* bs = as + kCbBM * kCbLd;
#pragma unroll
    for (int ks = 0; ks < kCbBK / 16; ++ks) {
      uint32_t af[2][4];
      load_a_bf16(af[0], as, kCbLd, wm, ks * 16, lane);
      load_a_bf16(af[1], as, kCbLd, wm + 16, ks * 16, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        load_b_bf16(b0, b1, bs, kCbLd, wn + j * 8, ks * 16, lane);
        mma_bf16(acc[0][j], af[0], b0, b1);
        mma_bf16(acc[1][j], af[1], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    if (col >= a.Cout) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + 8 * h;
        if (row >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(a.out + (long long)row * a.Cout + col) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// Launch on `stream`: Cin % 32 == 0, Cout % 2 == 0, every pointer 16-byte
// aligned and contiguous. Returns cudaGetLastError().
inline cudaError_t launch_conv_bf16(const ConvBf16Args& a, cudaStream_t stream) {
  if (a.B <= 0 || a.OH <= 0 || a.OW <= 0 || a.Cin % kCbBK != 0 || a.Cout % 2 != 0 ||
      a.stride <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kCbSmemBytes);
  if (err != cudaSuccess) return err;
  const long long M = (long long)a.B * a.OH * a.OW;
  const dim3 grid((unsigned)((M + kCbBM - 1) / kCbBM), (unsigned)((a.Cout + kCbBN - 1) / kCbBN));
  conv_bf16_kernel<<<grid, kCbThreads, kCbSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace d3r
