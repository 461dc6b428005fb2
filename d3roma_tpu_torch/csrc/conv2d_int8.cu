// int8 implicit-GEMM convolution for Hopper (sm_90a), NHWC, with the
// dequantization and the bias in the epilogue:
//   out[b, oy, ox, co] = bf16(bf16(deq(acc)) + bias[co])   (bf16 output), or
//   out[b, oy, ox, co] = deq(acc)                          (fp32 output, no bias)
//   acc = sum over (ky, kx, ci) of xq[b, oy*s + ky - pt, ox*s + kx - pl, ci]
//                                  * wq[co, ky, kx, ci]          (exact int32)
// in one of three epilogues, each the order of arithmetic of one reference:
//   "xla"  (0): deq = (acc * act_scale) * ws[co], the XLA int8 convolution of
//               the JAX package's quant="static" mode
//               (ops/quant.py::int8_conv_general_dilated_static);
//   "tpu"  (1): deq = acc * (act_scale * ws[co]), the Pallas kernels
//               conv2d.py::conv3x3_flat (_kernel_int8, quant="mxu") and
//               conv2d.py::conv3x3_rowtap (_kernel_rowtap_int8);
//   "halo" (2): as "tpu", but the sum is taken as conv2d_halo.py::_kernel
//               takes it: one exact int32 partial per row of taps (ky), each
//               converted to fp32 and added to an fp32 sum in ky order. It
//               differs from "tpu" once a partial or the sum passes 2^24.
//
// Replaces: d3roma_tpu/ops/pallas/conv2d.py::conv3x3_flat, its int8 path
// (kernel body _kernel_int8), conv2d.py::conv3x3_rowtap and
// conv2d_halo.py::conv3x3_halo (int8 body), and with them the XLA int8
// convolution that the JAX package's static modes run at every other
// quantized site: the 3x3 stride-1 convs of the resnets and upsamplers, the
// stride-2 downsamplers (UNet: padding 1; VAE: padding (0, 1) and VALID) and
// the 1x1 conv_shortcut. All compute the same integers: per-output-channel
// weight scales over all KH*KW*Cin taps (zero channels that the TPU kernels
// pad on change neither the scales nor the sums), activations quantized with
// one static scale, exact int32 sums. The TPU kernels hold a whole padded
// frame (or a window of rows) in VMEM and run the taps as row-shifted GEMMs;
// a Hopper block cannot hold a frame (the VAE's full-resolution frames are
// 29 MB each), so this kernel gathers its input patches itself (implicit
// GEMM) and tiles over pixels.
//
// What bounds it on the H100: operations. Each input element takes part in
// 2*Cout*KH*KW/stride^2 operations: 2304 at the VAE's full-resolution
// 128-channel 3x3 convs, far more at the UNet's, against the ~590 operations
// per byte where the int8 tensor cores (1979 TOP/s), not memory, become the
// limit. Only the 1x1 shortcuts at 128-256 channels come near the ridge.
//
// Design: the GEMM is M = B*OH*OW pixels by N = Cout by K = KH*KW*Cin. One
// block of 8 warps computes a 128 x 128 output tile; each warp a 32 x 64
// part of it with mma.sync m16n8k32 (int8, int32 accumulation in registers).
// K is walked in chunks of 32 bytes, each within one tap (Cin is a multiple
// of 32). For each chunk, every thread copies 16 bytes of the A tile (one
// pixel's 32 channels of one tap, zero-filled outside the frame, which is the
// convolution's zero padding) and 16 bytes of the B tile (one output
// channel's 32 weights) into shared memory with cp.async, four chunks in
// flight. So x is read once per tap and per column tile from L2, and no
// im2col buffer or padded copy is made. Weights are [Cout, KH, KW, Cin] so
// that B is K-contiguous, as the int8 mma needs. K runs tap by tap in (ky,
// kx) order, so the "halo" epilogue converts the int32 registers to its fp32
// sum (and clears them) after the last chunk of each ky row. The epilogue is
// a template parameter: the other two keep no fp32 sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using d3r::cp_async_16;

constexpr int kBM = 128;      // pixels per block
constexpr int kBN = 128;      // output channels per block
constexpr int kBK = 32;       // bytes of K per chunk
constexpr int kStages = 4;    // chunks in flight
constexpr int kLd = kBK + 16; // shared row pitch, bytes
constexpr int kThreads = 256;
constexpr size_t kStageBytes = (size_t)(kBM + kBN) * kLd;
constexpr size_t kSmemBytes = kStages * kStageBytes;

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  const float* ws;
  const bf16* bias;  // may be null; bf16 output only
  void* out;         // bf16, or fp32 with out_f32
  int B, H, W, Cin, OH, OW, Cout, KH, KW, stride, pad_t, pad_l;
  float act_scale;
  int out_f32;
};

enum Epilogue { kXla = 0, kTpu = 1, kHalo = 2 };

template <int kEpi>
__global__ void __launch_bounds__(kThreads) conv_int8_kernel(ConvArgs a) {
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int M = a.B * a.OH * a.OW;
  const int K = a.KH * a.KW * a.Cin;
  const int chunks_per_tap = a.Cin / kBK;
  const int n_chunks = a.KH * a.KW * chunks_per_tap;
  const int chunks_per_row = a.KW * chunks_per_tap;  // one ky row of taps
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // This thread's copies: row tid / 2 of the A and of the B tile, half tid % 2.
  const int lrow = tid / 2, lhalf = (tid % 2) * 16;
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
  const int8_t* wrow = a.w + (long long)(n_ok ? n : 0) * K + lhalf;

  auto load_chunk = [&](int slot, int kc) {
    const int tap = kc / chunks_per_tap;
    const int c0 = (kc % chunks_per_tap) * kBK;
    const int ky = tap / a.KW, kx = tap % a.KW;
    const int iy = iy0 + ky, ix = ix0 + kx;
    const bool ok = m_ok && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
    const int8_t* src =
        ok ? a.x + (((long long)pb * a.H + iy) * a.W + ix) * a.Cin + c0 + lhalf : a.x;
    int8_t* st = smem + slot * kStageBytes;
    cp_async_16(st + lrow * kLd + lhalf, src, ok ? 16 : 0);
    cp_async_16(st + (kBM + lrow) * kLd + lhalf, n_ok ? wrow + tap * a.Cin + c0 : a.w,
                n_ok ? 16 : 0);
  };

  const int wm = (warp % 4) * 32;  // this warp's 32 rows of the tile
  const int wn = (warp / 4) * 64;  // and its 64 columns
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
  // "halo": the fp32 sum of the finished ky rows' int32 partials
  float facc[2][8][4];
  if (kEpi == kHalo) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        facc[i][j][0] = facc[i][j][1] = facc[i][j][2] = facc[i][j][3] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    d3r::cp_async_commit();
  }
  for (int kc = 0; kc < n_chunks; ++kc) {
    d3r::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk kc has landed; every warp is done with chunk kc - 1
    const int next = kc + kStages - 1;
    if (next < n_chunks) load_chunk(next % kStages, next);
    d3r::cp_async_commit();

    const int8_t* as = smem + (kc % kStages) * kStageBytes;
    const int8_t* bs = as + kBM * kLd;
    uint32_t af[2][4];
    d3r::load_a(af[0], as, kLd, wm, 0, lane);
    d3r::load_a(af[1], as, kLd, wm + 16, 0, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b0, b1;
      d3r::load_b(b0, b1, bs, kLd, wn + j * 8, 0, lane);
      d3r::mma_s8(acc[0][j], af[0], b0, b1);
      d3r::mma_s8(acc[1][j], af[1], b0, b1);
    }
    if (kEpi == kHalo && (kc + 1) % chunks_per_row == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            facc[i][j][e] = __fadd_rn(facc[i][j][e], __int2float_rn(acc[i][j][e]));
            acc[i][j][e] = 0;
          }
    }
  }
  d3r::cp_async_wait<0>();

  // Epilogue: the dequantization in fp32, cast, + bias in bf16.
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    if (col >= a.Cout) continue;
    const float s0 = kEpi == kXla ? a.ws[col] : __fmul_rn(a.act_scale, a.ws[col]);
    const float s1 = kEpi == kXla ? a.ws[col + 1] : __fmul_rn(a.act_scale, a.ws[col + 1]);
    const float bias0 = a.bias ? __bfloat162float(a.bias[col]) : 0.f;
    const float bias1 = a.bias ? __bfloat162float(a.bias[col + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + 8 * h;
        if (row >= M) continue;
        float v0, v1;
        if (kEpi == kXla) {
          v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), a.act_scale), s0);
          v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), a.act_scale), s1);
        } else {
          const float p0 = kEpi == kHalo ? facc[i][j][2 * h]
                                         : __int2float_rn(acc[i][j][2 * h]);
          const float p1 = kEpi == kHalo ? facc[i][j][2 * h + 1]
                                         : __int2float_rn(acc[i][j][2 * h + 1]);
          v0 = __fmul_rn(p0, s0);
          v1 = __fmul_rn(p1, s1);
        }
        const long long at = (long long)row * a.Cout + col;
        if (a.out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at) = make_float2(v0, v1);
          continue;
        }
        if (a.bias) {
          v0 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(v0)), bias0);
          v1 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(v1)), bias1);
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + at) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int kEpi>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_int8_kernel<kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long M = (long long)a.B * a.OH * a.OW;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((a.Cout + kBN - 1) / kBN));
  conv_int8_kernel<kEpi><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x [B, H, W, Cin] int8, w [Cout, KH, KW, Cin] int8, ws [Cout] fp32, bias
// [Cout] bf16 or null, out [B, OH, OW, Cout] bf16 (fp32 with out_f32, then
// bias null); all contiguous and 16-byte aligned. Cin % 32 == 0, Cout % 2 ==
// 0. epilogue: 0 "xla", 1 "tpu", 2 "halo" (see the top of this file).
// Returns cudaGetLastError().
extern "C" int d3r_conv2d_int8(const void* x, const void* w, const void* ws, const void* bias,
                               void* out, int B, int H, int W, int Cin, int OH, int OW,
                               int Cout, int KH, int KW, int stride, int pad_t, int pad_l,
                               float act_scale, int epilogue, int out_f32, void* stream) {
  if (B <= 0 || OH <= 0 || OW <= 0 || Cin % kBK != 0 || Cout % 2 != 0 || stride <= 0 ||
      (out_f32 && bias))
    return (int)cudaErrorInvalidValue;
  ConvArgs a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
             static_cast<const float*>(ws), static_cast<const bf16*>(bias),
             out, B, H, W, Cin, OH, OW, Cout, KH, KW, stride, pad_t, pad_l, act_scale,
             out_f32};
  auto st = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kXla:
      return (int)launch<kXla>(a, st);
    case kTpu:
      return (int)launch<kTpu>(a, st);
    case kHalo:
      return (int)launch<kHalo>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
