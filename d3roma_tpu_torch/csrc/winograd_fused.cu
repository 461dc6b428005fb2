// Stride-1 SAME 3x3 convolution by Winograd F(2x2, 3x3) for Hopper (sm_90a),
// NHWC, bf16 in and out:
//   per 2x2 output tile: d = the 4x4 input patch (zero outside the frame),
//   V = B^T d B in fp32, rounded to bf16; M_t = sum over c of V_t[c] U_t[c, o]
//   for the 16 taps t (bf16 products, fp32 sums); Y = A^T M A in fp32,
//   rounded to bf16; then + bias in bf16 (as Flax adds a conv's bias).
// U = G g G^T is made once per weight by the wrapper ([16, O, C] bf16).
//
// Replaces: d3roma_tpu/ops/pallas/winograd_fused.py::conv3x3_wino_fused
// (kernel body _kernel), which the JAX package's "wino_static" mode runs at
// every stride-1 3x3 conv its pick_config admits. That TPU kernel DMAs a
// window of tile rows into VMEM, keeps all 16 transformed taps V of the
// window there and runs the 16 tap GEMMs against a 128-wide block of U.
//
// What bounds it on the H100: operations. The 16 tap GEMMs do
// 2 * 16 * (H/2)(W/2) * C * O operations (2.25x fewer than the direct conv's
// 2 * 9 * H * W * C * O) against ~2 * H * W * (C + O) bytes: hundreds of
// operations per byte at the UNet's 320-640 channels, above the ~295 per
// byte where the bf16 tensor cores become the limit.
//
// Design: one block of 8 warps computes 32 tiles x 32 output channels, with
// all 16 taps' [32, 32] fp32 accumulators live in registers (each warp owns
// two taps: 2 x 2 x 4 m16n8 fragments, 64 registers a thread). The input
// channels are walked in chunks of 32: each thread holds the 4x4 patch of
// one tile for 4 channels in registers (8-byte loads along C, zero outside
// the frame: the SAME padding and the odd H or W edge), applies B^T d B in
// fp32 and stores each tap's 4 V values, rounded to bf16, as one 8-byte
// store into 16 [32 tiles, 32 channels] shared tiles; the 16 [32 o, 32 c]
// tiles of U arrive by cp.async, double-buffered. The next chunk's patch
// is loaded while the tensor cores run this chunk's 16 tap GEMMs
// (mma.sync m16n8k16, bf16, fp32 accumulation), so neither copy waits.
// After the last chunk the accumulators go through shared memory (the 16
// taps of one (tile, o) sit in 8 warps), and each thread applies A^T M A to
// four (tile, o) pairs and writes the 2x2 outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "int8_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTM = 32;       // tiles per block
constexpr int kTO = 32;       // output channels per block
constexpr int kKC = 32;       // input channels per chunk
constexpr int kLd = kKC + 8;  // shared row pitch, bf16 (80 bytes)
constexpr int kLdm = kTO + 1; // fp32 pitch of the staged accumulators
constexpr int kThreads = 256;
constexpr size_t kVBytes = (size_t)16 * kTM * kLd * sizeof(bf16);
constexpr size_t kUBytes = (size_t)2 * 16 * kTO * kLd * sizeof(bf16);  // 2 buffers
constexpr size_t kMBytes = (size_t)16 * kTM * kLdm * sizeof(float);
constexpr size_t kSmemBytes = (kVBytes + kUBytes) > kMBytes ? (kVBytes + kUBytes) : kMBytes;

struct WinoArgs {
  const bf16* x;     // [B, H, W, C]
  const bf16* u;     // [16, O, C]
  const bf16* bias;  // [O] or null
  bf16* out;         // [B, H, W, O]
  int B, H, W, C, O, Th, Tw;
};

__global__ void __launch_bounds__(kThreads) wino_kernel(WinoArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* vs = reinterpret_cast<bf16*>(smem);
  bf16* us = reinterpret_cast<bf16*>(smem + kVBytes);
  float* ms = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = a.B * a.Th * a.Tw;
  const int m0 = blockIdx.x * kTM, o0 = blockIdx.y * kTO;

  // this thread's input patch: tile lt, channels 4 cg .. 4 cg + 3 of a chunk
  const int lt = tid / 8, cg = tid % 8;
  const int m = m0 + lt;
  const bool m_ok = m < n_tiles;
  int pb = 0, ty = 0, tx = 0;
  if (m_ok) {
    pb = m / (a.Th * a.Tw);
    const int r = m % (a.Th * a.Tw);
    ty = r / a.Tw;
    tx = r % a.Tw;
  }
  const bf16* xb = a.x + (long long)pb * a.H * a.W * a.C;

  float acc[2][2][4][4];  // [tap of this warp][m fragment][n fragment][4]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[i][j][n][0] = acc[i][j][n][1] = acc[i][j][n][2] = acc[i][j][n][3] = 0.f;

  // U of chunk kc into buffer buf: 16 taps x 32 o x 32 c, 16 bytes a copy
  auto load_u = [&](int kc, int buf) {
    bf16* ub = us + buf * 16 * kTO * kLd;
    for (int i = tid; i < 16 * kTO * (kKC / 8); i += kThreads) {
      const int t = i / (kTO * (kKC / 8)), rem = i % (kTO * (kKC / 8));
      const int lo = rem / (kKC / 8), v = rem % (kKC / 8);
      const bool ok = o0 + lo < a.O;
      d3r::cp_async_16(ub + (t * kTO + lo) * kLd + v * 8,
                       ok ? a.u + ((long long)t * a.O + o0 + lo) * a.C + kc * kKC + v * 8 : a.u,
                       ok ? 16 : 0);
    }
  };
  // this thread's 4x4 input patch of chunk kc, 4 channels per position
  // (zero outside the frame)
  uint2 raw[16];
  auto load_patch = [&](int kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = 2 * ty - 1 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ix = 2 * tx - 1 + j;
        raw[i * 4 + j] = make_uint2(0u, 0u);
        if (m_ok && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W) {
          raw[i * 4 + j] = *reinterpret_cast<const uint2*>(
              xb + ((long long)iy * a.W + ix) * a.C + kc * kKC + 4 * cg);
        }
      }
    }
  };

  const int n_chunks = a.C / kKC;
  load_patch(0);
  load_u(0, 0);
  d3r::cp_async_commit();
  for (int kc = 0; kc < n_chunks; ++kc) {
    // V = B^T d B for the 4 channels of this thread's tile, packed per tap
    uint2 packed[16];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float d[4][4];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        d[i / 4][i % 4] = __bfloat162float(reinterpret_cast<const bf16*>(&raw[i])[c]);
      }
      float e[4][4];  // rows combined: e[j][x]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        e[j][0] = __fsub_rn(d[0][j], d[2][j]);
        e[j][1] = __fadd_rn(d[1][j], d[2][j]);
        e[j][2] = __fsub_rn(d[2][j], d[1][j]);
        e[j][3] = __fsub_rn(d[1][j], d[3][j]);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float vv[4] = {__fsub_rn(e[0][x], e[2][x]), __fadd_rn(e[1][x], e[2][x]),
                             __fsub_rn(e[2][x], e[1][x]), __fsub_rn(e[1][x], e[3][x])};
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          reinterpret_cast<bf16*>(&packed[x * 4 + y])[c] = __float2bfloat16_rn(vv[y]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      *reinterpret_cast<uint2*>(vs + (t * kTM + lt) * kLd + 4 * cg) = packed[t];
    }
    // U of the next chunk into the other buffer (its last readers, the
    // previous chunk's products, finished before the barrier ending it)
    if (kc + 1 < n_chunks) load_u(kc + 1, (kc + 1) & 1);
    d3r::cp_async_commit();
    d3r::cp_async_wait<1>();  // U of this chunk has landed
    __syncthreads();          // V and U of this chunk are visible to every warp
    // the next chunk's input patch is in flight while the tensor cores run
    if (kc + 1 < n_chunks) load_patch(kc + 1);

    const bf16* ub = us + (kc & 1) * 16 * kTO * kLd;
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
      const int t = 2 * warp + tt;
      const bf16* vt = vs + t * kTM * kLd;
      const bf16* ut = ub + t * kTO * kLd;
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        uint32_t af[2][4];
        d3r::load_a_bf16(af[0], vt, kLd, 0, ks * 16, lane);
        d3r::load_a_bf16(af[1], vt, kLd, 16, ks * 16, lane);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t b0, b1;
          d3r::load_b_bf16(b0, b1, ut, kLd, n * 8, ks * 16, lane);
          d3r::mma_bf16(acc[tt][0][n], af[0], b0, b1);
          d3r::mma_bf16(acc[tt][1][n], af[1], b0, b1);
        }
      }
    }
    __syncthreads();  // every warp is done with this chunk's V and U
  }
  d3r::cp_async_wait<0>();
  // the V and U tiles are dead: stage the accumulators

  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int tt = 0; tt < 2; ++tt) {
    float* mt = ms + (2 * warp + tt) * kTM * kLdm;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int row = i * 16 + g, col = n * 8 + 2 * t4;
        mt[row * kLdm + col] = acc[tt][i][n][0];
        mt[row * kLdm + col + 1] = acc[tt][i][n][1];
        mt[(row + 8) * kLdm + col] = acc[tt][i][n][2];
        mt[(row + 8) * kLdm + col + 1] = acc[tt][i][n][3];
      }
  }
  __syncthreads();

  for (int idx = tid; idx < kTM * kTO; idx += kThreads) {
    const int r = idx / kTO, lo = idx % kTO;
    const int mm = m0 + r, o = o0 + lo;
    if (mm >= n_tiles || o >= a.O) continue;
    float mv[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) mv[x][y] = ms[((x * 4 + y) * kTM + r) * kLdm + lo];
    float f[2][4];  // A^T over the rows: f[u][y]
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      f[0][y] = __fadd_rn(__fadd_rn(mv[0][y], mv[1][y]), mv[2][y]);
      f[1][y] = __fsub_rn(__fsub_rn(mv[1][y], mv[2][y]), mv[3][y]);
    }
    const int b = mm / (a.Th * a.Tw), rr = mm % (a.Th * a.Tw);
    const int oy0 = 2 * (rr / a.Tw), ox0 = 2 * (rr % a.Tw);
    const float bias = a.bias ? __bfloat162float(a.bias[o]) : 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float y0 = __fadd_rn(__fadd_rn(f[u][0], f[u][1]), f[u][2]);
      const float y1 = __fsub_rn(__fsub_rn(f[u][1], f[u][2]), f[u][3]);
      const float yv[2] = {y0, y1};
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int oy = oy0 + u, ox = ox0 + v;
        if (oy >= a.H || ox >= a.W) continue;
        bf16 val = __float2bfloat16_rn(yv[v]);
        if (a.bias) val = __float2bfloat16_rn(__fadd_rn(__bfloat162float(val), bias));
        a.out[(((long long)b * a.H + oy) * a.W + ox) * a.O + o] = val;
      }
    }
  }
}

}  // namespace

// x [B, H, W, C] bf16, u [16, O, C] bf16, bias [O] bf16 or null, out
// [B, H, W, O] bf16; all contiguous, x and u 16-byte aligned. C % 32 == 0,
// O % 8 == 0. Returns cudaGetLastError().
extern "C" int d3r_conv3x3_winograd(const void* x, const void* u, const void* bias, void* out,
                                    int B, int H, int W, int C, int O, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C % kKC != 0 || C <= 0 || O <= 0 || O % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wino_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int th = (H + 1) / 2, tw = (W + 1) / 2;
  WinoArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(u),
             static_cast<const bf16*>(bias), static_cast<bf16*>(out), B, H, W, C, O, th, tw};
  const long long tiles = (long long)B * th * tw;
  const dim3 grid((unsigned)((tiles + kTM - 1) / kTM), (unsigned)((O + kTO - 1) / kTO));
  wino_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
