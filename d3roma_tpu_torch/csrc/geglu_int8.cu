// Fused GEGLU feed-forward for Hopper (sm_90a) with both products in int8:
//   h = (xq . W1h) * d1h + b1h,  g = (xq . W1g) * d1g + b1g     (fp32)
//   y = h * gelu_tanh(g);  yq = round(y / sy)   (sy per tile, see below)
//   out = bf16(b2 + sum over F chunks of (yq . W2) * (sy * s2))
// with x quantized by the wrapper at the static activation scale, the
// weights per column (d1h = act_scale * s1h, d1g likewise).
//
// Replaces: d3roma_tpu/ops/pallas/geglu.py::geglu_ff, its int8 path (kernel
// body _kernel_int8). That TPU kernel walks row blocks of 2048 (C <= 640) or
// 512 rows, pads the rows to that block with zeros, and re-quantizes the
// gated intermediate y with one absmax per tile of sub_rows x blk_cols
// (sub_rows 512 or 256; blk_cols 640 at F = 1280 and 2560, 1024 at
// F = 5120). The zero-padded rows reach that absmax too, as b1h * gelu(b1g).
//
// What bounds it on the H100: operations. Per row the two products do
// 6*C*F int8 operations against the weights (3*C*F bytes), read once per
// row tile; at the flagship widths (C, F) = (320, 1280), (640, 2560),
// (1280, 5120) and 120-7200 rows the products dominate.
//
// Design: a Hopper block of 32 rows cannot see the absmax of a 512-row
// tile, so the scale grid is computed first, in its own pass:
//   pass 1: one block per (32 rows, 32 columns of F) computes h, g and y and
//           folds max |y| into the table [ceil(rows/sub_rows), F/blk_cols]
//           with atomicMax on the bit pattern (non-negative floats order as
//           their bits do). Its rows run up to the end of the last sub_rows
//           tile that holds a real row, with zero x past the real rows, so
//           the padded rows the TPU kernel sees are seen here;
//   pass 2: one block per (32 rows, Cb output columns) walks F in chunks of
//           32: h, g and y again, yq = round(y / sy) into shared memory, then
//           yq . W2 into int32 registers; at the end of each blk_cols chunk
//           the int32 sum is scaled by sy * s2 into the fp32 accumulator, as
//           the TPU kernel does, and the output is cast once.
// That computes the first product twice: 4CF + (4CF + 2CF) = 10CF operations
// instead of 6CF, 1.67x. Pass 2 also recomputes the first product for each
// of its C / Cb column chunks (Cb = the widest multiple of 64 up to 320 that
// divides C: 1x at C = 320, 2x at 640, 4x at 1280), which keeps the int32
// and fp32 accumulators [32, Cb] in registers (40 + 40 per thread). All
// products are mma.sync m16n8k32 (int8, int32 accumulation) from shared
// memory; W1 arrives as [F, C] rows and W2 as [C, F] rows, so that B is
// k-contiguous. Tiles are loaded by cp.async and waited for (no double
// buffering yet).
//
// Numerics: h, g, y, the table, sy and the accumulation use the TPU kernel's
// fp32 operations in its order (no fused multiply-adds), so the result
// differs from it only where tanhf and expf differ from XLA's by an ulp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using d3r::cp_async_16;

constexpr int kRows = 32;   // rows per block
constexpr int kFs = 32;     // F columns per step
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLdy = kFs + 16;

struct GegluArgs {
  const int8_t* x;    // [rows, C]
  const int8_t* w1h;  // [F, C]
  const int8_t* w1g;  // [F, C]
  const int8_t* w2;   // [C, F]
  const float* d1h;
  const float* d1g;
  const float* b1h;
  const float* b1g;   // [F]
  const float* s2;
  const float* b2;    // [C]
  unsigned int* tab;  // [ceil(rows / sub_rows), F / blk_cols], float bits
  bf16* out;          // [rows, C]
  int rows, C, F, sub_rows, blk_cols, cb;
};

__host__ __device__ inline size_t smem_bytes(int C, int cb, bool pass2) {
  const size_t ldx = C + 16;
  size_t bytes = 3 * (size_t)kRows * ldx;  // x tile, W1h and W1g chunks
  if (pass2) bytes += (size_t)cb * kLdy + (size_t)kRows * kLdy;  // W2 chunk, yq
  return bytes;
}

__device__ __forceinline__ float gelu_tanh(float g) {
  // jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))))
  const float x3 = __fmul_rn(__fmul_rn(g, g), g);
  const float inner = __fadd_rn(g, __fmul_rn(0.044715f, x3));
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(__fmul_rn(0.7978845608028654f, inner))));
  return __fmul_rn(g, cdf);
}

template <bool kPass2, int NT>
__global__ void __launch_bounds__(kThreads) geglu_int8_kernel(GegluArgs a) {
  extern __shared__ __align__(128) int8_t smem[];
  const int ldx = a.C + 16;
  int8_t* xs = smem;
  int8_t* w1hs = xs + kRows * ldx;
  int8_t* w1gs = w1hs + kFs * ldx;
  int8_t* w2s = w1gs + kFs * ldx;          // pass 2: [cb, 32]
  int8_t* ys = w2s + a.cb * kLdy;          // pass 2: [32, 32]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  const int row0 = blockIdx.x * kRows;
  const int vec_c = a.C / 16;
  const int n_chunks = a.F / a.blk_cols;
  const unsigned int* tab_row = a.tab + (row0 / a.sub_rows) * n_chunks;

  for (int i = tid; i < kRows * vec_c; i += kThreads) {
    const int r = i / vec_c, cc = (i % vec_c) * 16;
    const bool ok = row0 + r < a.rows;
    cp_async_16(xs + r * ldx + cc, ok ? a.x + (long long)(row0 + r) * a.C + cc : a.x,
                ok ? 16 : 0);
  }

  // First product: this warp's (16 x 8) fragment of h and of g.
  const int mt = warp / 4, nt = warp % 4;
  const int c0 = kPass2 ? blockIdx.y * a.cb : 0;  // pass 2: output columns
  const int cw = a.cb / kWarps;                   // pass 2: columns per warp
  int acc_i[2][NT][4];
  float acc_f[2][NT][4];
  if (kPass2) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = c0 + warp * cw + j * 8 + 2 * t4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc_i[i][j][0] = acc_i[i][j][1] = acc_i[i][j][2] = acc_i[i][j][3] = 0;
        acc_f[i][j][0] = acc_f[i][j][2] = a.b2[col];
        acc_f[i][j][1] = acc_f[i][j][3] = a.b2[col + 1];
      }
    }
  }

  const int f_begin = kPass2 ? 0 : blockIdx.y * kFs;
  const int f_end = kPass2 ? a.F : f_begin + kFs;
  for (int f0 = f_begin; f0 < f_end; f0 += kFs) {
    for (int i = tid; i < kFs * vec_c; i += kThreads) {
      const int r = i / vec_c, cc = (i % vec_c) * 16;
      cp_async_16(w1hs + r * ldx + cc, a.w1h + (long long)(f0 + r) * a.C + cc, 16);
      cp_async_16(w1gs + r * ldx + cc, a.w1g + (long long)(f0 + r) * a.C + cc, 16);
    }
    if (kPass2) {
      for (int i = tid; i < a.cb * 2; i += kThreads) {
        const int r = i / 2, cc = (i % 2) * 16;
        cp_async_16(w2s + r * kLdy + cc, a.w2 + (long long)(c0 + r) * a.F + f0 + cc, 16);
      }
    }
    d3r::cp_async_commit();
    d3r::cp_async_wait<0>();
    __syncthreads();

    int hacc[4] = {0, 0, 0, 0}, gacc[4] = {0, 0, 0, 0};
    for (int kk = 0; kk < a.C / 32; ++kk) {
      uint32_t af[4], b0, b1;
      d3r::load_a(af, xs, ldx, mt * 16, kk * 32, lane);
      d3r::load_b(b0, b1, w1hs, ldx, nt * 8, kk * 32, lane);
      d3r::mma_s8(hacc, af, b0, b1);
      d3r::load_b(b0, b1, w1gs, ldx, nt * 8, kk * 32, lane);
      d3r::mma_s8(gacc, af, b0, b1);
    }
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = f0 + nt * 8 + 2 * t4 + (e & 1);
      const float h = __fadd_rn(__fmul_rn((float)hacc[e], a.d1h[f]), a.b1h[f]);
      const float g = __fadd_rn(__fmul_rn((float)gacc[e], a.d1g[f]), a.b1g[f]);
      y[e] = __fmul_rn(h, gelu_tanh(g));
    }

    if (!kPass2) {
      float m = fmaxf(fmaxf(fabsf(y[0]), fabsf(y[1])), fmaxf(fabsf(y[2]), fabsf(y[3])));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) atomicMax(a.tab + (row0 / a.sub_rows) * n_chunks + f0 / a.blk_cols,
                               __float_as_uint(m));
      __syncthreads();
      continue;
    }

    const int chunk = f0 / a.blk_cols;
    const float sy = __fdiv_rn(fmaxf(__uint_as_float(tab_row[chunk]), 1e-6f), 127.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = mt * 16 + g4 + 8 * (e >> 1);
      const int fc = nt * 8 + 2 * t4 + (e & 1);
      ys[r * kLdy + fc] = static_cast<int8_t>(rintf(__fdiv_rn(y[e], sy)));
    }
    __syncthreads();

    // Second product: yq [32, 32] . W2 chunk -> this warp's cw output columns.
    uint32_t af[2][4];
    d3r::load_a(af[0], ys, kLdy, 0, 0, lane);
    d3r::load_a(af[1], ys, kLdy, 16, 0, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t b0, b1;
      d3r::load_b(b0, b1, w2s, kLdy, warp * cw + j * 8, 0, lane);
      d3r::mma_s8(acc_i[0][j], af[0], b0, b1);
      d3r::mma_s8(acc_i[1][j], af[1], b0, b1);
    }
    if ((f0 + kFs) % a.blk_cols == 0) {  // end of a scale chunk: fold it in
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = c0 + warp * cw + j * 8 + 2 * t4;
        const float k0 = __fmul_rn(sy, a.s2[col]), k1 = __fmul_rn(sy, a.s2[col + 1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc_f[i][j][e] = __fadd_rn(acc_f[i][j][e], __fmul_rn((float)acc_i[i][j][e],
                                                                  (e & 1) ? k1 : k0));
            acc_i[i][j][e] = 0;
          }
        }
      }
    }
    __syncthreads();  // the next chunk's copies overwrite W1, W2 and yq
  }

  if (kPass2) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = c0 + warp * cw + j * 8 + 2 * t4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row0 + i * 16 + g4 + 8 * hh;
          if (r >= a.rows) continue;
          *reinterpret_cast<__nv_bfloat162*>(a.out + (long long)r * a.C + col) =
              __floats2bfloat162_rn(acc_f[i][j][2 * hh], acc_f[i][j][2 * hh + 1]);
        }
      }
    }
  }
}

template <bool kPass2, int NT>
cudaError_t launch_one(const GegluArgs& a, dim3 grid, cudaStream_t st) {
  const size_t bytes = smem_bytes(a.C, a.cb, kPass2);
  cudaError_t err = cudaFuncSetAttribute(
      geglu_int8_kernel<kPass2, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  geglu_int8_kernel<kPass2, NT><<<grid, kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// xq [rows, C], w1hq/w1gq [F, C], w2q [C, F] int8; d1h, d1g, b1h, b1g [F],
// s2, b2 [C] fp32; tab [ceil(rows/sub_rows) * F/blk_cols] uint32 scratch;
// out [rows, C] bf16. All contiguous, 16-byte aligned. C % 64 == 0, F % 32
// == 0, blk_cols % 32 == 0 and divides F, sub_rows % 32 == 0, cb % 64 == 0,
// cb <= 320 and divides C. Returns cudaGetLastError().
extern "C" int d3r_geglu_ff_int8(const void* xq, const void* w1hq, const void* w1gq,
                                 const void* w2q, const void* d1h, const void* d1g,
                                 const void* b1h, const void* b1g, const void* s2,
                                 const void* b2, void* tab, void* out, int rows, int C, int F,
                                 int sub_rows, int blk_cols, int cb, void* stream) {
  if (rows <= 0 || C % 64 || F % kFs || blk_cols % kFs || F % blk_cols || sub_rows % kRows ||
      cb % 64 || cb > 320 || C % cb)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  GegluArgs a{static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w1hq),
              static_cast<const int8_t*>(w1gq), static_cast<const int8_t*>(w2q),
              static_cast<const float*>(d1h), static_cast<const float*>(d1g),
              static_cast<const float*>(b1h), static_cast<const float*>(b1g),
              static_cast<const float*>(s2), static_cast<const float*>(b2),
              static_cast<unsigned int*>(tab), static_cast<bf16*>(out),
              rows, C, F, sub_rows, blk_cols, cb};
  const int sub_tiles = (rows + sub_rows - 1) / sub_rows;
  cudaError_t err = cudaMemsetAsync(tab, 0, sizeof(unsigned int) * sub_tiles * (F / blk_cols), st);
  if (err != cudaSuccess) return (int)err;
  const int cover = sub_tiles * sub_rows;  // rows up to the end of the last tile
  err = launch_one<false, 1>(a, dim3(cover / kRows, F / kFs), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((rows + kRows - 1) / kRows, C / cb);
  switch (cb / 64) {
    case 1: return (int)launch_one<true, 1>(a, grid2, st);
    case 2: return (int)launch_one<true, 2>(a, grid2, st);
    case 3: return (int)launch_one<true, 3>(a, grid2, st);
    case 4: return (int)launch_one<true, 4>(a, grid2, st);
    case 5: return (int)launch_one<true, 5>(a, grid2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
