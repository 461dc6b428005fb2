// GEGLU feed-forward for Hopper (sm_90a) with both products in int8:
//   h = (xq . W1h) * d1h + b1h,  g = (xq . W1g) * d1g + b1g     (fp32)
//   y = h * gelu_tanh(g);  yq = round(y / sy)   (sy per tile, see below)
//   out = bf16(b2 + sum over F chunks of (yq . W2) * (sy * s2))
// with x quantized by the entry point at the static activation scale, the
// weights per column (d1h = s1h * act_scale, d1g likewise, one fp32
// product each, taken in the kernel).
//
// Replaces: d3roma_tpu/ops/pallas/geglu.py::geglu_ff, its int8 path (kernel
// body _kernel_int8). That TPU kernel walks row blocks of 2048 (C <= 640) or
// 512 rows, pads the rows to that block with zeros, and re-quantizes the
// gated intermediate y with one absmax per tile of sub_rows x blk_cols
// (sub_rows 512 or 256; blk_cols 640 at F = 1280 and 2560, 1024 at
// F = 5120). The zero-padded rows reach that absmax too, as b1h * gelu(b1g).
//
// What bounds it on the H100: operations at the flagship widths (C, F) =
// (320, 1280), (640, 2560), (1280, 5120) from 480 rows up (6*C*F int8
// operations a row); at 120 rows, the weight bytes (3*C*F, 20 MB at
// C = 1280).
//
// Design: three GEMMs on the building blocks of sm90_gemm.cuh (TMA ring,
// int8 wgmma with int32 sums in registers, persistent blocks of 128-row
// tiles). A tile's scale sy is known only once the whole sub_rows x
// blk_cols tile's |y| is seen, and y must be fp32 for round(y / sy) to
// match, so the first product runs twice (recomputing it, 4*rows*C*F
// operations, is cheaper than storing and reading fp32 y, 8*rows*F bytes):
//   pass 1 (geglu_int8_gate_kernel<0>): xq . [W1h | W1g] (a stage holds
//     64 rows of W1h over 64 rows of W1g, so h and the gate of a column sit
//     in one thread); the epilogue computes h, g and y and folds
//     max |y| into the table [ceil(rows / sub_rows), F / blk_cols] with
//     atomicMax on the bit pattern (non-negative floats order as their bits
//     do). Rows past the last real one come in as zeros (TMA fills them), so
//     they give h = b1h and g = b1g exactly, as the TPU kernel's padded rows
//     do; the blocks of the last row tile also fold b1h * gelu(b1g) in when
//     the last sub_rows tile is padded, since a row tile can end before it;
//   pass 2 (geglu_int8_gate_kernel<1>): the same products and y again; the
//     epilogue stores yq = round(y / sy) as int8 [rows, F];
//   pass 3 (geglu_int8_out_kernel): yq . W2 chunk by chunk of blk_cols; at
//     each chunk's end the int32 sums are scaled by sy * s2 into fp32 sums
//     that start at b2, in chunk order, as the TPU kernel's grid runs. Where
//     rows are few, each chunk goes to its own block, which writes its
//     scaled term to partial [chunks, rows, C], and
//     geglu_int8_reduce_kernel adds b2 and the terms in chunk order, so the
//     result stays bit-equal.
// Operations: 4CF + 4CF + 2CF = 10CF a row, against 6CF without the
// recompute. Int8 wgmma takes only K-major operands: W1h, W1g [F, C] and W2
// [C, F] are K-major for their products as they come. Device operations per
// call: the table clear, the quantization of x (act_quantize.cuh, into the
// wrapper's int8 workspace), the three passes, and the split sum where
// split: 5 or 6. Pass 1 is a dependent launch on the quantize (pdl.cuh):
// its producer issues the weight boxes of its first stages, then waits on
// the quantize before its first xq box; the clear runs before the quantize,
// so the table is zero when pass 1 starts. Pass 3's tile width and the split
// come from the wrapper's plan (ops/kernels/geglu.py::geglu_plan). ptxas
// (sm_90a): 168 registers per thread at launch for every GEMM instance (the
// consumers raise theirs to 232 with setmaxnreg), no spills. Passes 1-2 are
// bound by their epilogue's fp32 work (tanhf and, in pass 2, the IEEE
// division: bit-equality rules out the hardware's approximations), not by
// the tensor cores.
//
// Numerics: h, g, y, the table, sy and the accumulation use the TPU kernel's
// fp32 operations in its order (no fused multiply-adds), so the result
// differs from it only where tanhf differs from XLA's tanh by an ulp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "act_quantize.cuh"
#include "sm90_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace d3r::sm90;

__device__ __forceinline__ float gelu_tanh(float g) {
  // jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))))
  const float x3 = __fmul_rn(__fmul_rn(g, g), g);
  const float inner = __fadd_rn(g, __fmul_rn(0.044715f, x3));
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(__fmul_rn(0.7978845608028654f, inner))));
  return __fmul_rn(g, cdf);
}

__device__ __forceinline__ float geglu(int h_sum, int g_sum, float dh, float dg, float bh,
                                       float bg) {
  // TPU order: h = acc * (act_scale * s1h) + b1h, g likewise, y = h * gelu(g)
  const float h = __fadd_rn(__fmul_rn(__int2float_rn(h_sum), dh), bh);
  const float g = __fadd_rn(__fmul_rn(__int2float_rn(g_sum), dg), bg);
  return __fmul_rn(h, gelu_tanh(g));
}

// sy of a scale tile from its table entry (the bits of max |y|)
__device__ __forceinline__ float scale_of(unsigned int absmax) {
  return __fdiv_rn(fmaxf(__uint_as_float(absmax), 1e-6f), 127.f);
}

struct GateArgs {
  const float* s1h;
  const float* s1g;
  const float* b1h;
  const float* b1g;   // [F]
  unsigned int* tab;  // [ceil(rows / sub_rows), F / blk_cols], float bits
  int8_t* yq;         // [rows, F]
  float act_scale;
  int rows, C, F, sub_rows, blk_cols;
};

// Pass 1 (kQuant false) and pass 2 (true), in tiles of kGateCols hidden
// columns (a B stage of kGateBN = 2 kGateCols rows; 32 columns a tile was
// slower at every flagship shape). Pass 2 stages each warpgroup's 64 rows of
// yq in shared memory (kGatePitch bytes a row) and stores them with 16-byte
// writes.
constexpr int kGateCols = 64, kGateBN = 2 * kGateCols, kGatePitch = kGateCols + 16;
constexpr size_t kGateSmem = Stages<kGateBN>::kSmemBytes + kConsumers * 64 * kGatePitch;

template <bool kQuant>
__global__ void __launch_bounds__(kThreads, 1)
    geglu_int8_gate_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap wh_map,
                           const __grid_constant__ CUtensorMap wg_map, const GateArgs a) {
  extern __shared__ uint8_t smem[];
  const Stages<kGateBN> st(smem);
  if (threadIdx.x == 0) st.init();
  __syncthreads();
  const int m_tiles = (a.rows + kBlockRows - 1) / kBlockRows;
  const int tiles = m_tiles * (a.F / kGateCols);
  const int k_tiles = (a.C + 127) / 128;
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    regs_dealloc<40>();
    if (threadIdx.x == kConsumers * 128) {
      prefetch_map(&x_map);
      prefetch_map(&wh_map);
      prefetch_map(&wg_map);
      Ring ring;
      // the weight boxes of the first tile's first stages before the wait
      // on the quantize (pass 1 is its dependent launch); `pre` counts them
      int pre = 0;
      {
        Ring r = ring;
        const int f0 = (blockIdx.x / m_tiles) * kGateCols;
        for (; pre < kStages && pre < k_tiles; ++pre) {
          st.load_b(r, &wh_map, f0, &wg_map, f0, pre * 128);
        }
      }
      d3r::pdl::wait();
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * kBlockRows, f0 = (t / m_tiles) * kGateCols;
        for (int kt = 0; kt < k_tiles; ++kt) {
          if (pre > 0) {
            --pre;
            st.load_a(ring, &x_map, m0, kt * 128);
          } else {
            st.load(ring, &x_map, m0, &wh_map, f0, &wg_map, f0, kt * 128);
          }
        }
      }
    }
  } else {
    regs_alloc<232>();
    const int n_chunks = a.F / a.blk_cols;
    const bool padded = a.rows % a.sub_rows != 0;
    uint8_t* staged = smem + Stages<kGateBN>::kSmemBytes + wg * 64 * kGatePitch;
    Ring ring;
    int acc[kGateBN / 2];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int mt = t % m_tiles, m0 = mt * kBlockRows, f0 = (t / m_tiles) * kGateCols;
      // one scale tile holds this tile: 128 divides sub_rows and blk_cols
      const int cell = (m0 / a.sub_rows) * n_chunks + f0 / a.blk_cols;
      // the epilogue's per-column operands (and pass 2's scale), loaded
      // while the products run
      float2 s1h[kGateCols / 8], s1g[kGateCols / 8], b1h[kGateCols / 8], b1g[kGateCols / 8];
#pragma unroll
      for (int j = 0; j < kGateCols / 8; ++j) {
        const int f = f0 + frag_col(j, 0);
        s1h[j] = *reinterpret_cast<const float2*>(a.s1h + f);
        s1g[j] = *reinterpret_cast<const float2*>(a.s1g + f);
        b1h[j] = *reinterpret_cast<const float2*>(a.b1h + f);
        b1g[j] = *reinterpret_cast<const float2*>(a.b1g + f);
      }
      const unsigned int absmax = kQuant ? a.tab[cell] : 0u;
      st.mma(ring, wg, acc, k_tiles);
      if (kQuant) warpgroup_sync(wg);  // the last tile's rows have left the staging area
      const int r0 = m0 + wg * 64;
      float mx = 0.f;
      const float sy = scale_of(absmax);
#pragma unroll
      for (int j = 0; j < kGateCols / 8; ++j) {
        const int f = f0 + frag_col(j, 0);
        const float dh[2] = {__fmul_rn(s1h[j].x, a.act_scale), __fmul_rn(s1h[j].y, a.act_scale)};
        const float dg[2] = {__fmul_rn(s1g[j].x, a.act_scale), __fmul_rn(s1g[j].y, a.act_scale)};
        const float bh[2] = {b1h[j].x, b1h[j].y}, bg[2] = {b1g[j].x, b1g[j].y};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ih = 4 * j + 2 * half, ig = ih + kGateCols / 2;
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            y[e] = geglu(acc[ih + e], acc[ig + e], dh[e], dg[e], bh[e], bg[e]);
          }
          if (!kQuant) {
            mx = fmaxf(mx, fmaxf(fabsf(y[0]), fabsf(y[1])));
            continue;
          }
          char2 q;
          q.x = static_cast<signed char>(rintf(__fdiv_rn(y[0], sy)));
          q.y = static_cast<signed char>(rintf(__fdiv_rn(y[1], sy)));
          *reinterpret_cast<char2*>(staged + frag_row(2 * half) * kGatePitch + (f - f0)) = q;
        }
        if (!kQuant && padded && mt == m_tiles - 1) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mx = fmaxf(mx, fabsf(geglu(0, 0, dh[e], dg[e], bh[e], bg[e])));
          }
        }
      }
      if (kQuant) {
        warpgroup_sync(wg);
        store_tile(staged, kGatePitch, kGateCols,
                   reinterpret_cast<uint8_t*>(a.yq + (long long)r0 * a.F + f0), a.F, a.rows - r0);
      } else {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (threadIdx.x % 32 == 0) atomicMax(a.tab + cell, __float_as_uint(mx));
      }
    }
  }
}

struct OutArgs {
  const unsigned int* tab;
  const float* s2;
  const float* b2;   // [C]
  bf16* out;         // [rows, C]
  float* partial;    // [chunks, rows, C] when split
  int rows, C, F, sub_rows, blk_cols, splits;
};

// Pass 3: splits is 1 (a block walks every chunk) or the number of chunks
// (a block takes one).
template <int kBN>
__global__ void __launch_bounds__(kThreads, 1)
    geglu_int8_out_kernel(const __grid_constant__ CUtensorMap y_map,
                          const __grid_constant__ CUtensorMap w2_map, const OutArgs a) {
  extern __shared__ uint8_t smem[];
  const Stages<kBN> st(smem);
  if (threadIdx.x == 0) st.init();
  __syncthreads();
  const int m_tiles = (a.rows + kBlockRows - 1) / kBlockRows;
  const int n_tiles = (a.C + kBN - 1) / kBN;
  const int tiles = m_tiles * n_tiles * a.splits;
  const int n_chunks = a.F / a.blk_cols;
  const int chunk_tiles = a.blk_cols / 128;
  const int own_chunks = n_chunks / a.splits;
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    regs_dealloc<40>();
    if (threadIdx.x == kConsumers * 128) {
      Ring ring;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * kBlockRows;
        const int n0 = (t / m_tiles % n_tiles) * kBN, s = t / m_tiles / n_tiles;
        for (int kt = 0; kt < own_chunks * chunk_tiles; ++kt) {
          st.load(ring, &y_map, m0, &w2_map, n0, nullptr, 0,
                  (s * own_chunks * chunk_tiles + kt) * 128);
        }
      }
    }
  } else {
    regs_alloc<232>();
    Ring ring;
    int acc[kBN / 2];
    float sum[kBN / 2];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % m_tiles) * kBlockRows;
      const int n0 = (t / m_tiles % n_tiles) * kBN, s = t / m_tiles / n_tiles;
      const int r0 = m0 + wg * 64;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + frag_col(j, 0);
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[4 * j + e] = col < a.C ? a.b2[col + (e & 1)] : 0.f;
      }
      for (int c = s * own_chunks; c < (s + 1) * own_chunks; ++c) {
        st.mma(ring, wg, acc, chunk_tiles);
        const float sy = scale_of(a.tab[(m0 / a.sub_rows) * n_chunks + c]);
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int col = n0 + frag_col(j, 0);
          if (col >= a.C) continue;
          const float k0 = __fmul_rn(sy, a.s2[col]), k1 = __fmul_rn(sy, a.s2[col + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float term = __fmul_rn(__int2float_rn(acc[4 * j + e]), (e & 1) ? k1 : k0);
            if (a.splits == 1) {
              sum[4 * j + e] = __fadd_rn(sum[4 * j + e], term);
            } else {
              sum[4 * j + e] = term;
            }
          }
        }
        if (a.splits == 1 && c + 1 < (s + 1) * own_chunks) continue;
        // the tile's result: out (unsplit) or chunk c's term (split)
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int col = n0 + frag_col(j, 0);
          if (col >= a.C) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = r0 + frag_row(2 * half);
            if (row >= a.rows) continue;
            const float v0 = sum[4 * j + 2 * half], v1 = sum[4 * j + 2 * half + 1];
            const long long o = (long long)row * a.C + col;
            if (a.splits == 1) {
              *reinterpret_cast<__nv_bfloat162*>(a.out + o) = __floats2bfloat162_rn(v0, v1);
            } else {
              *reinterpret_cast<float2*>(a.partial + (long long)c * a.rows * a.C + o) =
                  make_float2(v0, v1);
            }
          }
        }
      }
    }
  }
}

// Zero the scale table before pass 1 (a kernel, not a memset, so that a
// profile puts its time with the GEGLU's).
__global__ void geglu_int8_clear_kernel(unsigned int* __restrict__ tab, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) tab[i] = 0u;
}

__global__ void geglu_int8_reduce_kernel(const float* __restrict__ partial,
                                         const float* __restrict__ b2, bf16* __restrict__ out,
                                         long long n, int C, int splits) {
  sum_partials(partial, b2, out, n, C, splits);
}

// Pass 1 is the quantize's dependent launch.
template <bool kQuant>
cudaError_t launch_gate(const CUtensorMap& x, const CUtensorMap& wh, const CUtensorMap& wg,
                        const GateArgs& a, cudaStream_t st) {
  const int tiles = (a.rows + kBlockRows - 1) / kBlockRows * (a.F / kGateCols);
  return launch<geglu_int8_gate_kernel<kQuant>, !kQuant>(tiles, kGateSmem, st, x, wh, wg, a);
}

template <int kBN>
cudaError_t launch_out(const CUtensorMap& y, const CUtensorMap& w2, const OutArgs& a,
                       cudaStream_t st) {
  const int tiles = (a.rows + kBlockRows - 1) / kBlockRows * ((a.C + kBN - 1) / kBN) * a.splits;
  return launch<geglu_int8_out_kernel<kBN>>(tiles, Stages<kBN>::kSmemBytes, st, y, w2, a);
}

}  // namespace

// x [rows, C] bf16, quantized at act_scale into xq (int8 workspace of
// rows C bytes); w1hq/w1gq [F, C], w2q [C, F] int8; s1h, s1g, b1h, b1g
// [F], s2, b2 [C] fp32; tab [ceil(rows / sub_rows) * F / blk_cols] uint32
// and yq [rows, F] int8 scratch; out [rows, C] bf16. All contiguous, all
// but x 16-byte aligned. C % 16 == 0, F % 128 == 0; blk_cols % 128 == 0
// and divides F; sub_rows % 128 == 0. out_cols (64 or 128) output columns
// per tile of pass 3;
// splits is 1 or F / blk_cols, and with splits > 1 partial is fp32
// [splits, rows, C] scratch. Returns the first CUDA error of the launches.
extern "C" int d3r_geglu_ff_int8(const void* x, void* xq, const void* w1hq, const void* w1gq,
                                 const void* w2q, const void* s1h, const void* s1g,
                                 const void* b1h, const void* b1g, const void* s2,
                                 const void* b2, void* tab, void* yq, void* partial, void* out,
                                 float act_scale, int rows, int C, int F, int sub_rows,
                                 int blk_cols, int out_cols, int splits, void* stream) {
  if (rows <= 0 || C <= 0 || C % 16 || F <= 0 || F % 128 || blk_cols <= 0 || blk_cols % 128 ||
      F % blk_cols || sub_rows <= 0 || sub_rows % kBlockRows ||
      (out_cols != 64 && out_cols != 128) ||
      (splits != 1 && splits != F / blk_cols) || (splits > 1 && partial == nullptr) ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  CUtensorMap x_map, wh_map, wg_map, y_map, w2_map;
  cudaError_t err = tensor_map(&x_map, xq, 1, rows, C, C, kBlockRows);
  if (err == cudaSuccess) err = tensor_map(&wh_map, w1hq, 1, F, C, C, kGateCols);
  if (err == cudaSuccess) err = tensor_map(&wg_map, w1gq, 1, F, C, C, kGateCols);
  if (err == cudaSuccess) err = tensor_map(&y_map, yq, 1, rows, F, F, kBlockRows);
  if (err == cudaSuccess) err = tensor_map(&w2_map, w2q, 1, C, F, F, out_cols);
  if (err != cudaSuccess) return (int)err;

  const int sub_tiles = (rows + sub_rows - 1) / sub_rows;
  geglu_int8_clear_kernel<<<1, 256, 0, st>>>(static_cast<unsigned int*>(tab),
                                             sub_tiles * (F / blk_cols));
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = d3r::actq::quantize(x, xq, (long long)rows * C, true, act_scale, st);
  }
  if (err != cudaSuccess) return (int)err;
  const GateArgs g{static_cast<const float*>(s1h), static_cast<const float*>(s1g),
                   static_cast<const float*>(b1h), static_cast<const float*>(b1g),
                   static_cast<unsigned int*>(tab), static_cast<int8_t*>(yq), act_scale,
                   rows, C, F, sub_rows, blk_cols};
  err = launch_gate<false>(x_map, wh_map, wg_map, g, st);
  if (err == cudaSuccess) err = launch_gate<true>(x_map, wh_map, wg_map, g, st);
  if (err != cudaSuccess) return (int)err;

  const OutArgs o{static_cast<const unsigned int*>(tab), static_cast<const float*>(s2),
                  static_cast<const float*>(b2), static_cast<bf16*>(out),
                  static_cast<float*>(partial), rows, C, F, sub_rows, blk_cols, splits};
  err = out_cols == 128 ? launch_out<128>(y_map, w2_map, o, st)
                        : launch_out<64>(y_map, w2_map, o, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = (long long)rows * C;
  geglu_int8_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      o.partial, o.b2, o.out, n, C, splits);
  return (int)cudaGetLastError();
}
