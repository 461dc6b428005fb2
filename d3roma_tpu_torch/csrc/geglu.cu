// GEGLU feed-forward for Hopper (sm_90a), bf16 in and out:
//   out = ((x @ W1h + b1h) * gelu_tanh(x @ W1g + b1g)) @ W2 + b2
//
// Replaces: d3roma_tpu/ops/pallas/geglu.py::geglu_ff, its bf16 path (kernel
// body _kernel_bf16). That TPU kernel keeps a [blk_rows, C] fp32 accumulator
// (512 or 2048 rows) in VMEM and walks the hidden axis F in column chunks, so
// the [rows, F] intermediate never exists in device memory.
//
// What bounds it on the H100: operations at the flagship widths (C, F) =
// (320, 1280), (640, 2560), (1280, 5120) from 480 rows up (6*C*F flops a
// row); at 120 rows, the weight bytes (3*C*F*2, 39 MB at C = 1280).
//
// Design: two GEMMs on the building blocks of sm90_gemm.cuh (TMA ring,
// wgmma with the sums in registers, persistent blocks of 128-row tiles),
// with the intermediate y in a bf16 workspace [rows, F]. The TPU kernel's
// fused form needs a [rows, C] fp32 accumulator per row tile, 655 KB at
// 128 rows and C = 1280: it fits neither a block's registers nor its shared
// memory, and holding it in shared memory forces 32-row tiles (every 32 rows
// read all the weights again) and, at C = 1280, a second pass over the
// first product. The round trip of y costs 2*rows*F*2 bytes (37 MB at 7200
// rows), mostly in the 50 MB L2.
//   A (geglu_bf16_gate_kernel): a tile is 128 rows x 64 hidden columns.
//     Each stage holds 64 rows of W1h^T over 64 rows of W1g^T, so one wgmma
//     of N = 128 gives h in the first half of the sums and the gate in the
//     second, in the same thread; the epilogue computes
//     y = bf16((h + b1h) * gelu_tanh(g + b1g)) in registers. (32 hidden
//     columns a tile was slower at every flagship shape: x is read again
//     for each hidden tile.)
//   B (geglu_bf16_out_kernel): out = bf16(y @ W2 + b2) in out_cols-wide
//     tiles. Where rows are few, the contraction axis F is split across
//     blocks at the TPU kernel's column chunks; each split writes fp32
//     partial sums [splits, rows, C] and geglu_bf16_reduce_kernel adds b2
//     and the partials in split order (results do not vary between runs).
// The weights arrive K-major: W1h^T and W1g^T [F, C] (the halves of the
// PyTorch projection's weight), W2^T [C, F] (the output layer's weight).
// Device operations per call: 2, or 3 with the split. Launch B's tile width
// and the split come from the wrapper's plan
// (ops/kernels/geglu.py::geglu_plan).
// ptxas (sm_90a): 168 registers per thread at launch for every instance
// (the consumers raise theirs to 232 with setmaxnreg), no spills.
//
// Numerics: as the TPU kernel: fp32 h and gate plus fp32 biases, gelu in its
// tanh form, the gated product cast to the input type before the second
// product, fp32 accumulation of that product with b2, one cast at the end.
// The order of the fp32 sums differs, and tanh is the hardware's
// approximation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace d3r::sm90;

// tanh in one MUFU instruction (relative error ~2^-11, under the bf16
// rounding of y): the epilogue's fp32 math, not the tensor cores, bounds
// launch A at C = 320 and 640.
__device__ __forceinline__ float gelu_tanh(float g) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.7978845608028654f * (g + 0.044715f * g * g * g)));
  return 0.5f * g * (1.f + t);
}

// y [rows, F] = bf16((x W1h + b1h) * gelu_tanh(x W1g + b1g)), in tiles of
// kGateCols hidden columns (a B stage of kGateBN = 2 kGateCols rows). Each
// warpgroup stages its 64 rows of y in shared memory (kGatePitch bytes a
// row, which keeps the fragment writes free of bank conflicts) and stores
// them with 16-byte writes.
constexpr int kGateCols = 64, kGateBN = 2 * kGateCols, kGatePitch = kGateCols * 2 + 16;
constexpr size_t kGateSmem = Stages<kGateBN>::kSmemBytes + kConsumers * 64 * kGatePitch;

__global__ void __launch_bounds__(kThreads, 1)
    geglu_bf16_gate_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap wh_map,
                           const __grid_constant__ CUtensorMap wg_map,
                           const float* __restrict__ b1h, const float* __restrict__ b1g,
                           bf16* __restrict__ y, int rows, int C, int F) {
  extern __shared__ uint8_t smem[];
  const Stages<kGateBN> st(smem);
  if (threadIdx.x == 0) st.init();
  __syncthreads();
  const int m_tiles = (rows + kBlockRows - 1) / kBlockRows;
  const int tiles = m_tiles * (F / kGateCols);
  const int k_tiles = (C + 63) / 64;
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    regs_dealloc<40>();
    if (threadIdx.x == kConsumers * 128) {
      Ring ring;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * kBlockRows, f0 = (t / m_tiles) * kGateCols;
        for (int kt = 0; kt < k_tiles; ++kt) {
          st.load(ring, &x_map, m0, &wh_map, f0, &wg_map, f0, kt * 64);
        }
      }
    }
  } else {
    regs_alloc<232>();
    uint8_t* staged = smem + Stages<kGateBN>::kSmemBytes + wg * 64 * kGatePitch;
    Ring ring;
    float acc[kGateBN / 2];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % m_tiles) * kBlockRows, f0 = (t / m_tiles) * kGateCols;
      // the epilogue's biases, loaded while the products run
      float2 bh[kGateCols / 8], bg[kGateCols / 8];
#pragma unroll
      for (int j = 0; j < kGateCols / 8; ++j) {
        bh[j] = *reinterpret_cast<const float2*>(b1h + f0 + frag_col(j, 0));
        bg[j] = *reinterpret_cast<const float2*>(b1g + f0 + frag_col(j, 0));
      }
      st.mma(ring, wg, acc, k_tiles);
      warpgroup_sync(wg);  // the last tile's rows have left the staging area
#pragma unroll
      for (int j = 0; j < kGateCols / 8; ++j) {
        const int c = frag_col(j, 0);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ih = 4 * j + 2 * half, ig = ih + kGateCols / 2;
          const float y0 = (acc[ih] + bh[j].x) * gelu_tanh(acc[ig] + bg[j].x);
          const float y1 = (acc[ih + 1] + bh[j].y) * gelu_tanh(acc[ig + 1] + bg[j].y);
          *reinterpret_cast<__nv_bfloat162*>(staged + frag_row(2 * half) * kGatePitch + 2 * c) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
      warpgroup_sync(wg);
      const int r0 = m0 + wg * 64;
      store_tile(staged, kGatePitch, 2 * kGateCols,
                 reinterpret_cast<uint8_t*>(y + (long long)r0 * F + f0), 2ll * F, rows - r0);
    }
  }
}

// out [rows, C] = bf16(y W2 + b2), or with splits > 1 the fp32 partial sum
// of each split's share of F into partial [splits, rows, C].
template <int kBN>
__global__ void __launch_bounds__(kThreads, 1)
    geglu_bf16_out_kernel(const __grid_constant__ CUtensorMap y_map,
                          const __grid_constant__ CUtensorMap w2_map,
                          const float* __restrict__ b2, bf16* __restrict__ out,
                          float* __restrict__ partial, int rows, int C, int F, int splits) {
  extern __shared__ uint8_t smem[];
  const Stages<kBN> st(smem);
  if (threadIdx.x == 0) st.init();
  __syncthreads();
  const int m_tiles = (rows + kBlockRows - 1) / kBlockRows;
  const int n_tiles = (C + kBN - 1) / kBN;
  const int tiles = m_tiles * n_tiles * splits;
  const int k_tiles = F / 64 / splits;
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    regs_dealloc<40>();
    if (threadIdx.x == kConsumers * 128) {
      Ring ring;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * kBlockRows;
        const int n0 = (t / m_tiles % n_tiles) * kBN, s = t / m_tiles / n_tiles;
        for (int kt = 0; kt < k_tiles; ++kt) {
          st.load(ring, &y_map, m0, &w2_map, n0, nullptr, 0, (s * k_tiles + kt) * 64);
        }
      }
    }
  } else {
    regs_alloc<232>();
    Ring ring;
    float acc[kBN / 2];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % m_tiles) * kBlockRows;
      const int n0 = (t / m_tiles % n_tiles) * kBN, s = t / m_tiles / n_tiles;
      st.mma(ring, wg, acc, k_tiles);
      const int r0 = m0 + wg * 64;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + frag_col(j, 0);
        if (col >= C) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r0 + frag_row(2 * half);
          if (row >= rows) continue;
          const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
          const long long o = (long long)row * C + col;
          if (splits == 1) {
            *reinterpret_cast<__nv_bfloat162*>(out + o) =
                __floats2bfloat162_rn(v0 + b2[col], v1 + b2[col + 1]);
          } else {
            *reinterpret_cast<float2*>(partial + (long long)s * rows * C + o) =
                make_float2(v0, v1);
          }
        }
      }
    }
  }
}

__global__ void geglu_bf16_reduce_kernel(const float* __restrict__ partial,
                                         const float* __restrict__ b2, bf16* __restrict__ out,
                                         long long n, int C, int splits) {
  sum_partials(partial, b2, out, n, C, splits);
}

template <int kOutBN>
cudaError_t launch_out(const CUtensorMap& y, const CUtensorMap& w2, const float* b2, bf16* out,
                       float* partial, int rows, int C, int F, int splits, cudaStream_t st) {
  const int tiles = (rows + kBlockRows - 1) / kBlockRows * ((C + kOutBN - 1) / kOutBN) * splits;
  return launch<geglu_bf16_out_kernel<kOutBN>>(tiles, Stages<kOutBN>::kSmemBytes, st, y, w2, b2,
                                               out, partial, rows, C, F, splits);
}

}  // namespace

// x [rows, C], y [rows, F] (workspace), out [rows, C]: bf16; w1h_t and
// w1g_t [F, C], w2_t [C, F]: bf16, the K-major transposes of the JAX-named
// W1h, W1g [C, F] and W2 [F, C]; b1h, b1g [F] and b2 [C]: fp32. All
// contiguous and 16-byte aligned; C % 8 == 0, F % 64 == 0. out_cols (64 or
// 128) output columns per tile of launch B; splits divides F / 64, and with splits > 1
// partial is fp32 [splits, rows, C] scratch. Returns a CUDA error code.
extern "C" int d3r_geglu_ff_bf16(const void* x, const void* w1h_t, const void* w1g_t,
                                 const void* w2_t, const void* b1h, const void* b1g,
                                 const void* b2, void* y, void* partial, void* out, int rows,
                                 int C, int F, int out_cols, int splits, void* stream) {
  if (rows <= 0 || C <= 0 || C % 8 || F <= 0 || F % 64 || (out_cols != 64 && out_cols != 128) ||
      splits < 1 || (F / 64) % splits ||
      (splits > 1 && partial == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  CUtensorMap x_map, wh_map, wg_map, y_map, w2_map;
  cudaError_t err = tensor_map(&x_map, x, 2, rows, C, 2ull * C, kBlockRows);
  if (err == cudaSuccess) err = tensor_map(&wh_map, w1h_t, 2, F, C, 2ull * C, kGateCols);
  if (err == cudaSuccess) err = tensor_map(&wg_map, w1g_t, 2, F, C, 2ull * C, kGateCols);
  if (err == cudaSuccess) err = tensor_map(&y_map, y, 2, rows, F, 2ull * F, kBlockRows);
  if (err == cudaSuccess) err = tensor_map(&w2_map, w2_t, 2, C, F, 2ull * F, out_cols);
  if (err != cudaSuccess) return (int)err;

  err = launch<geglu_bf16_gate_kernel>((rows + kBlockRows - 1) / kBlockRows * (F / kGateCols),
                                       kGateSmem, st, x_map, wh_map, wg_map,
                                       static_cast<const float*>(b1h),
                                       static_cast<const float*>(b1g), static_cast<bf16*>(y),
                                       rows, C, F);
  if (err != cudaSuccess) return (int)err;

  const auto* bo = static_cast<const float*>(b2);
  auto* o = static_cast<bf16*>(out);
  auto* p = static_cast<float*>(partial);
  err = out_cols == 128 ? launch_out<128>(y_map, w2_map, bo, o, p, rows, C, F, splits, st)
                        : launch_out<64>(y_map, w2_map, bo, o, p, rows, C, F, splits, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = (long long)rows * C;
  geglu_bf16_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(p, bo, o, n, C, splits);
  return (int)cudaGetLastError();
}
