// GroupNorm + affine + SiLU in one pass over NHWC activations, for Hopper
// (sm_90a):
//   mean_g = (sum over the group's pixels and channels of x) * inv_n
//   var_g  = (sum of x^2) * inv_n - mean_g^2          fp32, no clamp
//   scale_c = rsqrt(var_g + eps) * gamma_c,  shift_c = beta_c - mean_g * scale_c
//   y = x * scale_c + shift_c;  out = y * sigmoid(y)  fp32, cast to x's type
//
// Replaces: d3roma_tpu/ops/pallas/groupnorm.py::fused_group_norm_silu (kernel
// body _gn_silu_kernel). That TPU kernel holds one batch item's whole
// [H, W, C] slab in VMEM (the gate admits slabs up to 4 MiB), sums each
// channel over the rows, folds the channel sums to group sums with a one-hot
// matrix product, and normalizes the slab in fp32 on its second pass.
//
// What bounds it on the H100: bytes. It reads x twice (statistics, then the
// normalize; the second read mostly from the 50 MB L2 at the gate's slab
// sizes) and writes the output once, at a few operations per element.
//
// Design: three launches on the caller's stream, no atomics, so a run
// repeats bit for bit. (1) stats: one block per (batch, chunk of pixels)
// sums x and x^2 per channel over its pixels (8 channels per thread, 16-byte
// loads along C, the pixels of the chunk dealt out to the thread rows, then
// a fixed-order reduction over the rows in shared memory) and writes the
// partials [B, chunks, 2, C]; (2) fold: one block per (group, batch item)
// adds its group's partials, each thread a fixed share and then a
// fixed-order tree, and writes the group's per-channel scale and shift;
// (3) normalize: one block per (batch, chunk) applies them with 16-byte
// loads and stores.
// A group's C/G channels lie strided inside each pixel's row of C, so the
// passes over x read along C and only the fold, on the partial sums,
// gathers a group's channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;

template <typename T>
struct Vec8;  // 8 elements of T as one 16-byte (bf16) or two (fp32) loads

template <>
struct Vec8<bf16> {
  __device__ static void load(const bf16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
  }
  __device__ static void store(bf16* p, const float (&v)[8]) {
    uint4 u;
    bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(v[j]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Vec8<float> {
  __device__ static void load(const float* p, float (&v)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ static void store(float* p, const float (&v)[8]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
};

struct Args {
  const void* x;       // [B, P, C]
  const float* gamma;  // [C]
  const float* beta;   // [C]
  float* part;         // [B, chunks, 2, C]
  float* ss;           // [B, 2, C]: scale, shift
  void* out;           // [B, P, C]
  int B, P, C, G, chunk, chunks;
  float inv_n, eps;
  int silu;
};

// grid (chunks, B). Thread layout: slot = tid % (C / 8) owns channels
// [8 slot, 8 slot + 8); row = tid / (C / 8) walks the chunk's pixels with a
// stride of the number of rows. C / 8 > kThreads: a thread owns several slots.
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_stats_kernel(Args a) {
  extern __shared__ float red[];  // [rows, 2, C]
  const int b = blockIdx.y, ck = blockIdx.x;
  const int slots = a.C / 8;
  const int rows = slots >= kThreads ? 1 : kThreads / slots;
  const int row = threadIdx.x / slots;
  const T* x = static_cast<const T*>(a.x) + (long long)b * a.P * a.C;
  const int p0 = ck * a.chunk, p1 = min(a.P, p0 + a.chunk);
  if (row < rows) {
    // slots < kThreads: one slot per thread; otherwise slots tid, tid + kThreads, ...
    for (int slot = threadIdx.x % slots; slot < slots; slot += kThreads) {
      float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float q[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int p = p0 + row; p < p1; p += rows) {
        float v[8];
        Vec8<T>::load(x + (long long)p * a.C + 8 * slot, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j] = __fadd_rn(s[j], v[j]);
          q[j] = __fadd_rn(q[j], __fmul_rn(v[j], v[j]));
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        red[(row * 2) * a.C + 8 * slot + j] = s[j];
        red[(row * 2 + 1) * a.C + 8 * slot + j] = q[j];
      }
    }
  }
  __syncthreads();
  float* dst = a.part + ((long long)b * a.chunks + ck) * 2 * a.C;
  for (int i = threadIdx.x; i < 2 * a.C; i += kThreads) {
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, red[r * 2 * a.C + i]);
    dst[i] = acc;
  }
}

// grid (G, B): the partials of group g of batch b, each thread summing a
// fixed strided share of the (chunk, channel) terms, then a fixed-order
// tree over the threads, into the group's per-channel scale and shift.
__global__ void __launch_bounds__(kThreads) gn_fold_kernel(Args a) {
  __shared__ float red[2][kThreads];
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = a.C / a.G;
  const float* src = a.part + (long long)b * a.chunks * 2 * a.C + g * cg;
  float s = 0.f, q = 0.f;
  for (int i = threadIdx.x; i < a.chunks * cg; i += kThreads) {
    const float* p = src + (long long)(i / cg) * 2 * a.C + i % cg;
    s = __fadd_rn(s, p[0]);
    q = __fadd_rn(q, p[a.C]);
  }
  red[0][threadIdx.x] = s;
  red[1][threadIdx.x] = q;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      red[0][threadIdx.x] = __fadd_rn(red[0][threadIdx.x], red[0][threadIdx.x + half]);
      red[1][threadIdx.x] = __fadd_rn(red[1][threadIdx.x], red[1][threadIdx.x + half]);
    }
    __syncthreads();
  }
  const float mean = __fmul_rn(red[0][0], a.inv_n);
  const float ex2 = __fmul_rn(red[1][0], a.inv_n);
  const float var = __fsub_rn(ex2, __fmul_rn(mean, mean));
  const float inv = rsqrtf(__fadd_rn(var, a.eps));
  for (int j = threadIdx.x; j < cg; j += kThreads) {
    const int c = g * cg + j;
    const float scale = __fmul_rn(inv, a.gamma[c]);
    a.ss[(long long)b * 2 * a.C + c] = scale;
    a.ss[(long long)b * 2 * a.C + a.C + c] = __fsub_rn(a.beta[c], __fmul_rn(mean, scale));
  }
}

// grid (chunks, B): y = x * scale + shift, then y * sigmoid(y), 8 channels
// per thread per step.
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_apply_kernel(Args a) {
  const int b = blockIdx.y, ck = blockIdx.x;
  const int slots = a.C / 8;
  const long long base = ((long long)b * a.P + (long long)ck * a.chunk) * a.C;
  const int n_pix = min(a.chunk, a.P - ck * a.chunk);
  const T* x = static_cast<const T*>(a.x) + base;
  T* out = static_cast<T*>(a.out) + base;
  const float* scale = a.ss + (long long)b * 2 * a.C;
  const float* shift = scale + a.C;
  for (int i = threadIdx.x; i < n_pix * slots; i += kThreads) {
    const int p = i / slots, c0 = (i % slots) * 8;
    float v[8];
    Vec8<T>::load(x + (long long)p * a.C + c0, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float y = __fadd_rn(__fmul_rn(v[j], scale[c0 + j]), shift[c0 + j]);
      if (a.silu) y = __fmul_rn(y, __frcp_rn(__fadd_rn(1.f, expf(-y))));
      v[j] = y;
    }
    Vec8<T>::store(out + (long long)p * a.C + c0, v);
  }
}

template <typename T>
cudaError_t run(Args a, cudaStream_t st) {
  const int slots = a.C / 8;
  const int rows = slots >= kThreads ? 1 : kThreads / slots;
  const size_t red_bytes = sizeof(float) * rows * 2 * a.C;
  cudaError_t err = cudaFuncSetAttribute(gn_stats_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)red_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.chunks, a.B);
  gn_stats_kernel<T><<<grid, kThreads, red_bytes, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gn_fold_kernel<<<dim3(a.G, a.B), kThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gn_apply_kernel<T><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x and out [B, P, C] (P = H * W), bf16 (is_bf16 = 1) or fp32, contiguous,
// 16-byte aligned; gamma, beta [C] fp32. C % 8 == 0, C % G == 0. Scratch:
// part [B, chunks, 2, C] and ss [B, 2, C] fp32, chunks = ceil(P / chunk).
// Returns the first CUDA error of the three launches.
extern "C" int d3r_group_norm_silu(const void* x, const void* gamma, const void* beta,
                                   void* part, void* ss, void* out, int B, int P, int C, int G,
                                   int chunk, float inv_n, float eps, int silu, int is_bf16,
                                   void* stream) {
  if (B <= 0 || P <= 0 || C <= 0 || C % 8 != 0 || G <= 0 || C % G != 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(gamma), static_cast<const float*>(beta),
         static_cast<float*>(part), static_cast<float*>(ss), out, B, P, C, G, chunk,
         (P + chunk - 1) / chunk, inv_n, eps, silu};
  auto st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? run<bf16>(a, st) : run<float>(a, st));
}
