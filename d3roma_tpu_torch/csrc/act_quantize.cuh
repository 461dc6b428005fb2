// int8 quantization of an activation tensor for Hopper (sm_90a):
//   q = clip(round_half_even(x / scale), -127, 127)
// with one fp32 scale for the whole tensor (the static modes), x bf16 or
// fp32; or, for the dynamic modes, one scale a group computed on the device
// (absmax_groups_kernel, act_quantize_groups_kernel; the second half of
// this file).
//
// Replaces: the elementwise quantize_int8 that the JAX package leaves to XLA
// (d3roma_tpu/ops/quant.py:64, fused there into the producing op) in front of
// every static int8 dense, convolution, fused GEGLU and fused self-attention.
// There is no Pallas kernel behind it.
//
// What bounds it on the H100: bytes (2 read and 1 written per bf16 element)
// and, at the int8 ops' sizes (0.1-15 MB), its launch: a host call of its
// own costs more than its bytes take on the device. So the int8 ops' C
// entry points launch it themselves, into a workspace the wrapper reuses,
// and launch their first kernel right after it as a dependent launch
// (pdl.cuh): the quantize issues launch_dependents after its stores, and
// the consumer's prologue overlaps its tail. The standalone entry point is
// quantize.cu.
//
// Design: one wave of 256-thread blocks (at most 8 an SM), a grid-stride
// loop of 16 elements a thread a step: two 16-byte loads of bf16 (four of
// fp32) and one 16-byte store of int8, where x and q are 16-byte aligned;
// the elements past the last multiple of 16 (all of them when either pointer
// is not aligned) one at a time. The division is IEEE (__fdiv_rn), not a
// multiply by the reciprocal, and rintf rounds half to even, as jnp.round
// does, so the result is bit-equal to the JAX package's and to the plain
// PyTorch version's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "pdl.cuh"

namespace d3r {
namespace actq {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 threads an SM: 32 registers a thread
constexpr int kVec = 16;         // elements a thread a step

__device__ __forceinline__ int8_t quant1(float x, float scale) {
  const float q = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// The 16 elements at p (16-byte aligned) as raw 32-bit words: two 16-byte
// loads of bf16, four of fp32, all in flight before any is converted.
template <typename T>
struct Raw16 {
  static constexpr int kWords = kVec * (int)sizeof(T) / 4;
  uint32_t w[kWords];
  __device__ __forceinline__ explicit Raw16(const T* p) {
#pragma unroll
    for (int h = 0; h < kWords / 4; ++h) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[h];
      w[4 * h] = u.x;
      w[4 * h + 1] = u.y;
      w[4 * h + 2] = u.z;
      w[4 * h + 3] = u.w;
    }
  }
  // element j as a float
  __device__ __forceinline__ float at(int j) const {
    if constexpr (sizeof(T) == 2) {
      const uint32_t word = w[j / 2];
      return __uint_as_float(j % 2 ? word & 0xffff0000u : word << 16);
    } else {
      return __uint_as_float(w[j]);
    }
  }
};

// n16 vectors of 16 elements, then the scalar tail [16 n16, n). The 16
// elements are converted and quantized four at a time from their raw
// words, so the thread holds the loads' 8 (bf16) or 16 (fp32) words and
// one output word at a time: 32 registers, no spill.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    act_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, long long n,
                        long long n16, float scale) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = first; i < n16; i += stride) {
    const Raw16<T> raw(x + i * kVec);
    uint32_t out[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        word |= (uint32_t)(uint8_t)quant1(raw.at(4 * w + j), scale) << (8 * j);
      }
      out[w] = word;
    }
    reinterpret_cast<uint4*>(q)[i] = make_uint4(out[0], out[1], out[2], out[3]);
  }
  for (long long i = n16 * kVec + first; i < n; i += stride) q[i] = quant1(to_float(x[i]), scale);
  pdl::launch_dependents();
}

// The SM count of the current device, looked up once per device. Internal
// linkage: each library that includes this header keeps its own table.
static int sm_count() {
  static std::atomic<int> sms[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  int n = sms[dev].load();
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) n = 132;
    sms[dev].store(n);
  }
  return n;
}

// Launch the quantization of x (n elements, bf16 or fp32, contiguous) into
// q on st; returns the launch's error.
static cudaError_t quantize(const void* x, void* q, long long n, bool bf16, float scale,
                            cudaStream_t st) {
  if (n <= 0 || x == nullptr || q == nullptr) return cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const long long n16 = vec ? n / kVec : 0;
  const long long work = std::max(n16, n - n16 * kVec);
  const long long blocks = std::min<long long>((work + kThreads - 1) / kThreads,
                                               (long long)sm_count() * kBlocksPerSm);
  const unsigned grid = (unsigned)std::max<long long>(blocks, 1);
  if (bf16) {
    act_quantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), n, n16, scale);
  } else {
    act_quantize_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x),
                                                          static_cast<int8_t*>(q), n, n16, scale);
  }
  return cudaGetLastError();
}

// ------------------------------------------------- dynamic (per-group) scales
//
// The dynamic int8 modes (d3roma_tpu/ops/quant.py::int8_dot_general and
// int8_conv_general_dilated, which the JAX package leaves to XLA) quantize
// each scale group of x at its own scale: a batch item of a convolution's
// input, a row of a dense layer's. absmax_kernel maxes |x| over each group
// into amax[g] (fp32 bits; |x| >= 0 orders as its bits, so atomicMax on the
// bits is the float max; amax zeroed by the caller, a NaN is not
// propagated); the dependent quantize reads it as the scale
//   s[g] = max(amax[g] * fp32(1/127), 1e-8)
// (group_scale), the jitted JAX form of absmax / 127: XLA turns the division
// by a constant into a product with the fp32 reciprocal. The int8 conv's
// epilogue reads the same amax and forms the same s[g]. Nothing of it goes
// to the host.

constexpr float kInv127 = 0x1.020408p-7f;  // fp32(1/127)
constexpr int kAbsThreads = 256;

__device__ __forceinline__ float group_scale(unsigned amax_bits) {
  return fmaxf(__fmul_rn(__uint_as_float(amax_bits), kInv127), 1e-8f);
}

// One warp a task (a chunk of `chunk` elements of one group, a multiple of
// 256, the last chunk of a group shorter), tasks grid-strided over the
// warps. Each lane
// reads 16-byte vectors (8 bf16) where x is 16-byte aligned (group_elems is
// a multiple of 16), else one element at a time; a shuffle reduction, then
// one atomicMax a task.
__global__ void __launch_bounds__(kAbsThreads)
    absmax_groups_kernel(const __nv_bfloat16* __restrict__ x, unsigned* __restrict__ amax,
                         long long group_elems, long long chunk, long long chunks,
                         long long tasks, int vec) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * (kAbsThreads / 32);
  for (long long t = blockIdx.x * (long long)(kAbsThreads / 32) + threadIdx.x / 32; t < tasks;
       t += warps) {
    const long long g = t / chunks, c = t - g * chunks;
    const long long begin = g * group_elems + c * chunk;
    const long long stop = (g + 1) * group_elems;
    const long long end = begin + chunk < stop ? begin + chunk : stop;
    float m = 0.f;
    if (vec) {
      const uint4* v = reinterpret_cast<const uint4*>(x + begin);
      const long long nv = (end - begin) / 8;
      for (long long i = lane; i < nv; i += 32) {
        const uint4 u = v[i];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          m = fmaxf(m, fabsf(__uint_as_float(w[j] << 16)));
          m = fmaxf(m, fabsf(__uint_as_float(w[j] & 0xffff0000u)));
        }
      }
    } else {
      for (long long i = begin + lane; i < end; i += 32) m = fmaxf(m, fabsf(to_float(x[i])));
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) atomicMax(amax + g, __float_as_uint(m));
  }
  pdl::launch_dependents();
}

// The quantize of act_quantize_kernel with the scale of each element's
// group (a 16-element vector never straddles two groups: group_elems % 16
// == 0). A dependent launch on absmax_groups_kernel: it waits before reading
// amax.
__global__ void __launch_bounds__(kThreads)
    act_quantize_groups_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
                               long long n, long long n16, const unsigned* __restrict__ amax,
                               long long group_elems) {
  pdl::wait();
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = first; i < n16; i += stride) {
    const float scale = group_scale(amax[i * kVec / group_elems]);
    const Raw16<__nv_bfloat16> raw(x + i * kVec);
    uint32_t out[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        word |= (uint32_t)(uint8_t)quant1(raw.at(4 * w + j), scale) << (8 * j);
      }
      out[w] = word;
    }
    reinterpret_cast<uint4*>(q)[i] = make_uint4(out[0], out[1], out[2], out[3]);
  }
  for (long long i = n16 * kVec + first; i < n; i += stride) {
    q[i] = quant1(to_float(x[i]), group_scale(amax[i / group_elems]));
  }
  pdl::launch_dependents();
}

// Launch the per-group absmax of x (n bf16 elements in n / group_elems
// groups, contiguous) into amax (zeroed here first), then the quantization
// of x into q at the groups' scales as a dependent launch; returns the
// first error.
static cudaError_t quantize_groups(const void* x, void* q, unsigned* amax, long long n,
                                   long long group_elems, cudaStream_t st) {
  if (n <= 0 || group_elems <= 0 || group_elems % 16 != 0 || n % group_elems != 0 ||
      x == nullptr || q == nullptr || amax == nullptr) {
    return cudaErrorInvalidValue;
  }
  const long long groups = n / group_elems;
  cudaError_t err = cudaMemsetAsync(amax, 0, groups * sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  // chunks of about n / (64 warps an SM), 1024 to 32768 elements: enough
  // warps for the card where the groups are few and large (a convolution's
  // batch items), one atomic a chunk
  const long long per_warp = (n + 64LL * sm_count() - 1) / (64LL * sm_count());
  const long long chunk = std::min(32768LL, std::max(1024LL, (per_warp + 255) / 256 * 256));
  const long long chunks = (group_elems + chunk - 1) / chunk;
  const long long tasks = groups * chunks;
  const long long warps_per_block = kAbsThreads / 32;
  const unsigned abs_grid = (unsigned)std::max<long long>(
      1, std::min<long long>((tasks + warps_per_block - 1) / warps_per_block,
                             (long long)sm_count() * 8));
  absmax_groups_kernel<<<abs_grid, kAbsThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), amax, group_elems, chunk, chunks, tasks, (int)vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n16 = vec ? n / kVec : 0;
  const long long work = std::max(n16, n - n16 * kVec);
  const unsigned grid = (unsigned)std::max<long long>(
      1, std::min<long long>((work + kThreads - 1) / kThreads,
                             (long long)sm_count() * kBlocksPerSm));
  return pdl::launch(act_quantize_groups_kernel, dim3(grid), dim3(kThreads), 0, st, true,
                     static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), n, n16,
                     static_cast<const unsigned*>(amax), group_elems);
}

}  // namespace actq
}  // namespace d3r
