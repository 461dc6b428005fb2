// Static int8 quantization of an activation tensor for Hopper (sm_90a):
//   q = clip(round_half_even(x / scale), -127, 127)
// with one fp32 scale for the whole tensor.
//
// Replaces: the elementwise quantize_int8 that the JAX package leaves to XLA
// (d3roma_tpu/ops/quant.py:64, fused there into the producing op) in front of
// every static int8 dense, convolution and fused GEGLU. There is no Pallas
// kernel behind it; the port needs it as a kernel because PyTorch has no
// fused op for it, and five separate elementwise ops would move the tensor
// five times.
//
// What bounds it on the H100: bytes. 2 bytes read and 1 written per element
// of a bf16 input; no arithmetic worth counting.
//
// Design: a grid-stride loop; 8 elements per thread and iteration (one
// 16-byte load of bf16, one 8-byte store) when the tensor is 16-byte aligned
// and its size a multiple of 8, else one element at a time. The division is
// IEEE (__fdiv_rn), not a multiply by the reciprocal, and rintf rounds half
// to even, as jnp.round does, so the result is bit-equal to the JAX
// package's and to the plain PyTorch version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ int8_t quant1(float x, float scale) {
  const float q = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
}

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__global__ void quantize_scalar(const T* __restrict__ x, int8_t* __restrict__ q, long long n,
                                float scale) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    q[i] = quant1(to_float(x[i]), scale);
  }
}

__global__ void quantize_bf16_vec8(const uint4* __restrict__ x, uint2* __restrict__ q,
                                   long long n8, float scale) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n8;
       i += (long long)gridDim.x * blockDim.x) {
    const uint4 v = x[i];
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    int8_t out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = quant1(__bfloat162float(e[j]), scale);
    q[i] = *reinterpret_cast<const uint2*>(out);
  }
}

int grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  return (int)(blocks < 132LL * 16 ? (blocks > 0 ? blocks : 1) : 132LL * 16);
}

}  // namespace

// x: n elements (is_bf16 ? bf16 : fp32), contiguous; q: n int8. Returns
// cudaGetLastError().
extern "C" int d3r_quantize_int8(const void* x, void* q, long long n, int is_bf16, float scale,
                                 void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;
  const bool vec = is_bf16 && n % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 8 == 0;
  if (vec) {
    quantize_bf16_vec8<<<grid_for(n / 8, kThreads), kThreads, 0, st>>>(
        static_cast<const uint4*>(x), static_cast<uint2*>(q), n / 8, scale);
  } else if (is_bf16) {
    quantize_scalar<bf16><<<grid_for(n, kThreads), kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<int8_t*>(q), n, scale);
  } else {
    quantize_scalar<float><<<grid_for(n, kThreads), kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q), n, scale);
  }
  return (int)cudaGetLastError();
}
