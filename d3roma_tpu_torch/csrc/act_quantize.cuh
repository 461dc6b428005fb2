// int8 quantization of an activation tensor for Hopper (sm_90a):
//   q = clip(round_half_even(x / scale), -127, 127)
// with one fp32 scale for the whole tensor (the static modes), x bf16 or
// fp32; or, for the dynamic modes, one scale a group computed on the device
// (row_quantize_kernel, absmax_slots_kernel, act_quantize_groups_kernel;
// the second half of this file).
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
// input, a row of a dense layer's. The scale is
//   s[g] = max(absmax[g] * fp32(1/127), 1e-8)
// (group_scale), the jitted JAX form of absmax / 127: XLA turns the division
// by a constant into a product with the fp32 reciprocal. Nothing of it goes
// to the host, and nothing is zeroed before a call: every slot a call reads
// is written by the same call.
//
// Two producers of the absmax:
// - a dense layer's rows: row_quantize_kernel, one team of threads (a warp,
//   or several warps reducing through shared memory) a row, reads the row
//   once into registers, reduces its absmax, forms s and writes the int8 row
//   and the row's absmax to its own slot: one pass over x, no atomics;
// - a convolution's batch items: absmax_slots_kernel, one block a (group,
//   chunk) task, writes the chunk's max |x| to slot g * chunks + c. A reader
//   folds its group's slots (fold_slots: max is exact in any order). The
//   plan bounds the chunks a group (kMaxChunks). The quantize of x then runs
//   either as its own dependent launch (act_quantize_groups_kernel, for the
//   3x3 stride-1 convolutions, whose input elements the convolution loads
//   nine times) or inside the convolution's loader (sm90_conv.cuh,
//   loadq), where an element is loaded about once.
//
// NaN: the absmax is a chain of fmaxf, which returns the other operand, so a
// NaN in x is skipped by the absmax; quantized, a NaN becomes -127 (fmaxf(NaN,
// -127)). An infinity makes its group's scale infinite: the group's finite
// values quantize to 0, the infinities to -127 (inf / inf is NaN). The plain
// version (torch.amax) propagates a NaN into its group's scale instead.
//
// The division. quant_fast gives quant1's value without a division, from
// the correctly rounded reciprocal r = fl(1/s): q0 = fl(x * r) is within an
// ulp of x / s, the remainder x - q0 * s is exact in one fma, and q1 =
// fl(q0 + (x - q0 * s) * r), a second fma, is the correctly rounded
// quotient fl(x / s) (Markstein's theorem; it needs r within half an ulp of
// 1/s and no underflow, and where x or the quotient is subnormal the
// quotient is far below 0.5 and rounds to 0 either way). Where |q1| > 128
// or q1 is not a number (q0 past the range, or infinite: the remainder is
// then inf - inf; an infinite scale, r = 0) q0 takes its place: past the
// clip it clips the same, and a NaN or 0 * inf quotient is what the IEEE
// division gives there. The rounding is (v + 1.5 * 2^23) - 1.5 * 2^23, exact
// and half to even for |v| <= 127, and the sum's bits hold the int8 in their
// low byte. No division, no branch and no conversion instruction (those run
// at a quarter of the fp32 rate): about nine full-rate instructions a value.
// tests/test_torch_dynamic_plan.py holds a model of it, the fmas emulated
// exactly, bit-equal to quantize_int8_plain over every finite bf16 value at
// 20 scales, and at NaN and infinities.

constexpr float kInv127 = 0x1.020408p-7f;  // fp32(1/127)
constexpr int kAbsThreads = 256;
constexpr int kMaxChunks = 64;     // absmax slots a group (the plan's bound)
constexpr int kMaxGroups = 128;    // groups of a convolution (its batch items)
constexpr int kRowThreads = 256;
constexpr int kRowMaxVecs = 8;     // 16-byte vectors of a row a thread holds

__device__ __forceinline__ float group_scale(float amax) {
  return fmaxf(__fmul_rn(amax, kInv127), 1e-8f);
}

constexpr float kRound = 12582912.f;  // 1.5 * 2^23

__device__ __forceinline__ float clip127(float v) { return fminf(fmaxf(v, -127.f), 127.f); }

// The low bytes of four words, in order, as one word
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// The eight bf16 of a 16-byte vector, as floats
__device__ __forceinline__ float bf16_at(const uint4& v, int j) {
  const uint32_t w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
  return __uint_as_float(j % 2 ? w & 0xffff0000u : w << 16);
}

__device__ __forceinline__ float absmax8(const uint4& v, float m) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m = fmaxf(m, fabsf(__uint_as_float(w[j] << 16)));
    m = fmaxf(m, fabsf(__uint_as_float(w[j] & 0xffff0000u)));
  }
  return m;
}

// quant1(x, s) with r = __frcp_rn(s), without a division (see above): the
// int8 is the low byte of the returned bits
__device__ __forceinline__ uint32_t quant_fast(float x, float s, float r) {
  const float q0 = __fmul_rn(x, r);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, s, x), r, q0);
  return __float_as_uint(__fadd_rn(clip127(fabsf(q1) <= 128.f ? q1 : q0), kRound));
}

// The eight int8 of the eight bf16 of v at scale s, reciprocal r
__device__ __forceinline__ uint2 quant8(const uint4& v, float s, float r) {
  uint32_t q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) q[j] = quant_fast(bf16_at(v, j), s, r);
  return make_uint2(low_bytes(q[0], q[1], q[2], q[3]), low_bytes(q[4], q[5], q[6], q[7]));
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// The absmax of group g from its `chunks` slots.
__device__ __forceinline__ float fold_slots(const float* slots, int g, int chunks) {
  float m = 0.f;
  for (int c = 0; c < chunks; ++c) m = fmaxf(m, slots[g * chunks + c]);
  return m;
}

// A dense layer's rows: `team` threads a row (32, 64, 128 or 256), kVecs
// 16-byte vectors of the row a thread (vector i of the row to thread
// i % team), k % 8 == 0, x 16-byte aligned. Writes q's row and amax[row]
// (the row's absmax, fp32).
template <int kVecs>
__global__ void __launch_bounds__(kRowThreads)
    row_quantize_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
                        float* __restrict__ amax, long long rows, int k, int team) {
  __shared__ float partial[kRowThreads / 32];
  const long long row = (long long)blockIdx.x * (kRowThreads / team) + threadIdx.x / team;
  const int lt = threadIdx.x % team, nv = k / 8;
  const bool live = row < rows;
  const uint4* src = reinterpret_cast<const uint4*>(x + (live ? row : 0) * k);
  uint4 v[kVecs];
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int i = lt + j * team;
    v[j] = live && i < nv ? src[i] : make_uint4(0u, 0u, 0u, 0u);
    m = absmax8(v[j], m);
  }
  m = warp_max(m);
  if (team > 32) {  // the team's warps through shared memory (team is uniform)
    if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = m;
    __syncthreads();
    const int w0 = threadIdx.x / team * (team / 32);
    for (int w = 0; w < team / 32; ++w) m = fmaxf(m, partial[w0 + w]);
  }
  const float s = group_scale(m), r = __frcp_rn(s);
  uint2* dst = reinterpret_cast<uint2*>(q + (live ? row : 0) * k);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int i = lt + j * team;
    if (live && i < nv) dst[i] = quant8(v[j], s, r);
  }
  if (live && lt == 0) amax[row] = m;
  pdl::launch_dependents();
}

// Launch the row quantize of x [rows, k] into q and amax [rows]; returns
// the launch's error.
static cudaError_t quantize_rows(const void* x, void* q, float* amax, long long rows, int k,
                                 int team, int vecs, cudaStream_t st) {
  if (rows <= 0 || k <= 0 || k % 8 != 0 || (team != 32 && team != 64 && team != 128 &&
      team != 256) || vecs < 1 || vecs > kRowMaxVecs || (long long)team * vecs * 8 < k ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const long long per_block = kRowThreads / team;
  const dim3 grid((unsigned)((rows + per_block - 1) / per_block));
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* qb = static_cast<int8_t*>(q);
  switch (vecs) {
#define D3R_ROWQ(V) \
  case V:           \
    row_quantize_kernel<V><<<grid, kRowThreads, 0, st>>>(xb, qb, amax, rows, k, team); break;
    D3R_ROWQ(1) D3R_ROWQ(2) D3R_ROWQ(3) D3R_ROWQ(4) D3R_ROWQ(5) D3R_ROWQ(6) D3R_ROWQ(7)
    D3R_ROWQ(8)
#undef D3R_ROWQ
  }
  return cudaGetLastError();
}

// A convolution's batch items: block t = g * chunks + c reduces the max |x|
// over elements [c * chunk, min((c + 1) * chunk, group_elems)) of group g
// (chunk and group_elems multiples of 8, x 16-byte aligned: 16-byte loads,
// four in flight a thread) into slots[t].
__global__ void __launch_bounds__(kAbsThreads)
    absmax_slots_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ slots,
                        long long group_elems, long long chunk, int chunks) {
  __shared__ float partial[kAbsThreads / 32];
  const long long g = blockIdx.x / chunks, c = blockIdx.x - g * chunks;
  const long long begin = c * chunk;
  const long long end = begin + chunk < group_elems ? begin + chunk : group_elems;
  const uint4* v = reinterpret_cast<const uint4*>(x + g * group_elems + begin);
  const long long nv = (end - begin) / 8;
  float m = 0.f;
  long long i = threadIdx.x;
  for (; i + 3 * kAbsThreads < nv; i += 4 * kAbsThreads) {
    const uint4 a = v[i], b = v[i + kAbsThreads], d = v[i + 2 * kAbsThreads],
                e = v[i + 3 * kAbsThreads];
    m = absmax8(e, absmax8(d, absmax8(b, absmax8(a, m))));
  }
  for (; i < nv; i += kAbsThreads) m = absmax8(v[i], m);
  m = warp_max(m);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kAbsThreads / 32; ++w) m = fmaxf(m, partial[w]);
    slots[blockIdx.x] = m;
  }
  pdl::launch_dependents();
}

static cudaError_t absmax_slots(const void* x, float* slots, long long groups,
                                long long group_elems, long long chunk, int chunks,
                                cudaStream_t st) {
  if (groups <= 0 || group_elems <= 0 || group_elems % 8 != 0 || chunk <= 0 || chunk % 8 != 0 ||
      chunks < 1 || chunks > kMaxChunks || (chunks - 1) * chunk >= group_elems ||
      chunks * chunk < group_elems || groups * chunks > (1LL << 31) - 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  absmax_slots_kernel<<<(unsigned)(groups * chunks), kAbsThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), slots, group_elems, chunk, chunks);
  return cudaGetLastError();
}

// The quantize of act_quantize_kernel with the scale of each element's
// group (groups <= kMaxGroups; a 16-element vector never straddles two
// groups: group_elems % 16 == 0). A dependent launch on absmax_slots_kernel:
// it waits, then folds every group's slots into a table in shared memory.
__global__ void __launch_bounds__(kThreads)
    act_quantize_groups_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
                               long long n16, const float* __restrict__ slots, int groups,
                               int chunks, long long group_elems) {
  __shared__ float scale[kMaxGroups], recip[kMaxGroups];
  pdl::wait();
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    scale[g] = group_scale(fold_slots(slots, g, chunks));
    recip[g] = __frcp_rn(scale[g]);
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n16; i += stride) {
    const int g = (int)(i * kVec / group_elems);
    const uint4* v = reinterpret_cast<const uint4*>(x + i * kVec);
    const uint2 lo = quant8(v[0], scale[g], recip[g]), hi = quant8(v[1], scale[g], recip[g]);
    reinterpret_cast<uint4*>(q)[i] = make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
  pdl::launch_dependents();
}

// Launch the groups' quantize of x (n bf16 elements, 16-byte aligned, in n
// / group_elems <= kMaxGroups groups) into q as a dependent launch on the
// absmax that wrote `slots`; returns the launch's error.
static cudaError_t quantize_groups(const void* x, void* q, const float* slots, long long n,
                                   long long group_elems, int chunks, cudaStream_t st) {
  if (n <= 0 || group_elems <= 0 || group_elems % 16 != 0 || n % group_elems != 0 ||
      n / group_elems > kMaxGroups || chunks < 1 || chunks > kMaxChunks ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const long long n16 = n / kVec;
  const unsigned grid = (unsigned)std::max<long long>(
      1, std::min<long long>((n16 + kThreads - 1) / kThreads,
                             (long long)sm_count() * kBlocksPerSm));
  return pdl::launch(act_quantize_groups_kernel, dim3(grid), dim3(kThreads), 0, st, true,
                     static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), n16, slots,
                     (int)(n / group_elems), chunks, group_elems);
}

}  // namespace actq
}  // namespace d3r
