// Building blocks of the port's Hopper GEMMs (sm_90a), generic in the
// operand type (bf16 with fp32 sums, int8 with int32 sums) and in what the
// caller does with the sums (its epilogue). Used by geglu.cu and
// geglu_int8.cu, by the implicit-GEMM convolution (sm90_conv.cuh), by the
// Winograd convolution (winograd_fused.cu) and, for its TMA and wgmma
// pieces, by the int8 whole-row attention (attention_int8_rows.cuh).
//
// A block is three warpgroups: two consumers and one producer. The producer
// keeps a ring of kStages shared-memory stages filled by TMA
// (cp.async.bulk.tensor, completion on an mbarrier per stage); each stage
// holds 128 bytes of the contraction axis K of an A tile [128 rows] and a B
// tile [kBN rows], both K-contiguous ("K-major") in device memory, written
// by TMA with the 128-byte swizzle. Each consumer warpgroup issues wgmma
// m64 x kBN on its 64 rows of the stage, keeps the sums in registers, and
// hands the stage back through its "empty" mbarrier. Blocks are persistent:
// a block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... and the
// producer runs ahead into the next tile's loads while the consumers run
// the epilogue of this one.
//
// Shared-memory layout a wgmma descriptor reads (PTX ISA, "Matrix
// Descriptor Format"): K-major with the 128-byte swizzle, each row of the
// tile is 128 bytes, 8 rows form a 1024-byte swizzle atom (the stride byte
// offset), the tile starts on a 1024-byte boundary, and a k step of 32
// bytes (16 bf16 or 32 int8) adds 32 bytes to the start address. The TMA
// box of every map is 128 bytes of K innermost, with
// CU_TENSOR_MAP_SWIZZLE_128B to match; a box of more dimensions (the
// convolution's pixel rectangles) lands as its rows in order, each 128
// bytes, swizzled by the same rule. Reads past the tensor's edge fill
// zeros, so the K tail of a stage and the rows past the last one add
// nothing to the sums.
//
// Accumulator fragment of wgmma m64nN (PTX ISA, "Register fragments" for
// wgmma .m64nNk16 / .m64nNk32): thread t of the warpgroup holds N / 2 values;
// value 4j + e sits at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2) and
// column 8j + 2 (t % 4) + e % 2 of the warpgroup's 64 x N tile.
//
// The tensor maps come from cuTensorMapEncodeTiled, a driver call fetched
// with cudaGetDriverEntryPoint (no link against libcuda), and are cached
// by their arguments, so a weight's maps are built once.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <functional>
#include <mutex>
#include <unordered_map>

#include "pdl.cuh"

namespace d3r {
namespace sm90 {

constexpr int kConsumers = 2;                     // m64 warpgroups per block
constexpr int kBlockRows = 64 * kConsumers;       // rows of an A tile
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
constexpr int kStages = 4;
constexpr int kKBytes = 128;                      // bytes of K per stage

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

constexpr int kMaxRank = 5;

struct MapKey {
  const void* ptr;
  uint32_t rank, elem_bytes;
  uint64_t dims[kMaxRank], strides[kMaxRank - 1];
  uint32_t box[kMaxRank], steps[kMaxRank];
  bool operator==(const MapKey& o) const {
    if (ptr != o.ptr || rank != o.rank || elem_bytes != o.elem_bytes) return false;
    for (int i = 0; i < kMaxRank; ++i) {
      if (dims[i] != o.dims[i] || box[i] != o.box[i] || steps[i] != o.steps[i]) return false;
      if (i + 1 < kMaxRank && strides[i] != o.strides[i]) return false;
    }
    return true;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr) ^ (size_t(k.rank) << 8 | k.elem_bytes);
    for (int i = 0; i < kMaxRank; ++i) {
      for (uint64_t v : {k.dims[i], (uint64_t)k.box[i], (uint64_t)k.steps[i],
                         i + 1 < kMaxRank ? k.strides[i] : 0}) {
        h = h * 1000003u ^ std::hash<uint64_t>()(v);
      }
    }
    return h;
  }
};

// The TMA map of a tensor of bf16 (elem_bytes 2) or int8 (1) elements at
// ptr: `rank` dimensions, innermost first, of sizes dims, the outer ones
// strides[i - 1] bytes apart; read in boxes of box[i] elements that take
// every steps[i]-th element (TMA's element strides: a box then lands
// box[i] / steps[i] elements along dimension i), with the 128-byte swizzle,
// so box[0] must cover 128 bytes. A map is a pure function of its
// arguments, so the cache never serves a stale one.
inline cudaError_t tensor_map_nd(CUtensorMap* map, const void* ptr, uint32_t elem_bytes,
                                 uint32_t rank, const uint64_t* dims, const uint64_t* strides,
                                 const uint32_t* box, const uint32_t* steps) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  if (rank < 1 || rank > (uint32_t)kMaxRank) return cudaErrorInvalidValue;
  MapKey key{};
  key.ptr = ptr;
  key.rank = rank;
  key.elem_bytes = elem_bytes;
  for (uint32_t i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    key.steps[i] = steps[i];
    if (i > 0) key.strides[i - 1] = strides[i - 1];
  }
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = cache.find(key);
    if (it != cache.end()) {
      *map = it->second;
      return cudaSuccess;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  cuuint64_t d[kMaxRank], st[kMaxRank - 1];
  cuuint32_t b[kMaxRank], e[kMaxRank];
  for (uint32_t i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = steps[i];
    if (i > 0) st[i - 1] = strides[i - 1];
  }
  const CUresult r = encode(
      map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      rank, const_cast<void*>(ptr), d, st, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

// The TMA map of a row-major matrix [rows, cols] at ptr, rows `stride`
// bytes apart, read in boxes of 128 bytes x box_rows.
inline cudaError_t tensor_map(CUtensorMap* map, const void* ptr, uint32_t elem_bytes,
                              uint64_t rows, uint64_t cols, uint64_t stride,
                              uint32_t box_rows) {
  const uint64_t dims[2] = {cols, rows};
  const uint64_t strides[1] = {stride};
  const uint32_t box[2] = {kKBytes / elem_bytes, box_rows};
  const uint32_t steps[2] = {1, 1};
  return tensor_map_nd(map, ptr, elem_bytes, 2, dims, strides, box, steps);
}

constexpr int kMaxDevices = 64;

// Launch kKernel on a persistent grid over `tiles` tiles (one block per SM
// at most) with `smem` bytes of dynamic shared memory; with kDependent, as a
// dependent launch (pdl.cuh) on the kernel before it on the stream. The SM
// count and the shared-memory attribute are looked up once per device.
// Internal linkage (static): the statics must belong to one library's
// kernel. Two libraries built from this header can instantiate `launch` for
// kernels of the same name (sm90_conv.cuh's), and with external linkage the
// dynamic linker merges such statics across the process, so the second
// library would skip setting its own kernel's shared-memory attribute.
template <auto kKernel, bool kDependent = false, typename... Args>
static cudaError_t launch(int tiles, size_t smem, cudaStream_t st, const Args&... args) {
  static std::atomic<int> sms[kMaxDevices];
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev].load() == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev].store(n);
  }
  if (!smem_set[dev].load()) {
    err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set[dev].store(true);
  }
  const int blocks = std::max(1, std::min(tiles, sms[dev].load()));
  if constexpr (kDependent) {
    return pdl::launch(kKernel, dim3(blocks), dim3(kThreads), smem, st, true, args...);
  } else {
    kKernel<<<blocks, kThreads, smem, st>>>(args...);
    return cudaGetLastError();
  }
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier has completed the phase of the given parity. A
// wait of more than ~2^34 cycles (about 10 s) traps: a fault in the
// pipeline then ends the kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// TMA: the box of `map` at (col, row) (col in elements) into shared memory,
// its bytes counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Bring a TMA map (a __grid_constant__ kernel parameter) into the cache
// before its first use.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle (see above).
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving accesses of the sums across a wgmma.
template <int N>
__device__ __forceinline__ void fence_sums(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_sums(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Make this thread's writes to shared memory visible to the async proxy
// (TMA, wgmma) before a barrier that hands them over.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier of the 128 threads of warpgroup wg (ids 1.., 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// d (+)= A (64 x k step) . B (N x k step)^T: bf16 into fp32 (k step 16),
// int8 into int32 (k step 32); `accumulate` 0 overwrites d.
template <typename Acc, int N>
__device__ void wgmma(Acc (&d)[N / 2], uint64_t a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma<float, 64>(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, "
      "p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<float, 128>(float (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, "
      "p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<int, 64>(int (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, "
      "p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<int, 128>(int (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, "
      "p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<float, 160>(float (&d)[80], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, %80, %81, "
      "p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<int, 160>(int (&d)[80], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, %80, %81, "
      "p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]),
        "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]),
        "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]),
        "+r"(d[79])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<int, 32>(int (&d)[16], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, "
      "p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<int, 96>(int (&d)[48], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, "
      "p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Row within the warpgroup's 64 and column within its N of sum 4j + e.
__device__ __forceinline__ int frag_row(int e) {
  return (threadIdx.x % 128) / 32 * 16 + (threadIdx.x % 32) / 4 + 8 * (e >> 1);
}

__device__ __forceinline__ int frag_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x % 4) + (e & 1);
}

// Position in a ring of kN stages; both sides walk the same sequence.
template <int kN = kStages>
struct RingN {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == kN) {
      stage = 0;
      phase ^= 1;
    }
  }
};
using Ring = RingN<>;

// The ring in dynamic shared memory: kStages x (A tile, B tile of kBN
// rows), each 1024-byte aligned, then the full and empty barriers.
template <int kBN>
struct Stages {
  static constexpr int kABytes = kBlockRows * kKBytes;
  static constexpr int kBBytes = kBN * kKBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr size_t kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;

  uint8_t* tiles;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit Stages(uint8_t* raw)
      : tiles(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023)),
        full(reinterpret_cast<uint64_t*>(tiles + kStages * kStageBytes)),
        empty(full + kStages) {}

  __device__ uint8_t* a(int s) const { return tiles + s * kStageBytes; }
  __device__ uint8_t* b(int s) const { return a(s) + kABytes; }

  // One thread, before the block's __syncthreads.
  __device__ void init() const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Producer (one thread): wait until stage r.stage is free and arm its
  // full barrier for `bytes` bytes of TMA loads, which the caller issues
  // (each box counts whole, its zero-filled part included) before r.next().
  __device__ void acquire(const Ring& r, uint32_t bytes) const {
    mbar_wait(&empty[r.stage], r.phase ^ 1);
    mbar_expect_tx(&full[r.stage], bytes);
  }

  // Producer (one thread): the next stage gets the A tile at (k, a_row) and
  // the B tile at (k, b_row) of b_map, or, with b2_map, kBN / 2 rows at
  // b_row of b_map over kBN / 2 rows at b2_row of b2_map. k in elements.
  __device__ void load(Ring& r, const CUtensorMap* a_map, int a_row, const CUtensorMap* b_map,
                       int b_row, const CUtensorMap* b2_map, int b2_row, int k) const {
    acquire(r, kStageBytes);
    tma_load(a(r.stage), a_map, &full[r.stage], k, a_row);
    tma_load(b(r.stage), b_map, &full[r.stage], k, b_row);
    if (b2_map != nullptr) {
      tma_load(b(r.stage) + kBBytes / 2, b2_map, &full[r.stage], k, b2_row);
    }
    r.next();
  }

  // Producer (one thread), for a dependent launch whose A operand the
  // kernel before it writes: load_b arms the next stage for the whole stage
  // and loads only its B tile(s), before the wait (pdl.cuh); load_a, after
  // the wait, loads the A tile of the stage that load_b armed at the same
  // position of the ring. Together they do what load does.
  __device__ void load_b(Ring& r, const CUtensorMap* b_map, int b_row, const CUtensorMap* b2_map,
                         int b2_row, int k) const {
    acquire(r, kStageBytes);
    tma_load(b(r.stage), b_map, &full[r.stage], k, b_row);
    if (b2_map != nullptr) {
      tma_load(b(r.stage) + kBBytes / 2, b2_map, &full[r.stage], k, b2_row);
    }
    r.next();
  }

  __device__ void load_a(Ring& r, const CUtensorMap* a_map, int a_row, int k) const {
    tma_load(a(r.stage), a_map, &full[r.stage], k, a_row);
    r.next();
  }

  // Consumer warpgroup wg: d (+)= its 64 rows of A . B^T over the next n
  // stages (128 bytes of K each); d is overwritten by the first. One group
  // of wgmmas stays in flight: a stage goes back to the producer once the
  // products of the stage after it are issued.
  template <typename Acc>
  __device__ void mma(Ring& r, int wg, Acc (&d)[kBN / 2], int n) const {
    int prev = -1;
    for (int kt = 0; kt < n; ++kt) {
      mbar_wait(&full[r.stage], r.phase);
      const uint64_t da = smem_desc(a(r.stage) + wg * 64 * kKBytes);
      const uint64_t db = smem_desc(b(r.stage));
      fence_sums(d);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kKBytes / 32; ++k) {
        wgmma<Acc, kBN>(d, da + 2 * k, db + 2 * k, kt > 0 || k > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);
      prev = r.stage;
      r.next();
    }
    wgmma_wait<0>();
    fence_sums(d);
    if (prev >= 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);
  }
};

// Write a warpgroup's tile of 64 rows x row_bytes (a multiple of 16),
// staged in shared memory `pitch` bytes a row, to global memory at dst
// (row r at dst + r * stride) with 16-byte stores; rows from `valid` on
// are skipped. Callers bracket it with warpgroup_sync.
__device__ __forceinline__ void store_tile(const uint8_t* src, int pitch, int row_bytes,
                                           uint8_t* dst, long long stride, int valid) {
  const int chunks = row_bytes / 16;
  for (int i = threadIdx.x % 128; i < 64 * chunks; i += 128) {
    const int r = i / chunks, c = i % chunks;
    if (r < valid) {
      *reinterpret_cast<uint4*>(dst + r * stride + c * 16) =
          *reinterpret_cast<const uint4*>(src + r * pitch + c * 16);
    }
  }
}

// out[i] = bf16(bias[i % C] + partial[0][i] + partial[1][i] + ...), the
// fp32 sum taken in that order; partial is [splits, n] with n = rows * C.
__device__ __forceinline__ void sum_partials(const float* __restrict__ partial,
                                             const float* __restrict__ bias,
                                             __nv_bfloat16* __restrict__ out, long long n, int C,
                                             int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = bias[i % C];
  for (int s = 0; s < splits; ++s) v = __fadd_rn(v, partial[s * n + i]);
  out[i] = __float2bfloat16(v);
}

}  // namespace sm90
}  // namespace d3r
