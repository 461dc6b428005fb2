// Programmatic dependent launch (PDL, sm_90) for the port's kernels.
//
// A kernel launched with cudaLaunchAttributeProgrammaticStreamSerialization
// (a "dependent" launch) may start while the kernel before it on the stream
// is still running: as soon as every block of that kernel has executed
// griddepcontrol.launch_dependents or exited. Its prologue (barrier init,
// tensor-map prefetch, loads of operands the earlier kernel does not write)
// then overlaps the earlier kernel's tail and the launch latency. Every
// thread of it that reads what the earlier kernel wrote must first execute
// griddepcontrol.wait, which returns once the earlier grid has completed and
// its memory operations are performed and made visible to this grid (PTX
// ISA, "griddepcontrol"). The guarantee is the one a kernel boundary gives,
// so TMA (the async proxy) may read those writes after the wait without a
// proxy fence: fence.proxy.async orders one grid's own generic and async
// accesses, and the writes here come from a grid that has completed. In a
// kernel launched without the attribute the wait returns at once.
//
// Used by the int8 ops whose C entry point quantizes their activation first
// (act_quantize.cuh): conv2d_int8.cu, geglu_int8.cu, attention_fused_int8.cu.

#pragma once

#include <cuda_runtime.h>

#include <utility>

namespace d3r {
namespace pdl {

// Wait for the grid this one depends on (a no-op without a dependent launch).
__device__ __forceinline__ void wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// Let the dependent grid start (its blocks still wait before reading ours).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Launch kernel<<<grid, block, smem, st>>>(args...), as a dependent launch
// when `dependent`; returns the launch's error.
template <typename... Params, typename... Args>
static cudaError_t launch(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                          cudaStream_t st, bool dependent, Args&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace pdl
}  // namespace d3r
