// bf16 convolution for Hopper (sm_90a), NHWC:
//   out = bf16(sum over (ky, kx, ci) of x * w), bf16 products, fp32 sums.
//
// Replaces: d3roma_tpu/ops/pallas/conv2d.py::conv3x3_flat, its bf16 path
// (kernel body _kernel_bf16: 9 tap GEMMs over row-shifted views of one
// padded frame in VMEM, fp32 accumulation, one cast), and the bf16 body of
// conv2d_halo.py::conv3x3_halo (three dy GEMMs over dx-folded rows, each an
// fp32 partial added to an fp32 sum). Both are fp32 sums of the same bf16
// products in different orders; this kernel is a third order (and a fourth
// where the plan splits K: fp32 partials added in split order).
//
// What bounds it on the H100: operations. Each input element takes part in
// 2*9*Cout operations (5760 at the UNet's 45x80x320 level) against ~295
// operations per byte where the bf16 tensor cores, not memory, become the
// limit.
//
// Design: sm90_conv.cuh, the port's TMA + wgmma implicit-GEMM convolution,
// with bf16 operands and fp32 sums (conv_bf16_sm90_kernel<N>); the tiles
// and the split come from the wrapper's plan
// (ops/kernels/conv2d.py::conv_plan). The kernel takes any KH, KW, stride
// and padding; the port calls it at 3x3, stride 1, padding 1.

#include "sm90_conv.cuh"

// x [B, H, W, Cin] bf16, w [Cout, KH, KW, Cin] bf16, out [B, OH, OW, Cout]
// bf16; contiguous, 16-byte aligned. Cin % 32 == 0, Cout % 2 == 0. shape:
// as d3r_conv2d_int8's, with epilogue 3 (bf16) and out_f32 0; partial
// [splits, B OH OW, Cout] fp32 scratch when splits > 1. Returns a CUDA
// error code.
extern "C" int d3r_conv2d_bf16(const void* x, const void* w, void* out, void* partial,
                               const int* shape, void* stream) {
  if (shape[18] != d3r::conv::kBf16) return (int)cudaErrorInvalidValue;
  d3r::conv::Call c = d3r::conv::call_of(x, w, shape);
  c.out = out;
  c.partial = partial;
  return (int)d3r::conv::run<__nv_bfloat16>(c, d3r::conv::kBf16,
                                            static_cast<cudaStream_t>(stream));
}
