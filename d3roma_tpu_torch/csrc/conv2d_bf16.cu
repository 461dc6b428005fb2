// bf16 3x3 convolution for Hopper (sm_90a), NHWC:
//   out = bf16(sum over (ky, kx, ci) of x * w), bf16 products, fp32 sums.
//
// Replaces: d3roma_tpu/ops/pallas/conv2d.py::conv3x3_flat, its bf16 path
// (kernel body _kernel_bf16: 9 tap GEMMs over row-shifted views of one
// padded frame in VMEM, fp32 accumulation, one cast), and the bf16 body of
// conv2d_halo.py::conv3x3_halo (three dy GEMMs over dx-folded rows, each an
// fp32 partial added to an fp32 sum). Both are fp32 sums of the same bf16
// products in different orders; this kernel is a third order.
//
// What bounds it on the H100: operations. Each input element takes part in
// 2*9*Cout operations (5760 at the UNet's 45x80x320 level) against ~295
// operations per byte where the bf16 tensor cores, not memory, become the
// limit.
//
// Design: conv2d_bf16.cuh, an implicit GEMM that gathers its zero-filled
// tap slices itself (no padded frame, no im2col buffer; a Hopper block
// cannot hold a frame as the TPU's VMEM does), 128 x 128 tiles, mma.sync
// m16n8k16. The kernel takes any KH, KW, stride and padding; the port calls
// it at 3x3, stride 1, padding 1.

#include "conv2d_bf16.cuh"

// x [B, H, W, Cin] bf16, w [Cout, KH, KW, Cin] bf16, out [B, OH, OW, Cout]
// bf16; contiguous, 16-byte aligned. Cin % 32 == 0, Cout % 2 == 0. Returns
// cudaGetLastError().
extern "C" int d3r_conv2d_bf16(const void* x, const void* w, void* out, int B, int H, int W,
                               int Cin, int OH, int OW, int Cout, int KH, int KW, int stride,
                               int pad_t, int pad_l, void* stream) {
  d3r::ConvBf16Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                      static_cast<__nv_bfloat16*>(out), B, H, W, Cin, OH, OW, Cout, KH, KW,
                      stride, pad_t, pad_l};
  return (int)d3r::launch_conv_bf16(a, static_cast<cudaStream_t>(stream));
}
