// int8 implicit-GEMM convolution for Hopper (sm_90a), NHWC, with the
// dequantization and the bias in the epilogue:
//   out[b, oy, ox, co] = bf16(bf16(deq(acc)) + bias[co])   (bf16 output), or
//   out[b, oy, ox, co] = deq(acc)                          (fp32 output, no bias)
//   acc = sum over (ky, kx, ci) of xq[b, oy*s + ky - pt, ox*s + kx - pl, ci]
//                                  * wq[co, ky, kx, ci]          (exact int32)
// in one of three epilogues, each the order of arithmetic of one reference:
//   "xla"  (0): deq = (acc * act_scale) * ws[co], the XLA int8 convolution of
//               the JAX package's quant="static" mode
//               (ops/quant.py::int8_conv_general_dilated_static);
//   "tpu"  (1): deq = acc * (act_scale * ws[co]), the Pallas kernels
//               conv2d.py::conv3x3_flat (_kernel_int8, quant="mxu") and
//               conv2d.py::conv3x3_rowtap (_kernel_rowtap_int8);
//   "halo" (2): as "tpu", but the sum is taken as conv2d_halo.py::_kernel
//               takes it: one exact int32 partial per row of taps (ky), each
//               converted to fp32 and added to an fp32 sum in ky order. It
//               differs from "tpu" once a partial or the sum passes 2^24.
//
// Replaces: d3roma_tpu/ops/pallas/conv2d.py::conv3x3_flat, its int8 path
// (kernel body _kernel_int8), conv2d.py::conv3x3_rowtap and
// conv2d_halo.py::conv3x3_halo (int8 body), and with them the XLA int8
// convolution and dot that the JAX package's static modes run at every
// other quantized site: the 3x3 stride-1 convs of the resnets and
// upsamplers, the stride-2 downsamplers (UNet: padding 1; VAE: padding
// (0, 1) and VALID), the 1x1 conv_shortcut, and every int8 dense layer (a
// 1x1 convolution over its rows, ops/quant.py::int8_linear). All compute
// the same integers: per-output-channel weight scales over all KH*KW*Cin
// taps (zero channels that the TPU kernels pad on change neither the
// scales nor the sums), activations quantized with one static scale (the
// entry point's quantize launch), exact int32 sums. The TPU kernels hold a whole
// padded frame (or a window of rows) in VMEM and run the taps as
// row-shifted GEMMs; a Hopper block cannot hold a frame (the VAE's
// full-resolution frames are 29 MB each), so the kernel loads, per k step,
// the tap-shifted box of its output tile's pixels (implicit GEMM).
//
// What bounds it on the H100: operations at the UNet's 3x3 sites (each
// input element takes part in 2*Cout*KH*KW/stride^2 operations, thousands,
// against the ~590 operations per byte where the int8 tensor cores, 1979
// TOP/s, become the limit); bytes at the VAE's full-resolution 128-channel
// sites and the 1x1 shortcuts, and at the dense layers below ~600 rows.
//
// Design: sm90_conv.cuh, the TMA + int8 wgmma implicit GEMM of the port's
// convolutions (4D pixel-box maps of x, a 3D map of w, persistent blocks,
// a K split with exact int32 partials where tiles are few); the epilogue is
// a template parameter of its kernel (conv_int8_sm90_kernel<epilogue, N>),
// "halo" keeping a second, fp32 accumulator. The tiles and the split come
// from the wrapper's plan (ops/kernels/conv2d.py::conv_plan). The entry
// point quantizes x itself (act_quantize.cuh) into the wrapper's int8
// workspace and launches the tiles as a dependent launch on that quantize
// (pdl.cuh): one host call per convolution or dense layer.
//
// The dynamic int8 modes (quant=True / "all" / "dense": the XLA int8
// convolution and dot of d3roma_tpu/ops/quant.py::int8_conv_general_dilated
// and int8_dot_general, which have no Pallas kernel) take the second entry
// point: the scale of each batch item (convolution) or row (dense) is its
// absmax / 127, computed on the device (act_quantize.cuh::quantize_groups:
// a memset and an absmax kernel, then the quantize as a dependent launch),
// and the "xla" epilogue dequantizes each output row at its group's scale,
// (acc * s[g]) * ws[co]. The scales never leave the device: the call makes
// no host synchronization.

#include "act_quantize.cuh"
#include "sm90_conv.cuh"

// x [B, H, W, Cin] bf16, quantized at act_scale into xq (int8 workspace of
// B H W Cin bytes, 16-byte aligned), w [Cout, KH, KW, Cin] int8, ws [Cout]
// fp32, bias [Cout] bf16 or null, out [B, OH, OW, Cout] bf16 (fp32 with
// out_f32, then bias null); all contiguous, all but x 16-byte aligned. Cin % 32 == 0, Cout % 2 ==
// 0. shape: the int array of sm90_conv.cuh's call_of, [B, H, W, Cin, OH, OW,
// Cout, KH, KW, stride, pad_t, pad_l, bw, bh, bb, bn, splits, per, epilogue,
// out_f32], with the plan's output box bw x bh x bb, bn output channels a
// tile and K in `splits` splits of `per` k steps, and epilogue 0 "xla", 1
// "tpu", 2 "halo" (see the top of this file). partial: [splits, B OH OW,
// Cout] int32 (fp32 for "halo") scratch when splits > 1. Returns the first
// CUDA error of the quantize and the conv's launches.
extern "C" int d3r_conv2d_int8(const void* x, void* xq, const void* w, const void* ws,
                               const void* bias, void* out, void* partial, const int* shape,
                               float act_scale, void* stream) {
  const int epilogue = shape[18];
  if (epilogue < d3r::conv::kXla || epilogue > d3r::conv::kHalo ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)shape[0] * shape[1] * shape[2] * shape[3];
  const cudaError_t err = d3r::actq::quantize(x, xq, n, true, act_scale, st);
  if (err != cudaSuccess) return (int)err;
  d3r::conv::Call c = d3r::conv::call_of(xq, w, shape);
  c.ws = static_cast<const float*>(ws);
  c.bias = static_cast<const __nv_bfloat16*>(bias);
  c.out = out;
  c.partial = partial;
  c.act_scale = act_scale;
  return (int)d3r::conv::run<int8_t>(c, epilogue, st);
}

// The dynamic-scale call: x as above, quantized into xq at per-group
// scales whose absmax amax [B H W Cin / group_elems] (fp32 bits, 4-byte
// aligned) the call computes first. group_elems: elements of x a group
// (H W Cin for a convolution's batch item, Cin for a dense layer's row, a
// multiple of 16); group_pixels: the output pixels of a group (OH OW, or
// 1). The epilogue must be "xla". Returns the first CUDA error of the
// memset, absmax, quantize and conv launches.
extern "C" int d3r_conv2d_int8_dynamic(const void* x, void* xq, void* amax, const void* w,
                                       const void* ws, const void* bias, void* out,
                                       void* partial, const int* shape, long long group_elems,
                                       long long group_pixels, void* stream) {
  if (shape[18] != d3r::conv::kXla || reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(amax) % 4 != 0 || group_pixels <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)shape[0] * shape[1] * shape[2] * shape[3];
  const cudaError_t err =
      d3r::actq::quantize_groups(x, xq, static_cast<unsigned*>(amax), n, group_elems, st);
  if (err != cudaSuccess) return (int)err;
  d3r::conv::Call c = d3r::conv::call_of(xq, w, shape);
  c.ws = static_cast<const float*>(ws);
  c.bias = static_cast<const __nv_bfloat16*>(bias);
  c.out = out;
  c.partial = partial;
  c.act_scale = 0.f;
  c.act_amax = static_cast<const unsigned*>(amax);
  c.group_pixels = group_pixels;
  return (int)d3r::conv::run<int8_t>(c, d3r::conv::kXla, st);
}
