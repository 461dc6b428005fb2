// The standalone static int8 activation quantization: the kernel of
// act_quantize.cuh behind a C entry point of its own, for
// ops/kernels/quantize.py::quantize_int8_scalar.
//
// Replaces: the XLA quantize_int8 of the JAX package (d3roma_tpu/ops/quant.py:64).
// On the port's int8 paths the consumers launch the same kernel from their
// own entry points (conv2d_int8.cu, geglu_int8.cu, attention_fused_int8.cu;
// see act_quantize.cuh for the bound and the design).

#include "act_quantize.cuh"

// x: n elements (is_bf16 ? bf16 : fp32), contiguous; q: n int8. Returns
// the launch's CUDA error.
extern "C" int d3r_quantize_int8(const void* x, void* q, long long n, int is_bf16, float scale,
                                 void* stream) {
  return (int)d3r::actq::quantize(x, q, n, is_bf16 != 0, scale,
                                  static_cast<cudaStream_t>(stream));
}
