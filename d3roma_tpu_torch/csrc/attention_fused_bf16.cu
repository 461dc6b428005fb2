// Fused bf16 self-attention for Hopper (sm_90a): QKV projection, whole-row
// attention and output projection of one transformer self-attention site,
// with the arithmetic of the TPU kernel's bf16 body:
//   q, k, v = bf16(x . W) per head          bf16 products, fp32 sums
//   s = (q . k) * scale; p = exp(s - max)   fp32, keys past N masked
//   o_h = bf16((bf16(p) . v) / sum(p))
//   out = bf16(bo + sum over heads, in head order, of o_h . Wo_h)
//
// Replaces: d3roma_tpu/ops/pallas/attention_fused.py::fused_self_attention,
// its bf16 body (_kernel_bf16, quant=None). That TPU kernel sweeps (batch,
// 256-row q block, head) in order: at the first q block it projects K and V
// of all heads into VMEM scratch, then per program projects one q block for
// one head, takes the whole [256, N] score row, and adds the head's output
// projection to a [256, C] fp32 accumulator that starts at bo.
//
// What bounds it on the H100: operations. The projections do 8 N C^2 and
// the attention 4 N^2 C bf16 operations per batch item against ~4 N C bytes
// of x and out, hundreds of operations per byte at the site the gate admits
// (N = 920, C = 640: ~1800), above the ~295 where the bf16 tensor cores,
// not memory, become the limit.
//
// Design. Hopper blocks run in no order and share nothing, so the sweep
// becomes three launches (four with a split projection) on the caller's
// stream, each a kernel the port's other kernels use too:
//   1. conv_bf16_sm90_kernel (sm90_conv.cuh, the TMA + wgmma convolution)
//      as a 1x1 convolution over the B N rows: [B N, C] x [C, 3C], fp32
//      sums, one rounding, into a [B, N, 3C] bf16 workspace, in the tiles of
//      the wrapper's plan (ops/kernels/conv2d.py::conv_plan; with a split
//      of K, one more launch adds the fp32 partials);
//   2. mha_kernel (attention_bf16_rows.cuh) on q, k and v read in place
//      from that workspace through their strides by TMA, writing o [B, N,
//      H, 64]:
//      the row-1 kernel, whose arithmetic is that of this body's attention
//      (P rounded to bf16 for the PV product, the denominator summing the
//      fp32 P; an online softmax over key tiles instead of the whole row
//      changes only rounding);
//   3. out_proj_kernel (attention_out_proj.cuh): the per-head bf16 products
//      added to the bias in head order.
// The TPU kernel's [256, C] fp32 accumulator and its all-head K/V scratch do
// not fit a Hopper block's shared memory; q, k, v and o go through device
// memory instead (each written once and read at least once: 16 N C bytes a
// batch item, 19 MB a call at the admitted site at batch 2).

#include "attention_bf16_rows.cuh"
#include "attention_out_proj.cuh"
#include "sm90_conv.cuh"

// x [B, N, C] bf16, wqkv [3C, C] bf16 (the rows of Wq, Wk, Wv: one per output
// column), wo [C, C] bf16 (output column, then input), bo [C] fp32; out
// [B, N, C] bf16. Scratch: qkv [B, N, 3C] bf16, o [B, N, C] bf16, and
// partial [splits, B N, 3C] fp32 when the projection's plan splits K.
// proj_shape: the projection as a 1x1 convolution over the B N rows, the
// int array of sm90_conv.cuh's call_of (the wrapper's conv2d.launch_ints).
// All contiguous and 16-byte aligned; C = 64 H. Returns the first CUDA error
// of the launches.
extern "C" int d3r_fused_self_attention_bf16(const void* x, const void* wqkv, const void* wo,
                                             const void* bo, void* qkv, void* o, void* out,
                                             void* partial, const int* proj_shape, int B, int N,
                                             int C, int H, float scale, void* stream) {
  using d3r::bf16;
  if (B <= 0 || N <= 0 || H <= 0 || C != d3r::kOpHeadDim * H || proj_shape[2] != B * N ||
      proj_shape[3] != C || proj_shape[6] != 3 * C || proj_shape[18] != d3r::conv::kBf16) {
    return (int)cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<bf16*>(qkv);
  d3r::conv::Call proj = d3r::conv::call_of(x, wqkv, proj_shape);
  proj.out = qkv;
  proj.partial = partial;
  cudaError_t err = d3r::conv::run<bf16>(proj, d3r::conv::kBf16, st);
  if (err != cudaSuccess) return (int)err;

  const long long s[3] = {(long long)N * 3 * C, 3 * C, d3r::kOpHeadDim};
  err = d3r::launch_mha_bf16(w, w + C, w + 2 * C, static_cast<bf16*>(o), B, N, N, H,
                             d3r::kOpHeadDim, s, s, s, scale, st);
  if (err != cudaSuccess) return (int)err;

  d3r::OutProjArgs oa{static_cast<const bf16*>(o), static_cast<const bf16*>(wo),
                      static_cast<const float*>(bo), static_cast<bf16*>(out), B * N, C, H};
  return (int)d3r::launch_out_proj(oa, st);
}
