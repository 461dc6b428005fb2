// Multi-head attention for Hopper (sm_90a), bf16 in and out, fp32 softmax.
//
// Replaces: d3roma_tpu/ops/pallas/attention.py::mha_attention, its
// bf16/fp32 path (kernel body _kernel_f32). That TPU kernel holds a whole
// [block_q, M] fp32 score row in VMEM and takes one max-then-exp softmax per
// row; keys are padded to 128 and masked at -1e30.
//
// What bounds it on the H100: operations, with the softmax close behind.
// At the UNet's flagship sites (N = M = 3600, H = 5, D = 64 and N = M = 920,
// H = 10, D = 64) the two products do 4*N*M*D flops per (batch, head)
// against 8*N*D bytes of q, k, v and o, i.e. ~M/2 = 1800 flops per byte,
// far above the ~295 flops per byte where the bf16 tensor cores, not
// memory, become the limit; the softmax's one exponential a score on the
// SFUs (16 a clock per SM) takes about as long as the products at peak, and
// its ~5-6 other instructions a score issue beside them.
//
// Design (the kernel is in attention_bf16_rows.cuh, which the bf16 fused
// self-attention shares): TMA + wgmma, 64 query rows a block of one
// warpgroup, three blocks an SM, each refilling its own ring of K and V
// tiles of 128 keys (host plan: ops/kernels/attention.py::bf16_plan). A
// Hopper block cannot hold a [64, 3600] fp32 score row (900 KB) in its
// 227 KB of shared memory, so the block walks the keys with an online
// softmax: running row max and denominator in fp32, the output rescaled by
// exp(m_old - m_new) as the max grows. S = Q K^T is a wgmma with both
// operands in shared memory; the score accumulator's register layout is the
// A-operand layout of the P V wgmma, so P goes from scores to the second
// product in registers, and V is read as it lies (MN-major, the wgmma
// transpose bit). The P V of one tile runs on the tensor cores while the
// next tile's S is issued, and the blocks of an SM take turns at the
// softmax. q, k and v are read through their strides by 4-D TMA maps ([B,
// N, H, D] with nested batch, token and head strides), so no transpose or
// padding copy is made; TMA's zero fill covers the ragged query and key
// edges, and the keys past M are masked in the last tile.
//
// Numerics against the TPU kernel: P = exp(s - m) is cast to bf16 for the PV
// product while the denominator sums the fp32 P, as there; m is the running
// max instead of the row max, which changes only rounding (the bf16 rounding
// of P happens against a different reference, and earlier tiles are
// rescaled in fp32). Outputs agree to bf16 rounding (tests state 2e-2).

#include "attention_bf16_rows.cuh"

// q [B, N, H, D], k and v [B, M, H, D] (bf16, unit stride along D, other
// strides in elements, multiples of 8 and nested as launch_mha_bf16 says,
// 16-byte aligned); o [B, N, H, D] contiguous. D is a multiple of 16 up to
// 128. Returns the first CUDA error.
extern "C" int d3r_mha_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                      int B, int N, int M, int H, int D, long long sqb,
                                      long long sqn, long long sqh, long long skb, long long skm,
                                      long long skh, long long svb, long long svm, long long svh,
                                      float scale, void* stream) {
  using d3r::bf16;
  const long long sq[3] = {sqb, sqn, sqh}, sk[3] = {skb, skm, skh}, sv[3] = {svb, svm, svh};
  return (int)d3r::launch_mha_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                   static_cast<const bf16*>(v), static_cast<bf16*>(o), B, N, M,
                                   H, D, sq, sk, sv, scale, static_cast<cudaStream_t>(stream));
}
