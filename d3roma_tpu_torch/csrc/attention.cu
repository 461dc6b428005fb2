// Multi-head attention for Hopper (sm_90a), bf16 in and out, fp32 softmax.
//
// Replaces: d3roma_tpu/ops/pallas/attention.py::mha_attention, its
// bf16/fp32 path (kernel body _kernel_f32). That TPU kernel holds a whole
// [block_q, M] fp32 score row in VMEM and takes one max-then-exp softmax per
// row; keys are padded to 128 and masked at -1e30.
//
// What bounds it on the H100: operations. At the UNet's flagship sites
// (N = M = 3600, H = 5, D = 64 and N = M = 920, H = 10, D = 64) the two
// products do 4*N*M*D flops per (batch, head) against 8*N*D bytes of q, k,
// v and o, i.e. ~M/2 = 1800 flops per byte, far above the ~295 flops per byte
// where the bf16 tensor cores, not memory, become the limit.
//
// Design (the kernel is in attention_bf16_rows.cuh, which the bf16 fused
// self-attention shares): one block of 4 warps per (query tile of 64 rows,
// head, batch); each warp owns 16 query rows. A Hopper block cannot hold a [64, 3600] fp32
// score row (900 KB) in its 227 KB of shared memory, so the block walks the
// keys in tiles of 64 with an online softmax: running row max and
// denominator in fp32, the output rescaled by exp(m_old - m_new) as the max
// grows. Both products run on the tensor cores as mma.sync m16n8k16 (bf16
// operands, fp32 accumulation) with every accumulator in registers: the
// warp's [16, 64] score tile, its [16, D] output, and its q fragments, which
// are loaded once. The score accumulator's register layout is the A-operand
// layout of the PV product, so P goes from scores to the second product
// without touching shared memory. K and V tiles are staged in shared memory
// by cp.async, double-buffered, so the next tile's loads overlap this tile's
// products; fragments come from shared memory through ldmatrix (V
// transposed). q, k and v are read through their strides ([B, N, H, D] with
// any batch, token and head stride), so no transpose or padding copy is
// made; the ragged query and key edges are zero-filled and masked here
// instead of padded.
//
// Numerics against the TPU kernel: P = exp(s - m) is cast to bf16 for the PV
// product while the denominator sums the fp32 P, as there; m is the running
// max instead of the row max, which changes only rounding (the bf16 rounding
// of P happens against a different reference, and earlier tiles are
// rescaled in fp32). Outputs agree to bf16 rounding (tests state 2e-2).

#include "attention_bf16_rows.cuh"

// q [B, N, H, D], k and v [B, M, H, D] (bf16, unit stride along D, other
// strides in elements and multiples of 8, 16-byte aligned); o [B, N, H, D]
// contiguous. D is a multiple of 16 up to 128. Returns cudaGetLastError().
extern "C" int d3r_mha_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                      int B, int N, int M, int H, int D, int sqb, int sqn,
                                      int sqh, int skb, int skm, int skh, int svb, int svm,
                                      int svh, float scale, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  using d3r::bf16;
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  const auto* vv = static_cast<const bf16*>(v);
  auto* oo = static_cast<bf16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
#define D3R_MHA_CASE(DIM)                                                                     \
  case DIM:                                                                                   \
    return (int)d3r::launch_mha_bf16<DIM>(qq, kk, vv, oo, B, N, M, H, sqb, sqn, sqh, skb, skm, \
                                          skh, svb, svm, svh, scale, st);
  switch (D) {
    D3R_MHA_CASE(16)
    D3R_MHA_CASE(32)
    D3R_MHA_CASE(48)
    D3R_MHA_CASE(64)
    D3R_MHA_CASE(80)
    D3R_MHA_CASE(96)
    D3R_MHA_CASE(112)
    D3R_MHA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef D3R_MHA_CASE
}
