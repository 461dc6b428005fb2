// Fused int8 self-attention for Hopper (sm_90a): QKV projection, whole-row
// attention and output projection of one transformer self-attention site,
// with the arithmetic of the TPU kernel's int8 body:
//   xq = quantize(x, act_scale)                        (act_quantize.cuh)
//   [q_f | k_f | v_f] = (xq . Wqkv) * (act_scale * sw)  int32 sums, fp32,
//       per-column weight scales sw
//   sk, sv = max(absmax, 1e-6) / 127 per (batch, head) over all rows;
//   sq the same per (batch, 256-row block, head); x_q = round(x_f / s_x)
//   s = (qq . kq) * ((scale * sq) * sk); p = exp(s - rowmax(s)) (fp32);
//   o_h = ((round(127 p) . vq) * (sv / 127)) / sum(p), rounded to bf16
//   out = bo + sum over heads, in head order, of o_h . Wo_h (bf16 products,
//       fp32 sums), cast to x's type
//
// Replaces: d3roma_tpu/ops/pallas/attention_fused.py::fused_self_attention,
// its int8 body (_kernel_int8). That TPU kernel sweeps (batch, 256-row
// q block, head) in order: at the first q block it projects and quantizes K
// and V of all heads into VMEM scratch, then per program projects one q
// block for one head, takes the whole [256, N] score row, and accumulates
// the head's output projection into a [256, C] fp32 accumulator that starts
// at bo.
//
// What bounds it on the H100: operations. The projections do 8 N C^2 and the
// attention 4 N^2 C int8 operations per batch item (the output projection
// 2 N C^2 in bf16) against ~2 N C bytes in and out, thousands of operations
// per byte at the UNet's sites (N 60-3600, C 320-1280).
//
// Design. Hopper blocks run in no order and share nothing, so the TPU
// kernel's sweep becomes four launches on the caller's stream, each a
// kernel of this file or of attention_int8_rows.cuh, after a memset of the
// absmax tables and the quantization of x into the wrapper's int8
// workspace (act_quantize.cuh), of which launch 1 is a dependent launch
// (pdl.cuh): its threads issue the weight rows of their first stages, then
// wait on the quantize before their first xq row:
//   1. qkv_int8_kernel: the projection as one int8 GEMM [B N, C] x [C, 3C]
//      in 128 x 128 tiles (mma.sync m16n8k32, four cp.async stages, as the
//      int8 conv kernel), the epilogue writing the fp32 q_f, k_f and v_f to a
//      workspace and the absmax tables by atomicMax on the bit pattern of
//      non-negative floats (each warp's 64 columns are one head of one of q,
//      k and v; a tile never straddles two batch items or two 256-row q
//      blocks). The grid-wide per-(batch, head) absmax is thereby ready
//      before any quantization, and the 256-row q scale grid, which is not
//      the attention block's 64 rows, is a table like the others.
//   2. quantize_qkv_kernel: q and k to int8 in their [B, N, H, 64] layout, v
//      to [B, H, 64, N_pad] (keys contiguous for the int8 mma, zero past N).
//   3. mha_int8_rows_kernel<64> (attention_int8_rows.cuh, TMA + int8
//      wgmma): the two passes over the keys that quantize P against the
//      true row max, writing o_h as bf16 [B, N, H * 64]; its 128-row blocks
//      lie inside one 256-row q scale block.
//   4. out_proj_kernel (attention_out_proj.cuh, shared with the bf16 fused
//      self-attention): the output projection [B N, C] x [C, C] in bf16
//      (mma.sync m16n8k16) in 128 x 128 tiles, one 64-wide k step per head
//      into a fresh fp32 partial that is added to the accumulator (started
//      at bo) in head order, as the TPU kernel adds its per-head products.
// A [256, C] fp32 accumulator does not fit a Hopper block's shared memory at
// C = 1280, so o_h goes through device memory (2 N C bytes a batch item).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "act_quantize.cuh"
#include "attention_int8_rows.cuh"
#include "attention_out_proj.cuh"
#include "bf16_mma.cuh"
#include "int8_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using d3r::cp_async_16;

constexpr int kHeadDim = 64;
constexpr int kQBlock = 256;  // the TPU kernel's q block: rows per q scale
constexpr int kThreads = 256;

struct FusedArgs {
  const int8_t* xq;          // [B, N, C]
  const int8_t* w;           // [3C, C]: Wq, Wk, Wv rows (output columns)
  const float* ws;           // [3C]: per-column weight scales
  float act_scale;
  float* f;                  // [B, N, 3C]
  unsigned int* amax_q;      // [B, ceil(N / 256), H]
  unsigned int* amax_k;      // [B, H]
  unsigned int* amax_v;      // [B, H]
  int8_t* qq;                // [B, N, C]
  int8_t* kq;                // [B, N, C]
  int8_t* vt;                // [B, H, 64, Mp]
  int B, N, C, H, Mp;
};

// --------------------------------------------------------------------------
// 1. The QKV projection.

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 4;
constexpr int kLd8 = kBK + 16;  // shared row pitch, bytes
constexpr size_t kStage8 = (size_t)(kBM + kBN) * kLd8;
constexpr size_t kSmem8 = kStages * kStage8;

// grid (ceil(N / 128), ceil(3C / 128), B).
__global__ void __launch_bounds__(kThreads) qkv_int8_kernel(FusedArgs a) {
  extern __shared__ __align__(128) int8_t smem8[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n3 = 3 * a.C;
  const int b = blockIdx.z, m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int lrow = tid / 2, lhalf = (tid % 2) * 16;
  const bool m_ok = m0 + lrow < a.N, n_ok = n0 + lrow < n3;
  const int8_t* arow = a.xq + ((long long)b * a.N + (m_ok ? m0 + lrow : 0)) * a.C + lhalf;
  const int8_t* brow = a.w + (long long)(n_ok ? n0 + lrow : 0) * a.C + lhalf;
  const int n_chunks = a.C / kBK;

  auto load_a = [&](int slot, int kc) {
    int8_t* st = smem8 + slot * kStage8;
    cp_async_16(st + lrow * kLd8 + lhalf, m_ok ? arow + kc * kBK : a.xq, m_ok ? 16 : 0);
  };
  auto load_b = [&](int slot, int kc) {
    int8_t* st = smem8 + slot * kStage8;
    cp_async_16(st + (kBM + lrow) * kLd8 + lhalf, n_ok ? brow + kc * kBK : a.w, n_ok ? 16 : 0);
  };

  const int wm = (warp % 4) * 32, wn = (warp / 4) * 64;
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  // The weight rows of the first stages do not depend on the quantize
  // before this kernel (a dependent launch): they go out before the wait,
  // uncommitted, so they join the first stage's group.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_b(s, s);
  }
  d3r::pdl::wait();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_a(s, s);
    d3r::cp_async_commit();
  }
  for (int kc = 0; kc < n_chunks; ++kc) {
    d3r::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kc + kStages - 1;
    if (next < n_chunks) {
      load_a(next % kStages, next);
      load_b(next % kStages, next);
    }
    d3r::cp_async_commit();
    const int8_t* as = smem8 + (kc % kStages) * kStage8;
    const int8_t* bs = as + kBM * kLd8;
    uint32_t af[2][4];
    d3r::load_a(af[0], as, kLd8, wm, 0, lane);
    d3r::load_a(af[1], as, kLd8, wm + 16, 0, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b0, b1;
      d3r::load_b(b0, b1, bs, kLd8, wn + j * 8, 0, lane);
      d3r::mma_s8(acc[0][j], af[0], b0, b1);
      d3r::mma_s8(acc[1][j], af[1], b0, b1);
    }
  }
  d3r::cp_async_wait<0>();

  const int col0 = n0 + wn;  // this warp's 64 columns: one head of q, k or v
  if (col0 >= n3) return;
  const int g = lane / 4, t = lane % 4;
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    const float s0 = __fmul_rn(a.act_scale, a.ws[col]);
    const float s1 = __fmul_rn(a.act_scale, a.ws[col + 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm + i * 16 + g + 8 * hh;
        if (row >= a.N) continue;
        const float v0 = __fmul_rn((float)acc[i][j][2 * hh], s0);
        const float v1 = __fmul_rn((float)acc[i][j][2 * hh + 1], s1);
        *reinterpret_cast<float2*>(a.f + ((long long)b * a.N + row) * n3 + col) =
            make_float2(v0, v1);
        m = fmaxf(m, fmaxf(fabsf(v0), fabsf(v1)));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) {
    const int which = col0 / a.C, h = (col0 % a.C) / kHeadDim;
    const int qblocks = (a.N + kQBlock - 1) / kQBlock;
    unsigned int* slot =
        which == 0 ? a.amax_q + ((long long)b * qblocks + m0 / kQBlock) * a.H + h
                   : (which == 1 ? a.amax_k : a.amax_v) + b * a.H + h;
    atomicMax(slot, __float_as_uint(m));
  }
}

// --------------------------------------------------------------------------
// 2. Quantization of the projections. grid (blocks, 1, 2): z = 0 writes qq
// and kq, z = 1 writes vt.
__global__ void quantize_qkv_kernel(FusedArgs a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int n3 = 3 * a.C;
  const int qblocks = (a.N + kQBlock - 1) / kQBlock;
  if (blockIdx.z == 0) {
    const long long n = (long long)a.B * a.N * a.C;
    for (long long i = start; i < n; i += stride) {
      const int c = (int)(i % a.C);
      const long long bn = i / a.C;
      const int row = (int)(bn % a.N), b = (int)(bn / a.N), h = c / kHeadDim;
      const float* fr = a.f + bn * n3;
      const float sq = d3r::head_scale(a.amax_q, (b * qblocks + row / kQBlock) * a.H + h);
      const float sk = d3r::head_scale(a.amax_k, b * a.H + h);
      a.qq[i] = (int8_t)rintf(__fdiv_rn(fr[c], sq));
      a.kq[i] = (int8_t)rintf(__fdiv_rn(fr[a.C + c], sk));
    }
  } else {
    const long long n = (long long)a.B * a.H * kHeadDim * a.Mp;
    for (long long i = start; i < n; i += stride) {
      const int l = (int)(i % a.Mp);
      const int d = (int)((i / a.Mp) % kHeadDim);
      const int bh = (int)(i / ((long long)a.Mp * kHeadDim));
      int8_t q = 0;
      if (l < a.N) {
        const int b = bh / a.H, h = bh % a.H;
        const float v = a.f[((long long)b * a.N + l) * n3 + 2 * a.C + h * kHeadDim + d];
        q = (int8_t)rintf(__fdiv_rn(v, d3r::head_scale(a.amax_v, bh)));
      }
      a.vt[i] = q;
    }
  }
}

}  // namespace

// x [B, N, C] bf16, quantized at act_scale into xq (int8 workspace of
// B N C bytes), w [3C, C] int8 (the rows of Wq, Wk, Wv: one per output
// column), ws [3C] fp32 (their scales), wo [C, C] bf16 (output column, then
// input), bo [C] fp32; out [B, N, C] bf16. Scratch: f [B, N, 3C] fp32, amax
// [B * ceil(N / 256) * H + 2 * B * H] uint32, qq and kq [B, N, C] int8, vt
// [B, H, 64, Mp] int8 (Mp a multiple of 64, at least N), o [B, N, C] bf16.
// All contiguous, all but x 16-byte aligned; C = 64 H. Returns the first
// CUDA error of the memset, the quantize and the four launches.
extern "C" int d3r_fused_self_attention_int8(
    const void* x, void* xq, const void* w, const void* ws, const void* wo, const void* bo,
    void* f, void* amax, void* qq, void* kq, void* vt, void* o, void* out, int B, int N, int C,
    int H, int Mp, float act_scale, float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || C != kHeadDim * H || Mp % d3r::kAttnKeyTile != 0 || Mp < N ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int qblocks = (N + kQBlock - 1) / kQBlock;
  const size_t n_amax = (size_t)B * qblocks * H + 2 * (size_t)B * H;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned int) * n_amax, st);
  if (err == cudaSuccess) {
    err = d3r::actq::quantize(x, xq, (long long)B * N * C, true, act_scale, st);
  }
  if (err != cudaSuccess) return (int)err;
  unsigned int* am = static_cast<unsigned int*>(amax);
  FusedArgs fa{static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w),
               static_cast<const float*>(ws), act_scale, static_cast<float*>(f), am,
               am + (size_t)B * qblocks * H, am + (size_t)B * qblocks * H + (size_t)B * H,
               static_cast<int8_t*>(qq), static_cast<int8_t*>(kq), static_cast<int8_t*>(vt),
               B, N, C, H, Mp};

  if ((err = cudaFuncSetAttribute(qkv_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kSmem8)) != cudaSuccess)
    return (int)err;
  const dim3 qkv_grid((N + kBM - 1) / kBM, (3 * C + kBN - 1) / kBN, B);
  if ((err = d3r::pdl::launch(qkv_int8_kernel, qkv_grid, dim3(kThreads), kSmem8, st, true, fa)) !=
      cudaSuccess)
    return (int)err;

  quantize_qkv_kernel<<<dim3(132 * 4, 1, 2), kThreads, 0, st>>>(fa);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  d3r::AttnArgs at{fa.qq, fa.kq, fa.vt, fa.amax_q, fa.amax_k, fa.amax_v,
                   static_cast<bf16*>(o), B, N, N, Mp, H, kQBlock, scale};
  if ((err = d3r::launch_rows<kHeadDim>(at, st)) != cudaSuccess) return (int)err;

  d3r::OutProjArgs oa{static_cast<const bf16*>(o), static_cast<const bf16*>(wo),
                      static_cast<const float*>(bo), static_cast<bf16*>(out), B * N, C, H};
  return (int)d3r::launch_out_proj(oa, st);
}
