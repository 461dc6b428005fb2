// The int8 whole-row attention kernel for head widths up to 128, shared by
// the standalone int8 attention (attention_int8.cu) and the fused
// self-attention (attention_fused_int8.cu):
//   s = (qq . kq) * ((scale * sq) * sk)          int32 sums, fp32 scores
//   p = exp(s - rowmax(s))                      fp32, over the whole key row
//   out = ((round(127 p) . vq) * (sv / 127)) / sum(p)      bf16
// where s_x = max(absmax_x, 1e-6) / 127 comes from a table of absmax bit
// patterns: k and v per (batch, head), q per (batch, block of q_rows query
// rows, head) (q_rows = N gives one q scale per (batch, head)).
//
// Replaces the attention of d3roma_tpu/ops/pallas/attention.py::
// mha_attention (_kernel_int8) and of attention_fused.py::
// fused_self_attention (_kernel_int8). Those TPU kernels hold a whole
// [block_q, M] score row in VMEM, so they quantize P against the true row
// max. A Hopper block cannot hold it, and an online softmax only knows a
// running max, so the keys are walked twice:
//   pass 1: S = Q K^T (int32), keeping each row's largest integer score; the
//           row max of the fp32 scores is that integer times
//           scale * sq * sk (the conversion and the product are monotonic);
//   pass 2: S again; p = exp(s - max) into the fp32 denominator, unrounded;
//           round(127 p) into an int8 P tile; O += P V (int32).
// Keys past M are masked in both passes (TMA's zero fill is not a mask: a
// zero score can be a row's max).
//
// What bounds it on the H100: not the int8 operations (4 N M D per (batch,
// head), 6 N M D with the second Q K^T) but the softmax: one exponential per
// score on the SFUs (16 a clock per SM), and about 15 issued instructions
// per score around it (expf alone is 8). So every per-score operation is at
// full rate: the int32 score becomes fp32 by the 1.5 * 2^23 trick (|S| <=
// 127^2 D < 2^22) and round(127 p) by adding 1.5 * 2^23 (its low byte is the
// integer; rounding to nearest even, as rintf), not by the quarter-rate
// conversion instructions; pass 1 takes a three-way integer max, and the
// key mask is applied only in a row's last tile. Keeping the next tile's
// scores in flight while this tile's P is computed would need a second
// score tile in registers: ptxas gives a thread of a 384-thread block at
// most 168 registers whatever setmaxnreg raises, and that version spilled.
//
// Design: TMA + wgmma (sm90_gemm.cuh's pieces). A block owns 128 query rows
// of one (batch, head): two consumer warpgroups of 64 rows and one producer
// warpgroup. The producer loads the block's Q tile once, then a 4-stage ring
// of key tiles: 128 keys of K [keys, D] in pass 1, and K with the 128 keys'
// V^T [D, keys] (vt, keys contiguous) in pass 2, all K-major boxes of 128
// bytes with the 128-byte swizzle, as int8 wgmma takes both operands (a
// head of D < 128 bytes reads TMA's zero fill past D, which no k step
// reaches). Each consumer runs S = Q K^T as wgmma m64n128k32 (D / 32 k
// steps), keeps its rows' integer max across the quad of lanes that holds a
// row, and in pass 2 writes round(127 p) as int8 into its own 64 x 128 P
// tile in the swizzled layout, then O += P V^T as wgmma m64nDk32 with P as
// the A operand from shared memory. That product runs while the next
// tile's S is issued; the stage goes back to the producer once both are
// done. A block's rows share one q scale, so q_rows must be a multiple of
// 128 or at least N (the fused caller's 256-row blocks; launch_rows refuses
// other values). The int32 sums cannot overflow: at most 127^2 D for Q K^T
// and 127^2 M for P V.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace d3r {

// vt's key padding: Mp is a multiple of it (attention_int8.cu).
constexpr int kAttnKeyTile = 64;

struct AttnArgs {
  const int8_t* q;             // [B, N, H, D]
  const int8_t* k;             // [B, M, H, D]
  const int8_t* vt;            // [B, H, D, Mp]
  const unsigned int* amax_q;  // [B, ceil(N / q_rows), H]: absmax bits
  const unsigned int* amax_k;  // [B, H]
  const unsigned int* amax_v;  // [B, H]
  __nv_bfloat16* o;            // [B, N, H, D]
  int B, N, M, Mp, H, q_rows;
  float scale;
};

__device__ __forceinline__ float head_scale(const unsigned int* amax, int i) {
  return __fdiv_rn(fmaxf(__uint_as_float(amax[i]), 1e-6f), 127.f);
}

// The index of query row n's scale in amax_q.
__device__ __forceinline__ int q_scale_index(const AttnArgs& a, int b, int h, int n) {
  const int blocks = (a.N + a.q_rows - 1) / a.q_rows;
  return (b * blocks + n / a.q_rows) * a.H + h;
}

namespace rows {

constexpr int kBlockRows = 128;  // query rows of a block: two consumer warpgroups
constexpr int kKeys = 128;       // keys of a tile
constexpr int kRowBytes = 128;   // a shared row of Q, K, V^T or P
constexpr int kThreads = 384;
constexpr int kStages = sm90::kStages;
constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;

template <int D>
struct Smem {
  static constexpr int kQBytes = kBlockRows * kRowBytes;
  static constexpr int kKBytes = kKeys * kRowBytes;
  static constexpr int kVBytes = D * kRowBytes;  // D rows of 128 keys
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kPBytes = 64 * kRowBytes;  // one per consumer
  static constexpr size_t kQ = 0;
  static constexpr size_t kRing = kQ + kQBytes;
  static constexpr size_t kP = kRing + (size_t)kStages * kStageBytes;
  static constexpr size_t kBars = kP + 2 * (size_t)kPBytes;
  static constexpr size_t kBytes = 1024 + kBars + (2 * kStages + 1) * 8;
  static_assert(D % 32 == 0 && D <= 128, "head width");
  static_assert(kVBytes % 1024 == 0, "tiles start on 1024-byte boundaries");
};

// float(s) for |s| < 2^22, at full rate.
__device__ __forceinline__ float int_to_float(int s) {
  return __fsub_rn(__int_as_float(s + kMagicBits), kMagic);
}

// The offset of byte `col` of row `row` in a 128-byte-swizzled K-major tile.
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * kRowBytes + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

// The rows' P for one tile of 2 kHalf keys (the sums of wgmma m64n(2 kHalf)):
// p = exp(s - m) into the denominators l, and round(127 p) (p in [0, 1]) as
// int8 into a P tile, at columns col0 on; with kMask, the keys from `valid`
// on give p = 0. round(127 p) + 1.5 * 2^23 holds the integer in its low
// byte; one byte permute packs a pair of keys.
template <bool kMask, int kHalf>
__device__ __forceinline__ void softmax_tile(const int (&s)[kHalf], float c, const float (&m)[2],
                                             float (&l)[2], uint8_t* pw, int valid,
                                             int col0 = 0) {
#pragma unroll
  for (int j = 0; j < kHalf / 4; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t q[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = expf(__fsub_rn(__fmul_rn(int_to_float(s[4 * j + 2 * r + e]), c), m[r]));
        if (kMask && sm90::frag_col(j, e) >= valid) p = 0.f;
        l[r] = __fadd_rn(l[r], p);
        q[e] = __float_as_uint(__fadd_rn(__fmul_rn(p, 127.f), kMagic));
      }
      const int at = swizzled(sm90::frag_row(2 * r), col0 + sm90::frag_col(j, 0));
      *reinterpret_cast<uint16_t*>(pw + at) = (uint16_t)__byte_perm(q[0], q[1], 0x0040);
    }
  }
}

// The rows' integer max over one tile's 2 kHalf scores; with kMask, of the
// keys before `valid` only. Three-way max: one instruction per two scores.
template <bool kMask, int kHalf>
__device__ __forceinline__ void row_max(const int (&s)[kHalf], int (&m)[2], int valid) {
#pragma unroll
  for (int j = 0; j < kHalf / 4; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int x0 = s[4 * j + 2 * r], x1 = s[4 * j + 2 * r + 1];
      if (kMask) {
        if (sm90::frag_col(j, 0) >= valid) x0 = INT_MIN;
        if (sm90::frag_col(j, 1) >= valid) x1 = INT_MIN;
      }
      m[r] = __vimax3_s32(m[r], x0, x1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    mha_int8_rows_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, const AttnArgs a) {
  using S = Smem<D>;
  extern __shared__ __align__(16) uint8_t rows_smem[];
  uint8_t* base = rows_smem + ((1024 - (sm90::smem_u32(rows_smem) & 1023)) & 1023);
  uint8_t* ring = base + S::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  const int q0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.H + h;
  const int n_tiles = (a.M + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    sm90::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      sm90::mbar_expect_tx(q_full, S::kQBytes);
      sm90::tma_load_3d(base + S::kQ, &q_map, q_full, 0, h, b * a.N + q0);
      sm90::Ring r;
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const bool pass2 = it >= n_tiles;
        const int key0 = (pass2 ? it - n_tiles : it) * kKeys;
        uint8_t* stage = ring + r.stage * S::kStageBytes;
        sm90::mbar_wait(&empty[r.stage], r.phase ^ 1);
        sm90::mbar_expect_tx(&full[r.stage], pass2 ? S::kStageBytes : S::kKBytes);
        sm90::tma_load_3d(stage, &k_map, &full[r.stage], 0, h, b * a.M + key0);
        if (pass2) sm90::tma_load(stage + S::kKBytes, &v_map, &full[r.stage], key0, bh * D);
        r.next();
      }
    }
    return;
  }

  sm90::regs_alloc<232>();
  const int lt = threadIdx.x % 128;
  uint8_t* pw = base + S::kP + wg * S::kPBytes;
  const float c = __fmul_rn(__fmul_rn(a.scale, head_scale(a.amax_q, q_scale_index(a, b, h, q0))),
                            head_scale(a.amax_k, bh));
  const uint64_t dq = sm90::smem_desc(base + S::kQ + wg * 64 * kRowBytes);
  sm90::mbar_wait(q_full, 0);
  sm90::Ring r;
  int s[kKeys / 2];

  // S = Q K^T of the next stage (its K box at the stage's start)
  auto scores = [&](const uint8_t* stage) {
    const uint64_t dk = sm90::smem_desc(stage);
    sm90::fence_sums(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 32; ++k) sm90::wgmma<int, kKeys>(s, dq + 2 * k, dk + 2 * k, k);
    sm90::wgmma_commit();
  };

  // pass 1: the rows' integer max (rows frag_row(0) and frag_row(2))
  int run_max[2] = {INT_MIN, INT_MIN};
  for (int t = 0; t < n_tiles; ++t) {
    sm90::mbar_wait(&full[r.stage], r.phase);
    scores(ring + r.stage * S::kStageBytes);
    sm90::wgmma_wait<0>();
    sm90::fence_sums(s);
    if (lt == 0) sm90::mbar_arrive(&empty[r.stage]);
    r.next();
    const int valid = a.M - t * kKeys;
    if (valid >= kKeys) {
      row_max<false>(s, run_max, valid);
    } else {
      row_max<true>(s, run_max, valid);
    }
  }
  float m_row[2], l_row[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // a row's keys live in one quad of lanes
    run_max[i] = max(run_max[i], __shfl_xor_sync(0xffffffffu, run_max[i], 1));
    run_max[i] = max(run_max[i], __shfl_xor_sync(0xffffffffu, run_max[i], 2));
    m_row[i] = __fmul_rn((float)run_max[i], c);
  }

  // pass 2: P and O += P V^T
  int o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0;
  int prev = -1;  // the stage whose V^T the product in flight reads
  for (int t = 0; t < n_tiles; ++t) {
    sm90::mbar_wait(&full[r.stage], r.phase);
    const uint8_t* stage = ring + r.stage * S::kStageBytes;
    scores(stage);
    sm90::wgmma_wait<0>();  // this tile's S, and the last tile's P V^T
    sm90::fence_sums(s);
    sm90::fence_sums(o);
    if (prev >= 0 && lt == 0) sm90::mbar_arrive(&empty[prev]);
    const int valid = a.M - t * kKeys;
    if (valid >= kKeys) {
      softmax_tile<false>(s, c, m_row, l_row, pw, valid);
    } else {
      softmax_tile<true>(s, c, m_row, l_row, pw, valid);
    }
    sm90::fence_proxy_async();
    sm90::warpgroup_sync(wg);  // the warpgroup's P tile is written
    const uint64_t dp = sm90::smem_desc(pw), dv = sm90::smem_desc(stage + S::kKBytes);
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kKeys / 32; ++k) {
      sm90::wgmma<int, D>(o, dp + 2 * k, dv + 2 * k, 1);
    }
    sm90::wgmma_commit();
    prev = r.stage;
    r.next();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_sums(o);
  if (lt == 0) sm90::mbar_arrive(&empty[prev]);

  const float sv127 = __fdiv_rn(head_scale(a.amax_v, bh), 127.f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_row[i] = __fadd_rn(l_row[i], __shfl_xor_sync(0xffffffffu, l_row[i], 1));
    l_row[i] = __fadd_rn(l_row[i], __shfl_xor_sync(0xffffffffu, l_row[i], 2));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = q0 + wg * 64 + sm90::frag_row(2 * i);
    if (n >= a.N) continue;
    __nv_bfloat16* orow = a.o + (((long long)b * a.N + n) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float v0 = __fdiv_rn(__fmul_rn((float)o[4 * j + 2 * i], sv127), l_row[i]);
      const float v1 = __fdiv_rn(__fmul_rn((float)o[4 * j + 2 * i + 1], sv127), l_row[i]);
      *reinterpret_cast<__nv_bfloat162*>(orow + sm90::frag_col(j, 0)) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

}  // namespace rows

// Launch the rows kernel on grid (ceil(N / 128), H, B): the TMA maps of q
// and k ([B, L, H, D] as (D, H, B L), boxes of 128 bytes x 1 head x 128
// rows; the rows past a batch item's L read the next item's, which the
// kernel masks or does not write, and zeros past the last) and of vt
// ([B H D, Mp], boxes of 128 keys x D rows). q_rows must be a multiple
// of 128 or at least N, so that a block's rows share one q scale; Mp a
// multiple of 16 (TMA's row pitch), at least M.
template <int D>
cudaError_t launch_rows(const AttnArgs& a, cudaStream_t stream) {
  using S = rows::Smem<D>;
  if (a.B <= 0 || a.N <= 0 || a.M <= 0 || a.H <= 0 || a.Mp < a.M || a.Mp % 16 != 0 ||
      a.q_rows <= 0 || (a.q_rows < a.N && a.q_rows % rows::kBlockRows != 0)) {
    return cudaErrorInvalidValue;
  }
  const uint32_t box[3] = {rows::kRowBytes, 1, rows::kBlockRows};
  const uint32_t steps[3] = {1, 1, 1};
  const uint64_t strides[2] = {D, (uint64_t)a.H * D};
  const uint64_t q_dims[3] = {D, (uint64_t)a.H, (uint64_t)a.B * a.N};
  const uint64_t k_dims[3] = {D, (uint64_t)a.H, (uint64_t)a.B * a.M};
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = sm90::tensor_map_nd(&q_map, a.q, 1, 3, q_dims, strides, box, steps);
  if (err == cudaSuccess) err = sm90::tensor_map_nd(&k_map, a.k, 1, 3, k_dims, strides, box, steps);
  if (err == cudaSuccess) {
    err = sm90::tensor_map(&v_map, a.vt, 1, (uint64_t)a.B * a.H * D, a.Mp, a.Mp, D);
  }
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(rows::mha_int8_rows_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + rows::kBlockRows - 1) / rows::kBlockRows, a.H, a.B);
  rows::mha_int8_rows_kernel<D><<<grid, rows::kThreads, S::kBytes, stream>>>(q_map, k_map,
                                                                             v_map, a);
  return cudaGetLastError();
}

}  // namespace d3r
