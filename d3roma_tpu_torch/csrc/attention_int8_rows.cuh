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
// The keys are walked twice, in tiles of 64 (see attention_int8.cu for why):
//   pass 1: S = Q K^T (int32), keeping each row's largest integer score; the
//           row max of the fp32 scores is that integer times
//           scale * sq * sk (the conversion and the product are monotonic);
//   pass 2: S again; p = exp(s - max) into the fp32 denominator, unrounded;
//           round(127 p) into an int8 P tile; O += P V (int32).
// A block takes 64 query rows with 4 warps, and each warp owns 16 rows
// outright: their scores, row maxima and denominators stay in its registers
// (a row's 64 keys live in one quad of lanes), its P rows go through its own
// slice of shared memory (the accumulator layout of one m16n8k32 is not the
// A layout of the next), and its [16, D] int32 output stays in registers. K
// and V tiles are double-buffered by cp.async, so the block meets one
// barrier per key tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace d3r {

constexpr int kAttnKeyTile = 64;  // keys per tile

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

template <int D>
struct RowsCfg {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;
  static constexpr int kLdq = D + 16;              // Q and K rows, bytes
  static constexpr int kLdv = kAttnKeyTile + 16;   // V^T rows (one per d), bytes
  static constexpr int kLdp = kAttnKeyTile + 16;   // P rows, bytes
  static constexpr size_t q = 0;
  static constexpr size_t k = q + (size_t)kBQ * kLdq;              // 2 buffers
  static constexpr size_t v = k + 2 * (size_t)kAttnKeyTile * kLdq;  // 2 buffers
  static constexpr size_t p = v + 2 * (size_t)D * kLdv;             // one slice per warp
  static constexpr size_t bytes = p + (size_t)kWarps * 16 * kLdp;
  static_assert(D % 32 == 0 && D <= 128, "head width");
};

// grid (ceil(N / 64), H, B). q_rows must be a multiple of 64 or at least N,
// so that the block's rows share one q scale.
template <int D>
__global__ void __launch_bounds__(RowsCfg<D>::kThreads) mha_int8_rows_kernel(AttnArgs a) {
  using C = RowsCfg<D>;
  constexpr int kBK = kAttnKeyTile;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* qs = reinterpret_cast<int8_t*>(smem + C::q);
  int8_t* ks = reinterpret_cast<int8_t*>(smem + C::k);
  int8_t* vs = reinterpret_cast<int8_t*>(smem + C::v);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  int8_t* pw = reinterpret_cast<int8_t*>(smem + C::p) + warp * 16 * C::kLdp;

  const int q0 = blockIdx.x * C::kBQ, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.H + h;
  const float c = __fmul_rn(__fmul_rn(a.scale, head_scale(a.amax_q, q_scale_index(a, b, h, q0))),
                            head_scale(a.amax_k, bh));
  const long long row_stride = (long long)a.H * D;
  const int8_t* qb = a.q + ((long long)b * a.N * a.H + h) * D;
  const int8_t* kb = a.k + ((long long)b * a.M * a.H + h) * D;
  const int8_t* vb = a.vt + (long long)bh * D * a.Mp;
  constexpr int kVecD = D / 16, kVecK = kBK / 16;

  auto load_tile = [&](int t, int buf, bool with_v) {
    for (int i = tid; i < kBK * kVecD; i += C::kThreads) {
      const int r = i / kVecD, cc = (i % kVecD) * 16;
      const int key = t * kBK + r;
      const bool ok = key < a.M;
      cp_async_16(ks + (buf * kBK + r) * C::kLdq + cc, ok ? kb + key * row_stride + cc : a.k,
                  ok ? 16 : 0);
    }
    if (with_v) {
      for (int i = tid; i < D * kVecK; i += C::kThreads) {
        const int d = i / kVecK, cc = (i % kVecK) * 16;
        cp_async_16(vs + (buf * D + d) * C::kLdv + cc, vb + (long long)d * a.Mp + t * kBK + cc,
                    16);
      }
    }
  };

  for (int i = tid; i < C::kBQ * kVecD; i += C::kThreads) {
    const int r = i / kVecD, cc = (i % kVecD) * 16;
    const bool ok = q0 + r < a.N;
    cp_async_16(qs + r * C::kLdq + cc, ok ? qb + (q0 + r) * row_stride + cc : a.q, ok ? 16 : 0);
  }
  load_tile(0, 0, false);
  cp_async_commit();

  const int n_tiles = (a.M + kBK - 1) / kBK;
  int run_max[2] = {INT_MIN, INT_MIN};  // rows g and g + 8 of this warp
  float m_row[2] = {0.f, 0.f}, l_row[2] = {0.f, 0.f};
  int acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  uint32_t qf[D / 32][4];

  for (int it = 0; it < 2 * n_tiles; ++it) {
    const bool pass2 = it >= n_tiles;
    const int t = pass2 ? it - n_tiles : it;
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile `it` has landed; every warp is done with tile it - 1
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) load_a(qf[kk], qs, C::kLdq, warp * 16, kk * 32, lane);
    }
    if (it + 1 < 2 * n_tiles) {
      const int next = it + 1 >= n_tiles ? it + 1 - n_tiles : it + 1;
      load_tile(next, buf ^ 1, it + 1 >= n_tiles);
    }
    cp_async_commit();

    const int8_t* kt = ks + buf * kBK * C::kLdq;
    int s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t b0, b1;
        load_b(b0, b1, kt, C::kLdq, j * 8, kk * 32, lane);
        mma_s8(s[j], qf[kk], b0, b1);
      }
    }
    const int key0 = t * kBK + 2 * t4;  // key of s[j][0] is key0 + 8 j; s[j][1] the next
    if (!pass2) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (key0 + 8 * j + (e & 1) < a.M) run_max[e >> 1] = max(run_max[e >> 1], s[j][e]);
        }
      }
      if (it == n_tiles - 1) {  // a row's keys live in one quad of lanes
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          run_max[r] = max(run_max[r], __shfl_xor_sync(0xffffffffu, run_max[r], 1));
          run_max[r] = max(run_max[r], __shfl_xor_sync(0xffffffffu, run_max[r], 2));
          m_row[r] = __fmul_rn((float)run_max[r], c);
        }
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t pair = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = 0.f;
          if (key0 + 8 * j + e < a.M) {
            p = expf(__fsub_rn(__fmul_rn((float)s[j][2 * r + e], c), m_row[r]));
          }
          l_row[r] = __fadd_rn(l_row[r], p);
          // p in [0, 1]: round(127 p) in [0, 127]
          pair |= (uint32_t)rintf(__fmul_rn(p, 127.f)) << (8 * e);
        }
        *reinterpret_cast<uint16_t*>(pw + (g + 8 * r) * C::kLdp + 8 * j + 2 * t4) =
            (uint16_t)pair;
      }
    }
    __syncwarp();
    const int8_t* vtile = vs + buf * D * C::kLdv;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t af[4];
      load_a(af, pw, C::kLdp, 0, kk * 32, lane);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, vtile, C::kLdv, n * 8, kk * 32, lane);
        mma_s8(acc[n], af, b0, b1);
      }
    }
    __syncwarp();  // the next tile's P overwrites this warp's slice
  }
  cp_async_wait<0>();

  const float sv127 = __fdiv_rn(head_scale(a.amax_v, bh), 127.f);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] = __fadd_rn(l_row[r], __shfl_xor_sync(0xffffffffu, l_row[r], 1));
    l_row[r] = __fadd_rn(l_row[r], __shfl_xor_sync(0xffffffffu, l_row[r], 2));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + warp * 16 + g + 8 * r;
    if (n >= a.N) continue;
    __nv_bfloat16* orow = a.o + (((long long)b * a.N + n) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float v0 = __fdiv_rn(__fmul_rn((float)acc[j][2 * r], sv127), l_row[r]);
      const float v1 = __fdiv_rn(__fmul_rn((float)acc[j][2 * r + 1], sv127), l_row[r]);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int D>
cudaError_t launch_rows(const AttnArgs& a, cudaStream_t stream) {
  using C = RowsCfg<D>;
  cudaError_t err = cudaFuncSetAttribute(mha_int8_rows_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + C::kBQ - 1) / C::kBQ, a.H, a.B);
  mha_int8_rows_kernel<D><<<grid, C::kThreads, C::bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace d3r
