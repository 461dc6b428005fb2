// The bf16 whole-row attention kernel, shared by the bf16 attention
// (attention.cu, which says what it replaces, what bounds it and how it is
// built) and the bf16 fused self-attention's core (attention_fused_bf16.cu):
//   o = bf16((bf16(P) . v) / sum(P)), P = exp(s - max), s = (q . k) * scale
// fp32 scores and sums, q [B, N, H, D] and k, v [B, M, H, D] read through
// their strides, o [B, N, H, D] contiguous.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "int8_mma.cuh"

namespace d3r {

using bf16 = __nv_bfloat16;

constexpr int kMhaBlockQ = 64;  // query rows per block
constexpr int kMhaBlockK = 64;  // keys per tile
constexpr int kMhaWarps = 4;    // each warp owns 16 query rows
constexpr int kMhaThreads = 32 * kMhaWarps;
constexpr int kMhaPad = 8;      // row padding in bf16: no ldmatrix bank conflicts
constexpr float kMhaLog2e = 1.4426950408889634f;

template <int D>
struct MhaLayout {
  static constexpr int kLd = D + kMhaPad;
  static constexpr size_t kTile = sizeof(bf16) * kMhaBlockK * kLd;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * kMhaBlockQ * kLd;  // 2 buffers
  static constexpr size_t v = k + 2 * kTile;                           // 2 buffers
  static constexpr size_t bytes = v + 2 * kTile;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [row0, row0 + kRows) of one (batch, head) slice in shared
// memory with cp.async, 16 bytes per copy. Rows at or past n_rows are zero.
template <int D, int kRows>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int row0, int n_rows,
                                           long long row_stride) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < kRows * kVec; i += kMhaThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async_16(dst + r * (D + kMhaPad) + c, src + (ok ? row0 + r : 0) * row_stride + c,
                ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kMhaThreads)
mha_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o, int N, int M, int H,
           int sqb, int sqn, int sqh, int skb, int skm, int skh, int svb, int svm,
           int svh, float scale) {
  using L = MhaLayout<D>;
  constexpr int kLd = L::kLd;
  extern __shared__ __align__(128) unsigned char smem_mha[];
  bf16* qs = reinterpret_cast<bf16*>(smem_mha + L::q);
  bf16* ks = reinterpret_cast<bf16*>(smem_mha + L::k);
  bf16* vs = reinterpret_cast<bf16*>(smem_mha + L::v);

  const int q0 = blockIdx.x * kMhaBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (and row + 8)
  const int tg = lane % 4;  // fragment column pair
  const int r0 = warp * 16;
  const bf16* kb = k + (long long)b * skb + (long long)h * skh;
  const bf16* vb = v + (long long)b * svb + (long long)h * svh;
  const int n_tiles = (M + kMhaBlockK - 1) / kMhaBlockK;

  stage_rows<D, kMhaBlockQ>(qs, q + (long long)b * sqb + (long long)h * sqh, q0, N, sqn);
  stage_rows<D, kMhaBlockK>(ks, kb, 0, M, skm);
  stage_rows<D, kMhaBlockK>(vs, vb, 0, M, svm);
  cp_async_commit();

  // ldmatrix row addresses: lane l feeds row (l % 8) of 8x8 matrix l / 8
  const int lrow = lane % 8;
  const int lmat = lane / 8;

  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[D / 16][4];
  const float scale_log2 = scale * kMhaLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other buffer
      const int next = (t + 1) * kMhaBlockK;
      stage_rows<D, kMhaBlockK>(ks + (buf ^ 1) * kMhaBlockK * kLd, kb, next, M, skm);
      stage_rows<D, kMhaBlockK>(vs + (buf ^ 1) * kMhaBlockK * kLd, vb, next, M, svm);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldmatrix_x4(qf[kk], qs + (r0 + lrow + (lmat & 1) * 8) * kLd + kk * 16 + (lmat >> 1) * 8);
      }
    }
    const bf16* kt = ks + buf * kMhaBlockK * kLd;
    const bf16* vt = vs + buf * kMhaBlockK * kLd;

    // S = Q K^T: 8 n-tiles of 8 keys; two per ldmatrix.x4.
    float s[kMhaBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kMhaBlockK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kMhaBlockK / 8; j += 2) {
        uint32_t bfrag[4];
        ldmatrix_x4(bfrag, kt + (j * 8 + (lmat >> 1) * 8 + lrow) * kLd + kk * 16 + (lmat & 1) * 8);
        mma_bf16(s[j], qf[kk], bfrag[0], bfrag[1]);
        mma_bf16(s[j + 1], qf[kk], bfrag[2], bfrag[3]);
      }
    }

    // Online softmax in the log2 domain; a thread holds, per n-tile, keys
    // 2tg and 2tg + 1 of rows g (s[j][0..1]) and g + 8 (s[j][2..3]).
    const int key0 = t * kMhaBlockK + 2 * tg;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kMhaBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key0 + j * 8 + (e & 1) < M;
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: tile 0 has a valid key
      alpha[r] = exp2f(m_run[r] - m_new);            // 0 on the first tile
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kMhaBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_run[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: P's A fragments are the score accumulators cast to bf16.
#pragma unroll
    for (int kk = 0; kk < kMhaBlockK / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t bfrag[4];
        ldmatrix_x4_trans(bfrag,
                          vt + (kk * 16 + (lmat & 1) * 8 + lrow) * kLd + j * 8 + (lmat >> 1) * 8);
        mma_bf16(acc[j], pf, bfrag[0], bfrag[1]);
        mma_bf16(acc[j + 1], pf, bfrag[2], bfrag[3]);
      }
    }
    __syncthreads();  // the next prefetch overwrites this tile's buffer
  }

  // o[b, n, h, :] = O / l, cast once.
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + r0 + g + 8 * r;
    if (n >= N) continue;
    bf16* orow = o + (((long long)b * N + n) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * tg) =
          pack_bf16(acc[j][2 * r] * inv[r], acc[j][2 * r + 1] * inv[r]);
    }
  }
}

template <int D>
cudaError_t launch_mha_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int N,
                            int M, int H, int sqb, int sqn, int sqh, int skb, int skm, int skh,
                            int svb, int svm, int svh, float scale, cudaStream_t stream) {
  using L = MhaLayout<D>;
  cudaError_t err = cudaFuncSetAttribute(
      mha_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kMhaBlockQ - 1) / kMhaBlockQ, H, B);
  mha_kernel<D><<<grid, kMhaThreads, L::bytes, stream>>>(
      q, k, v, o, N, M, H, sqb, sqn, sqh, skb, skm, skh, svb, svm, svh, scale);
  return cudaGetLastError();
}

}  // namespace d3r
