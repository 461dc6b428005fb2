// The bf16 whole-row attention kernel, shared by the bf16 attention
// (attention.cu, which says what it replaces, what bounds it and how it is
// built) and the bf16 fused self-attention's core (attention_fused_bf16.cu):
//   o = bf16((bf16(P) . v) / sum(P)), P = exp(s - max), s = (q . k) * scale
// fp32 scores and sums, q [B, N, H, D] and k, v [B, M, H, D] read by TMA
// through their strides, o [B, N, H, D] contiguous.
//
// A block is one warpgroup that owns 64 query rows of one (batch, head),
// three blocks an SM at head widths up to 64: while one block's warpgroup
// runs its softmax, the others' products keep the tensor cores busy (one
// block of 128 rows, two warpgroups and a producer warp, ran slower).
// Thread 0 loads the block's Q once and the first kStages stages of a
// ring, each the K and the V tile of 128 keys: boxes of 64 head columns
// (128 bytes, the 128-byte swizzle) x 128 keys of the 4-D maps (D, H, L,
// B), so the strides are TMA's and the ragged N and M and a head narrower
// than the box read its zero fill; a stage is loaded again with the tile
// kStages on as soon as its P V is done. The warpgroup:
//   S = Q K^T       wgmma m64n128k16, Q and K from shared memory, K-major;
//   online softmax  in registers: running max and fp32 denominator, keys
//                   past M masked in the last tile only, O rescaled;
//   O += P V        wgmma m64nDPk16 with P from registers (the S
//                   accumulators cast to bf16 are the A fragments) and V
//                   read MN-major through the transpose bit: no V^T copy
//                   and no shared P tile.
// P V runs while the next tile's S is issued. DP, the width of the
// products, is the head width rounded up to 64 (the box): the columns past
// D are the boxes' zero fill and are not written.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace d3r {

using bf16 = __nv_bfloat16;

namespace mha {

constexpr int kKeys = 128;  // keys of a tile
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  bf16* o;  // [B, N, H, D]
  int B, N, M, H, D;
  float scale;
};

constexpr int kRows = 64;  // query rows of a block

template <int DP>
struct Cfg {
  static constexpr int kThreads = 128;
  static constexpr int kQChunk = kRows * 128;       // 64 columns of Q's rows
  static constexpr int kTileChunk = kKeys * 128;    // 64 columns of a K or V tile
  static constexpr int kTileBytes = kKeys * DP * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages = 2;
  // at DP 64, three blocks an SM: 72 KB of shared memory and at most 168
  // registers a thread each
  static constexpr int kMinBlocks = DP == 64 ? 3 : 1;
  static constexpr size_t kQ = 0;
  static constexpr size_t kRing = kQ + (size_t)kQChunk * (DP / 64);
  static constexpr size_t kBars = kRing + (size_t)kStages * kStageBytes;
  static constexpr size_t kBytes = 1024 + kBars + (kStages + 1) * 8;
  static_assert(DP == 64 || DP == 128, "product width");
  static_assert(kBytes <= 232448, "shared memory of a block");
};

// wgmma descriptor of an MN-major tile with the 128-byte swizzle: rows of
// 128 bytes along MN (64 bf16), one row per k, 8-row atoms 1024 bytes apart
// (the stride byte offset), and the next 64 columns of MN `lbo` bytes on
// (the leading byte offset).
__device__ __forceinline__ uint64_t smem_desc_mn(const void* tile, uint32_t lbo) {
  return static_cast<uint64_t>((sm90::smem_u32(tile) & 0x3FFFF) >> 4) |
         (uint64_t(lbo >> 4) << 16) | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// d += A (64 x 16, bf16 fragments in registers) . B (16 x N), B MN-major
// (transpose bit set), fp32 sums. The A fragment of warp w, lane l: rows
// 16 w + l / 4 (+ 8), columns 2 (l % 4) (+ 1, + 8, + 9), as mma.m16n8k16's.
template <int N>
__device__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Keep the compiler from reusing the A fragments' registers while a wgmma
// that reads them may be in flight.
__device__ __forceinline__ void fence_frags(uint32_t (&p)[kKeys / 16][4]) {
#pragma unroll
  for (int i = 0; i < kKeys / 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(p[i][e])::"memory");
  }
}

// One tile of the online softmax on the warpgroup's scores s (rows
// frag_row(0) and frag_row(2) of each thread), in the log2 domain: the
// running max m, the thread's part of the denominators l, O rescaled by
// exp2(m_old - m_new); s becomes P. With kMask, the keys from `valid` on are
// masked.
template <bool kMask, int kO>
__device__ __forceinline__ void online_softmax(float (&s)[kKeys / 2], float (&m)[2],
                                               float (&l)[2], float (&o)[kO], float scale_log2,
                                               int valid) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (kMask && sm90::frag_col(j, e) >= valid) x = -INFINITY;
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row's keys live in one quad of lanes
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile; finite: tile 0 has a valid key
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = exp2f(s[4 * j + e] - m[e >> 1]);
      sum[e >> 1] += s[4 * j + e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int j = 0; j < kO / 4; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::kThreads, Cfg<DP>::kMinBlocks)
    mha_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, const Args a) {
  using C = Cfg<DP>;
  constexpr int S = C::kStages;
  extern __shared__ __align__(16) uint8_t mha_smem[];
  uint8_t* base = mha_smem + ((1024 - (sm90::smem_u32(mha_smem) & 1023)) & 1023);
  uint8_t* ring = base + C::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::kBars);
  uint64_t* q_full = full + S;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (a.M + kKeys - 1) / kKeys;
  const int lt = threadIdx.x;
  // tile t's K and V into stage t % S (one thread)
  auto load_tile = [&](int t) {
    const int slot = t % S;
    uint8_t* stage = ring + slot * C::kStageBytes;
    sm90::mbar_expect_tx(&full[slot], C::kStageBytes);
    for (int c = 0; c < DP / 64; ++c) {
      sm90::tma_load_4d(stage + c * C::kTileChunk, &k_map, &full[slot], 64 * c, h, t * kKeys,
                        b);
      sm90::tma_load_4d(stage + C::kTileBytes + c * C::kTileChunk, &v_map, &full[slot], 64 * c,
                        h, t * kKeys, b);
    }
  };
  if (lt == 0) {
    for (int s = 0; s < S; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm90::mbar_expect_tx(q_full, C::kQChunk * (DP / 64));
    for (int c = 0; c < DP / 64; ++c) {
      sm90::tma_load_4d(base + C::kQ + c * C::kQChunk, &q_map, q_full, 64 * c, h, q0, b);
    }
    for (int t = 0; t < S && t < n_tiles; ++t) load_tile(t);
  }
  __syncthreads();

  const float scale_log2 = a.scale * kLog2e;
  sm90::mbar_wait(q_full, 0);
  float s[kKeys / 2], o[DP / 2];
  uint32_t p[kKeys / 16][4] = {};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  // the zeros stay ahead of the first wgmma: where the compiler sank them
  // past it, ptxas serialized every wgmma of the kernel (its C7515 note)
  sm90::fence_sums(o);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t % S;
    sm90::mbar_wait(&full[slot], (t / S) & 1);
    const uint8_t* kt = ring + slot * C::kStageBytes;
    // S = Q K^T over DP / 16 k steps of 32 bytes
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < DP / 16; ++k) {
      const uint64_t dq = sm90::smem_desc(base + C::kQ + (k / 4) * C::kQChunk) + 2 * (k % 4);
      const uint64_t dk = sm90::smem_desc(kt + (k / 4) * C::kTileChunk) + 2 * (k % 4);
      sm90::wgmma<float, kKeys>(s, dq, dk, k > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // the last tile's P V
    sm90::fence_sums(o);
    fence_frags(p);
    if (t > 0 && t - 1 + S < n_tiles && lt == 0) load_tile(t - 1 + S);
    sm90::wgmma_wait<0>();
    sm90::fence_sums(s);
    const int valid = a.M - t * kKeys;
    if (valid >= kKeys) {
      online_softmax<false>(s, m_run, l_run, o, scale_log2, valid);
    } else {
      online_softmax<true>(s, m_run, l_run, o, scale_log2, valid);
    }
    // O += P V: P's A fragments are the score accumulators cast to bf16
#pragma unroll
    for (int k = 0; k < kKeys / 16; ++k) {
      p[k][0] = pack_bf16(s[8 * k], s[8 * k + 1]);
      p[k][1] = pack_bf16(s[8 * k + 2], s[8 * k + 3]);
      p[k][2] = pack_bf16(s[8 * k + 4], s[8 * k + 5]);
      p[k][3] = pack_bf16(s[8 * k + 6], s[8 * k + 7]);
    }
    const uint8_t* vt = kt + C::kTileBytes;
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kKeys / 16; ++k) {
      wgmma_pv<DP>(o, p[k], smem_desc_mn(vt + k * 16 * 128, C::kTileChunk));
    }
    sm90::wgmma_commit();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_sums(o);
  fence_frags(p);

  // o[b, n, h, :] = O / l, cast once.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + sm90::frag_row(2 * r);
    if (n >= a.N) continue;
    bf16* orow = a.o + (((long long)b * a.N + n) * a.H + h) * a.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = sm90::frag_col(j, 0);
      if (col < a.D) {
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
}

template <int DP>
cudaError_t launch(const CUtensorMap& q_map, const CUtensorMap& k_map, const CUtensorMap& v_map,
                   const Args& a, cudaStream_t stream) {
  using C = Cfg<DP>;
  cudaError_t err = cudaFuncSetAttribute(mha_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kRows - 1) / kRows, a.H, a.B);
  mha_kernel<DP><<<grid, C::kThreads, C::kBytes, stream>>>(q_map, k_map, v_map, a);
  return cudaGetLastError();
}

// The TMA map of q, k or v [B, L, H, D] (element strides s_b, s_l, s_h, unit
// along D) as (D, H, L, B), boxes of 64 columns x 1 head x `rows` x 1.
inline cudaError_t head_map(CUtensorMap* map, const bf16* x, int B, int L, int H, int D,
                            long long s_b, long long s_l, long long s_h, uint32_t rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)L, (uint64_t)B};
  const uint64_t strides[3] = {2 * (uint64_t)s_h, 2 * (uint64_t)s_l, 2 * (uint64_t)s_b};
  const uint32_t box[4] = {64, 1, rows, 1};
  const uint32_t steps[4] = {1, 1, 1, 1};
  return sm90::tensor_map_nd(map, x, 2, 4, dims, strides, box, steps);
}

}  // namespace mha

// The bf16 attention of q [B, N, H, D] and k, v [B, M, H, D] into o [B, N, H,
// D] (contiguous), q, k and v read through their element strides (unit
// along D; the others multiples of 8 and nested: s_h >= D, s_l >= H s_h,
// s_b >= L s_l, as TMA's dimensions). D is 16-128 in steps of 16.
inline cudaError_t launch_mha_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
                                   int N, int M, int H, int D, const long long (&sq)[3],
                                   const long long (&sk)[3], const long long (&sv)[3],
                                   float scale, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0 || D <= 0 || D > 128 || D % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = mha::head_map(&q_map, q, B, N, H, D, sq[0], sq[1], sq[2], mha::kRows);
  if (err == cudaSuccess) err = mha::head_map(&k_map, k, B, M, H, D, sk[0], sk[1], sk[2], 128);
  if (err == cudaSuccess) err = mha::head_map(&v_map, v, B, M, H, D, sv[0], sv[1], sv[2], 128);
  if (err != cudaSuccess) return err;
  const mha::Args a{o, B, N, M, H, D, scale};
  return D <= 64 ? mha::launch<64>(q_map, k_map, v_map, a, stream)
                 : mha::launch<128>(q_map, k_map, v_map, a, stream);
}

}  // namespace d3r
