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
// Design: one block of 4 warps per (query tile of 64 rows, head, batch); each
// warp owns 16 query rows. A Hopper block cannot hold a [64, 3600] fp32
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 64;  // keys per tile
constexpr int kWarps = 4;    // each warp owns 16 query rows
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;      // bf16 row padding: 16-byte rows, no ldmatrix bank conflicts
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int kLd = D + kPad;
  static constexpr size_t kTile = sizeof(bf16) * kBlockK * kLd;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * kBlockQ * kLd;  // 2 buffers
  static constexpr size_t v = k + 2 * kTile;                       // 2 buffers
  static constexpr size_t bytes = v + 2 * kTile;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

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

// c += a (16x16, row) * b (16x8, col), bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
  for (int i = threadIdx.x; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async_16(dst + r * (D + kPad) + c, src + (ok ? row0 + r : 0) * row_stride + c,
                ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
mha_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o, int N, int M, int H,
           int sqb, int sqn, int sqh, int skb, int skm, int skh, int svb, int svm,
           int svh, float scale) {
  using L = Layout<D>;
  constexpr int kLd = L::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::v);

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (and row + 8)
  const int tg = lane % 4;  // fragment column pair
  const int r0 = warp * 16;
  const bf16* kb = k + (long long)b * skb + (long long)h * skh;
  const bf16* vb = v + (long long)b * svb + (long long)h * svh;
  const int n_tiles = (M + kBlockK - 1) / kBlockK;

  stage_rows<D, kBlockQ>(qs, q + (long long)b * sqb + (long long)h * sqh, q0, N, sqn);
  stage_rows<D, kBlockK>(ks, kb, 0, M, skm);
  stage_rows<D, kBlockK>(vs, vb, 0, M, svm);
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
  const float scale_log2 = scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other buffer
      stage_rows<D, kBlockK>(ks + (buf ^ 1) * kBlockK * kLd, kb, (t + 1) * kBlockK, M, skm);
      stage_rows<D, kBlockK>(vs + (buf ^ 1) * kBlockK * kLd, vb, (t + 1) * kBlockK, M, svm);
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
    const bf16* kt = ks + buf * kBlockK * kLd;
    const bf16* vt = vs + buf * kBlockK * kLd;

    // S = Q K^T: 8 n-tiles of 8 keys; two per ldmatrix.x4.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kBlockK / 8; j += 2) {
        uint32_t bfrag[4];
        ldmatrix_x4(bfrag, kt + (j * 8 + (lmat >> 1) * 8 + lrow) * kLd + kk * 16 + (lmat & 1) * 8);
        mma_bf16(s[j], qf[kk], bfrag[0], bfrag[1]);
        mma_bf16(s[j + 1], qf[kk], bfrag[2], bfrag[3]);
      }
    }

    // Online softmax in the log2 domain; a thread holds, per n-tile, keys
    // 2tg and 2tg + 1 of rows g (s[j][0..1]) and g + 8 (s[j][2..3]).
    const int key0 = t * kBlockK + 2 * tg;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
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
    for (int j = 0; j < kBlockK / 8; ++j) {
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
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t bfrag[4];
        ldmatrix_x4_trans(bfrag, vt + (kk * 16 + (lmat & 1) * 8 + lrow) * kLd + j * 8 + (lmat >> 1) * 8);
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
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int N, int M,
                   int H, int sqb, int sqn, int sqh, int skb, int skm, int skh, int svb, int svm,
                   int svh, float scale, cudaStream_t stream) {
  using L = Layout<D>;
  cudaError_t err = cudaFuncSetAttribute(
      mha_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, H, B);
  mha_kernel<D><<<grid, kThreads, L::bytes, stream>>>(
      q, k, v, o, N, M, H, sqb, sqn, sqh, skb, skm, skh, svb, svm, svh, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, N, H, D], k and v [B, M, H, D] (bf16, unit stride along D, other
// strides in elements and multiples of 8, 16-byte aligned); o [B, N, H, D]
// contiguous. D is a multiple of 16 up to 128. Returns cudaGetLastError().
extern "C" int d3r_mha_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                      int B, int N, int M, int H, int D, int sqb, int sqn,
                                      int sqh, int skb, int skm, int skh, int svb, int svm,
                                      int svh, float scale, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  const auto* vv = static_cast<const bf16*>(v);
  auto* oo = static_cast<bf16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
#define D3R_MHA_CASE(DIM)                                                                     \
  case DIM:                                                                                   \
    return (int)launch<DIM>(qq, kk, vv, oo, B, N, M, H, sqb, sqn, sqh, skb, skm, skh, svb,    \
                            svm, svh, scale, st);
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
