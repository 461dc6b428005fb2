// Multi-head attention for Hopper (sm_90a) with both products in int8:
//   s = (qq . kq) * (scale * sq * sk)          int32 sums, fp32 scores
//   p = exp(s - rowmax(s))                      fp32, over the whole key row
//   out = ((round(127 p) . vq) * (sv / 127)) / sum(p)      bf16
// with q, k and v quantized per (batch, head): s_x = max(absmax, 1e-6) / 127,
// x_q = round(x / s_x), no clip.
//
// Replaces: d3roma_tpu/ops/pallas/attention.py::mha_attention, its int8 path
// (kernel body _kernel_int8, and the wrapper's quantization, which XLA runs
// there). That TPU kernel holds a whole [block_q, M] score row in VMEM: it
// takes the true row max, quantizes the unnormalized P = exp(s - max) at the
// fixed scale 127, and divides by the fp32 denominator at the end.
//
// What bounds it on the H100: operations. At the UNet's sites (N = M = 3600,
// H = 5 and N = M = 920, H = 10, D = 64) and the VAE's (N = M = 3600, H = 1,
// D = 512) the two products do 4*N*M*D int8 operations per (batch, head)
// against about 4*N*D bytes, i.e. ~M operations per byte, above the ~590 per
// byte where the int8 tensor cores become the limit.
//
// Design. One call runs four launches on the caller's stream: zero the
// absmax table; absmax of q, k and v per (batch, head) (atomicMax on the bit
// pattern of non-negative floats); quantize q and k in place of layout and v
// into [B, H, D, M_pad] (keys contiguous: int8 mma and wgmma take their B
// operand K-major; zero past M); the attention kernel. The two quantization
// launches read q, k and v in loads of consecutive addresses (a head's rows
// are strided by H * D) and write whole 16-byte pieces, so they move about
// the tensors' bytes.
//
// A Hopper block cannot hold a [64, 3600] score row, and an online softmax
// only knows a running max, so it could not quantize P against the true
// row max as the TPU kernel does. The attention kernels therefore walk the
// keys twice:
//   pass 1: S = Q K^T (int32), keeping each row's largest integer score; the
//           row max of the fp32 scores is that integer times
//           scale * sq * sk (the conversion and the product are monotonic);
//   pass 2: S again; p = exp(s - max) into the fp32 denominator, unrounded;
//           round(127 p) into an int8 P tile; O += P V (int32).
// That costs the first product twice (1.5x the operations), for numerics
// that are the TPU kernel's. The int32 sums cannot overflow: at most
// 127^2 * D for Q K^T and 127^2 * M for P V.
//
// Head widths up to 128 (the UNet): the kernel of attention_int8_rows.cuh
// (shared with the fused self-attention): TMA + int8 wgmma, 128 query rows
// and 128-key tiles a block; its note says what bounds it.
//
// Head width 512 (the VAE): mma.sync m16n8k32 (int8, int32 accumulation). A
// warp's [16, 512] int32 output would take 256 registers per thread, so the
// block takes 32 query rows with 8 warps and splits D across them (each
// warp owns 16 of the 128 output fragments of [32, 512]); the scores go
// through shared memory, every warp reads the shared P tile, and the K and
// V tiles (33 and 40 KB, 64 keys) are loaded and waited for (no double
// buffering at this width).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attention_int8_rows.cuh"
#include "int8_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using d3r::cp_async_16;

constexpr int kBK = d3r::kAttnKeyTile;  // keys per tile
using d3r::AttnArgs;
using d3r::head_scale;

// --------------------------------------------------------------------------
// The per-(batch, head) quantization.

struct QuantArgs {
  const bf16* x[3];  // q [B, N, H, D], k and v [B, M, H, D]
  int L[3];          // N, M, M
  int8_t* xq[2];     // qq, kq: the layout of q and k
  int8_t* vt;        // [B, H, D, Mp]
  unsigned int* amax;
  int B, H, D, Mp;
};

constexpr int kAbsRows = 32;  // token rows of an absmax block
constexpr int kVKeys = 32;    // keys a thread writes to a row of vt (Mp is a multiple)

// grid (ceil(max L / 32), B, 3), H * 4 bytes of dynamic shared memory: block
// (x, b, z) reads rows 32 x .. 32 x + 31 of batch item b of tensor z, every
// head, in 16-byte loads of consecutive addresses; a thread keeps its max
// while its chunks stay in one head, and each head's max goes through
// shared memory and then to amax[z][b][h] (atomicMax on the bit pattern of
// non-negative floats).
__global__ void __launch_bounds__(256) absmax_kernel(QuantArgs a) {
  extern __shared__ unsigned int head_max[];
  const int z = blockIdx.z, b = blockIdx.y, L = a.L[z];
  const int r0 = blockIdx.x * kAbsRows;
  for (int h = threadIdx.x; h < a.H; h += blockDim.x) head_max[h] = 0u;
  __syncthreads();
  const int chunks = a.H * a.D / 8;  // 16-byte chunks of a row; each in one head
  const int n = r0 < L ? min(kAbsRows, L - r0) * chunks : 0;
  const uint4* src =
      reinterpret_cast<const uint4*>(a.x[z] + ((long long)b * L + r0) * a.H * a.D);
  int head = -1;
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int hi = i % chunks * 8 / a.D;
    if (hi != head) {
      if (head >= 0) atomicMax(&head_max[head], __float_as_uint(m));
      head = hi;
      m = 0.f;
    }
    const uint4 v = src[i];
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(__bfloat162float(e[j])));
  }
  if (head >= 0) atomicMax(&head_max[head], __float_as_uint(m));
  __syncthreads();
  for (int h = threadIdx.x; h < a.H; h += blockDim.x) {
    atomicMax(a.amax + (z * a.B + b) * a.H + h, head_max[h]);
  }
}

// 8 values x / s, rounded half to even, no clip.
__device__ __forceinline__ uint2 quantize8(const uint4& v, float s) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
  uint2 out;
  int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = (int8_t)rintf(__fdiv_rn(__bfloat162float(e[j]), s));
  return out;
}

// The first qk_blocks blocks quantize q and k in their own layout, 8 values
// a thread (16-byte loads, 8-byte stores). The blocks after them write vt
// [B, H, D, Mp], zero past M: a warp takes 32 values of d of one head and 32
// keys, a lane one d, reading its head's row of each key (the warp's loads
// are consecutive) and writing its 32 keys as two 16-byte stores.
__global__ void __launch_bounds__(256) quantize_heads_kernel(QuantArgs a, int qk_blocks) {
  if (blockIdx.x < qk_blocks) {
    const long long stride = (long long)qk_blocks * blockDim.x;
    for (int z = 0; z < 2; ++z) {
      const unsigned int* amax = a.amax + z * a.B * a.H;
      const long long per_item = (long long)a.L[z] * a.H * a.D;
      const long long n8 = a.B * per_item / 8;
      for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n8; i += stride) {
        const long long e = 8 * i;
        const int h = (int)((e / a.D) % a.H), b = (int)(e / per_item);
        reinterpret_cast<uint2*>(a.xq[z])[i] = quantize8(
            reinterpret_cast<const uint4*>(a.x[z])[i], head_scale(amax, b * a.H + h));
      }
    }
    return;
  }
  const long long task = ((long long)blockIdx.x - qk_blocks) * (blockDim.x / 32) + threadIdx.x / 32;
  const int key_groups = a.Mp / kVKeys, d_groups = a.D / 32;
  if (task >= (long long)a.B * a.H * d_groups * key_groups) return;
  const int l0 = (int)(task % key_groups) * kVKeys;
  const int d = (int)(task / key_groups % d_groups) * 32 + threadIdx.x % 32;
  const int bh = (int)(task / ((long long)key_groups * d_groups));
  const int b = bh / a.H, h = bh % a.H, L = a.L[2];
  const float s = head_scale(a.amax + 2 * a.B * a.H, bh);
  uint4 q[kVKeys / 16];
  int8_t* qb = reinterpret_cast<int8_t*>(q);
  const bf16* src = a.x[2] + (((long long)b * L + l0) * a.H + h) * a.D + d;
#pragma unroll
  for (int k = 0; k < kVKeys; ++k) {
    qb[k] = l0 + k < L
                ? (int8_t)rintf(__fdiv_rn(__bfloat162float(src[(long long)k * a.H * a.D]), s))
                : (int8_t)0;
  }
  uint4* dst = reinterpret_cast<uint4*>(a.vt + ((long long)bh * a.D + d) * a.Mp + l0);
#pragma unroll
  for (int k = 0; k < kVKeys / 16; ++k) dst[k] = q[k];
}

// --------------------------------------------------------------------------
// Head widths 256 and 512: the warps split D and share the score and P tiles.

template <int D, int BQ, int WARPS>
struct WideCfg {
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kLdq = D + 16;    // Q and K rows, bytes
  static constexpr int kLdv = kBK + 16;  // V^T rows (one per d), bytes
  static constexpr int kLds = kBK + 4;   // score rows, int32
  static constexpr int kLdp = kBK + 16;  // P rows, bytes
  static constexpr int kTpr = kThreads / BQ;  // threads per score row
  static constexpr int kKpt = kBK / kTpr;     // keys per thread
  static constexpr int kSTiles = (BQ / 16) * (kBK / 8);
  static constexpr int kOTiles = (BQ / 16) * (D / 8);
  static constexpr int kOPerWarp = kOTiles / WARPS;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + (size_t)BQ * kLdq;
  static constexpr size_t v = k + (size_t)kBK * kLdq;
  static constexpr size_t s = v + (size_t)D * kLdv;
  static constexpr size_t p = s + sizeof(int) * BQ * kLds;
  static constexpr size_t l = p + (size_t)BQ * kLdp;
  static constexpr size_t bytes = l + sizeof(float) * BQ;
  static_assert(D % 32 == 0 && BQ % 16 == 0, "tile shapes");
  static_assert(kThreads % BQ == 0 && 32 % kTpr == 0 && kKpt % 4 == 0, "row split");
  static_assert(kOTiles % WARPS == 0, "output fragments per warp");
};

template <int D, int BQ, int WARPS>
__global__ void __launch_bounds__(32 * WARPS) mha_int8_wide_kernel(AttnArgs a) {
  using C = WideCfg<D, BQ, WARPS>;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* qs = reinterpret_cast<int8_t*>(smem + C::q);
  int8_t* ks = reinterpret_cast<int8_t*>(smem + C::k);
  int8_t* vs = reinterpret_cast<int8_t*>(smem + C::v);
  int* ss = reinterpret_cast<int*>(smem + C::s);
  int8_t* ps = reinterpret_cast<int8_t*>(smem + C::p);
  float* lsum = reinterpret_cast<float*>(smem + C::l);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.H + h;
  const float c = __fmul_rn(__fmul_rn(a.scale, head_scale(a.amax_q, d3r::q_scale_index(a, b, h, q0))),
                            head_scale(a.amax_k, bh));
  const long long row_stride = (long long)a.H * D;
  const int8_t* qb = a.q + ((long long)b * a.N * a.H + h) * D;
  const int8_t* kb = a.k + ((long long)b * a.M * a.H + h) * D;
  const int8_t* vb = a.vt + (long long)bh * D * a.Mp;

  constexpr int kVecD = D / 16;
  for (int i = tid; i < BQ * kVecD; i += C::kThreads) {
    const int r = i / kVecD, cc = (i % kVecD) * 16;
    const bool ok = q0 + r < a.N;
    cp_async_16(qs + r * C::kLdq + cc, ok ? qb + (q0 + r) * row_stride + cc : a.q, ok ? 16 : 0);
  }
  d3r::cp_async_commit();

  const int row = tid / C::kTpr;                 // this thread's score row
  const int key_lo = (tid % C::kTpr) * C::kKpt;  // and its keys in a tile
  int run_max = INT_MIN;
  float m_row = 0.f, l_part = 0.f;
  int acc[C::kOPerWarp][4];
#pragma unroll
  for (int i = 0; i < C::kOPerWarp; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
  const int n_tiles = (a.M + kBK - 1) / kBK;

  for (int pass = 0; pass < 2; ++pass) {
    for (int t = 0; t < n_tiles; ++t) {
      for (int i = tid; i < kBK * kVecD; i += C::kThreads) {
        const int r = i / kVecD, cc = (i % kVecD) * 16;
        const int key = t * kBK + r;
        const bool ok = key < a.M;
        cp_async_16(ks + r * C::kLdq + cc, ok ? kb + key * row_stride + cc : a.k, ok ? 16 : 0);
      }
      if (pass == 1) {
        constexpr int kVecK = kBK / 16;
        for (int i = tid; i < D * kVecK; i += C::kThreads) {
          const int d = i / kVecK, cc = (i % kVecK) * 16;
          cp_async_16(vs + d * C::kLdv + cc, vb + (long long)d * a.Mp + t * kBK + cc, 16);
        }
      }
      d3r::cp_async_commit();
      d3r::cp_async_wait<0>();
      __syncthreads();

      // S = Q K^T: the (16 x 8) score fragments are dealt out to the warps.
      for (int ti = warp; ti < C::kSTiles; ti += WARPS) {
        const int mt = ti / (kBK / 8), nt = ti % (kBK / 8);
        int s[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk) {
          uint32_t af[4], b0, b1;
          d3r::load_a(af, qs, C::kLdq, mt * 16, kk * 32, lane);
          d3r::load_b(b0, b1, ks, C::kLdq, nt * 8, kk * 32, lane);
          d3r::mma_s8(s, af, b0, b1);
        }
        int* dst = ss + (mt * 16 + g) * C::kLds + nt * 8 + 2 * t4;
        *reinterpret_cast<int2*>(dst) = make_int2(s[0], s[1]);
        *reinterpret_cast<int2*>(dst + 8 * C::kLds) = make_int2(s[2], s[3]);
      }
      __syncthreads();

      const int* srow = ss + row * C::kLds + key_lo;
      const int key0 = t * kBK + key_lo;
      if (pass == 0) {
#pragma unroll
        for (int j = 0; j < C::kKpt; ++j) {
          if (key0 + j < a.M) run_max = max(run_max, srow[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < C::kKpt; j += 4) {
          uint32_t packed = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = 0.f;
            if (key0 + j + e < a.M) {
              p = expf(__fsub_rn(__fmul_rn((float)srow[j + e], c), m_row));
            }
            l_part = __fadd_rn(l_part, p);
            // p in [0, 1]: round(127 p) in [0, 127]
            packed |= (uint32_t)rintf(__fmul_rn(p, 127.f)) << (8 * e);
          }
          *reinterpret_cast<uint32_t*>(ps + row * C::kLdp + key_lo + j) = packed;
        }
        __syncthreads();
        // O += P V: this warp's output fragments.
#pragma unroll
        for (int i = 0; i < C::kOPerWarp; ++i) {
          const int ti = warp + i * WARPS;
          const int mt = ti / (D / 8), nt = ti % (D / 8);
#pragma unroll
          for (int kk = 0; kk < kBK / 32; ++kk) {
            uint32_t af[4], b0, b1;
            d3r::load_a(af, ps, C::kLdp, mt * 16, kk * 32, lane);
            d3r::load_b(b0, b1, vs, C::kLdv, nt * 8, kk * 32, lane);
            d3r::mma_s8(acc[i], af, b0, b1);
          }
        }
      }
      __syncthreads();  // the next tile's copies overwrite K, V, S and P
    }
    if (pass == 0) {
#pragma unroll
      for (int o = 1; o < C::kTpr; o <<= 1) {
        run_max = max(run_max, __shfl_xor_sync(0xffffffffu, run_max, o));
      }
      m_row = __fmul_rn((float)run_max, c);
    }
  }
#pragma unroll
  for (int o = 1; o < C::kTpr; o <<= 1) {
    l_part = __fadd_rn(l_part, __shfl_xor_sync(0xffffffffu, l_part, o));
  }
  if (tid % C::kTpr == 0) lsum[row] = l_part;
  __syncthreads();

  const float sv127 = __fdiv_rn(head_scale(a.amax_v, bh), 127.f);
#pragma unroll
  for (int i = 0; i < C::kOPerWarp; ++i) {
    const int ti = warp + i * WARPS;
    const int mt = ti / (D / 8), nt = ti % (D / 8);
    const int d = nt * 8 + 2 * t4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = mt * 16 + g + 8 * hh;
      const int n = q0 + r;
      if (n >= a.N) continue;
      const float v0 = __fdiv_rn(__fmul_rn((float)acc[i][2 * hh], sv127), lsum[r]);
      const float v1 = __fdiv_rn(__fmul_rn((float)acc[i][2 * hh + 1], sv127), lsum[r]);
      *reinterpret_cast<__nv_bfloat162*>(a.o + (((long long)b * a.N + n) * a.H + h) * D + d) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int D, int BQ, int WARPS>
cudaError_t launch_wide(const AttnArgs& a, cudaStream_t st) {
  using C = WideCfg<D, BQ, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(mha_int8_wide_kernel<D, BQ, WARPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BQ - 1) / BQ, a.H, a.B);
  mha_int8_wide_kernel<D, BQ, WARPS><<<grid, C::kThreads, C::bytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q [B, N, H, D], k and v [B, M, H, D]: bf16, contiguous, 16-byte aligned.
// Scratch: qq [B, N, H, D] and kq [B, M, H, D] int8, vt [B, H, D, Mp] int8
// (Mp a multiple of 64, at least M), amax [3, B, H] uint32. o [B, N, H, D]
// bf16. D in {32, 64, 96, 128, 256, 512}. Returns the first CUDA error of
// the four launches, else cudaGetLastError().
extern "C" int d3r_mha_attention_int8(const void* q, const void* k, const void* v, void* qq,
                                      void* kq, void* vt, void* amax, void* o, int B, int N,
                                      int M, int Mp, int H, int D, float scale, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0 || Mp % kBK != 0 || Mp < M || D % 32 != 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned int) * 3 * B * H, st);
  if (err != cudaSuccess) return (int)err;
  QuantArgs qa{{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v)},
               {N, M, M},
               {static_cast<int8_t*>(qq), static_cast<int8_t*>(kq)},
               static_cast<int8_t*>(vt), static_cast<unsigned int*>(amax), B, H, D, Mp};
  const int max_l = N > M ? N : M;
  absmax_kernel<<<dim3((max_l + kAbsRows - 1) / kAbsRows, B, 3), 256, H * sizeof(unsigned int),
                  st>>>(qa);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long n8 = (long long)B * (N > M ? N : M) * H * D / 8;
  const int qk_blocks = (int)std::min<long long>((n8 + 255) / 256, 132 * 4);
  const long long v_tasks = (long long)B * H * (D / 32) * (Mp / kVKeys);  // 8 a block
  quantize_heads_kernel<<<qk_blocks + (int)((v_tasks + 7) / 8), 256, 0, st>>>(qa, qk_blocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // one q scale per (batch, head): q_rows = N
  const unsigned int* am = static_cast<const unsigned int*>(amax);
  AttnArgs a{static_cast<const int8_t*>(qq), static_cast<const int8_t*>(kq),
             static_cast<const int8_t*>(vt), am, am + B * H, am + 2 * B * H,
             static_cast<bf16*>(o), B, N, M, Mp, H, N, scale};
  switch (D) {
    case 32: return (int)d3r::launch_rows<32>(a, st);
    case 64: return (int)d3r::launch_rows<64>(a, st);
    case 96: return (int)d3r::launch_rows<96>(a, st);
    case 128: return (int)d3r::launch_rows<128>(a, st);
    case 256: return (int)launch_wide<256, 32, 8>(a, st);
    case 512: return (int)launch_wide<512, 32, 8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
