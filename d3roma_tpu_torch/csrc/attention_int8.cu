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
// into [B, H, D, M_pad] (keys contiguous: int8 wgmma takes its B
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
// Head widths 256 and 512 (the VAE's one head of 512): the wide kernel
// below, on the same TMA + int8 wgmma pieces. What bounds it is the int8
// tensor cores, not the softmax: each score feeds 2 D = 1024 int8
// operations per product (3072 over the three), against ~15 instructions of
// softmax. Its design answers the registers: a [64, 512] int32 output is 256
// registers a thread, so D is split into 128-wide slices, one consumer
// warpgroup each, and the keys of a tile are split among the same
// warpgroups for the scores, whose round(127 p) meet in one shared P tile.
// The int8 P V^T runs while the next tile's scores are issued; the K and V
// tiles come through a ring of five (D 512) or eight (D 256) units of
// 64 D bytes, each refilled by the last warpgroup to hand it back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attention_int8_rows.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kBK = d3r::kAttnKeyTile;  // vt's key padding
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
// Head widths 256 and 512: the wide kernel. A block owns 64 query rows of
// one (batch, head) and runs D / 128 warpgroups, each the owner of a
// 128-wide slice of O (64 int32 sums a thread: the whole [64, 512] would
// take 256). The scores contract over all of D, so the warpgroups split the
// keys of a tile instead: warpgroup w takes keys [w 128 / (D / 128), ...)
// of each 128-key tile (32 keys at D = 512, 64 at D = 256), writes its
// round(127 p) into a P tile [64, 128] that every warpgroup then reads as
// the A operand of its O slice += P V^T. Each product is then done once,
// split four (or two) ways, with no score recomputed.
//
// The K and V tiles come through a ring of kSlots units of 64 D bytes: per
// key tile, pass 1 reads two K halves (keys 0-63 and 64-127, [64 keys, D]
// as D / 128 boxes of [64, 128 bytes]); pass 2 the two K halves and the two
// V halves (rows 0 .. D / 2 - 1 and D / 2 .. D - 1 of the head's V^T, 128
// keys a row, one box). D / 256 warpgroups read each unit. The block has no
// producer warp: a seventeenth warp would leave the SM's four schedulers
// 102 registers a thread for five warps (96 after rounding), and the
// consumers spilled and had their wgmmas serialized. Instead the warpgroup
// that hands a unit back last (a shared counter per slot) loads unit
// u + kSlots into its slot; thread 0 loads Q and the first kSlots units.
// Per tile of pass 2, a warpgroup: S of its keys (wgmma m64n{32,64}k32 over
// D / 32 k steps, Q read from shared memory); waits for the last tile's
// P V^T and hands back its V unit, then for S and hands back its K unit;
// writes its P columns into one of two P tiles (the other may still be
// read by products in flight); meets the other warpgroups on a barrier; and
// issues O += P V^T (wgmma m64n128k32, 4 k steps), which runs while the
// next tile's S is issued. Pass 1's row max and the denominator are
// combined across the warpgroups through shared memory.

namespace wide {

namespace sm90 = d3r::sm90;

constexpr int kRows = 64;          // query rows of a block
constexpr int kKeys = 128;         // keys of a tile
constexpr int kChunk = 64 * 128;   // a [64 rows, 128 bytes] box: of Q, or of a K half
constexpr int kPBytes = 64 * 128;  // a P tile [64 rows, 128 keys]

template <int D>
struct Cfg {
  static constexpr int kGroups = D / 128;         // warpgroups
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kReaders = kGroups / 2;    // warpgroups that read a unit
  static constexpr int kWgKeys = kKeys / kGroups;  // a warpgroup's keys of a tile
  static constexpr int kUnitBytes = 64 * D;        // a K half or a V half
  static constexpr int kSlots = D == 512 ? 5 : 8;
  static constexpr size_t kQ = 0;
  static constexpr size_t kP = kQ + (size_t)kRows * D;
  static constexpr size_t kRing = kP + 2 * kPBytes;
  static constexpr size_t kMax = kRing + (size_t)kSlots * kUnitBytes;  // int [kGroups][64]
  static constexpr size_t kSum = kMax + sizeof(int) * kGroups * kRows;  // float [kGroups][64]
  static constexpr size_t kCount = kSum + sizeof(float) * kGroups * kRows;  // int [kSlots]
  static constexpr size_t kBars = kCount + sizeof(int) * 8;
  static constexpr size_t kBytes = 1024 + kBars + (kSlots + 1) * 8;
  static_assert(D == 256 || D == 512, "head width");
  static_assert(kSlots <= 8, "slot counters");
  static_assert(kBytes <= 232448, "shared memory of a block");
};

// Barrier 1 of the block's threads.
template <int kThreads>
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// Unit u of the ring into its slot (one thread): pass 1's units are the two
// K halves of each tile, pass 2's the two K halves and the two V halves.
template <int D>
__device__ __forceinline__ void load_unit(int u, int n_tiles, uint8_t* ring, uint64_t* full,
                                          const CUtensorMap* k_map, const CUtensorMap* v_map,
                                          int h, int b, int bh, int M) {
  using C = Cfg<D>;
  const int slot = u % C::kSlots;
  uint8_t* dst = ring + slot * C::kUnitBytes;
  const bool pass2 = u >= 2 * n_tiles;
  const int r = pass2 ? u - 2 * n_tiles : u;
  const int t = pass2 ? r / 4 : r / 2, part = pass2 ? r % 4 : r % 2;
  sm90::mbar_expect_tx(&full[slot], C::kUnitBytes);
  if (part < 2) {
    for (int c = 0; c < D / 128; ++c) {
      sm90::tma_load_3d(dst + c * kChunk, k_map, &full[slot], 128 * c, h,
                        b * M + t * kKeys + 64 * part);
    }
  } else {
    sm90::tma_load(dst, v_map, &full[slot], t * kKeys, bh * D + D / 2 * (part - 2));
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    mha_int8_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, const AttnArgs a) {
  using C = Cfg<D>;
  constexpr int S = C::kSlots;
  extern __shared__ __align__(16) uint8_t wide_smem[];
  uint8_t* base = wide_smem + ((1024 - (sm90::smem_u32(wide_smem) & 1023)) & 1023);
  uint8_t* ring = base + C::kRing;
  int* red_max = reinterpret_cast<int*>(base + C::kMax);
  float* red_sum = reinterpret_cast<float*>(base + C::kSum);
  int* count = reinterpret_cast<int*>(base + C::kCount);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::kBars);
  uint64_t* q_full = full + S;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.H + h;
  const int n_tiles = (a.M + kKeys - 1) / kKeys;
  const int units = 6 * n_tiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      count[s] = 0;
    }
    sm90::mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm90::mbar_expect_tx(q_full, kRows * D);
    for (int c = 0; c < D / 128; ++c) {
      sm90::tma_load_3d(base + C::kQ + c * kChunk, &q_map, q_full, 128 * c, h, b * a.N + q0);
    }
    for (int u = 0; u < S && u < units; ++u) {
      load_unit<D>(u, n_tiles, ring, full, &k_map, &v_map, h, b, bh, a.M);
    }
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
  const int half = wg / C::kReaders;                // the K and V halves it reads
  const int key_off = wg * C::kWgKeys;              // its keys in a tile
  const int in_half = key_off - 64 * half;          // and in its K half
  const int v_off = (wg % C::kReaders) * 128 * 128;  // its 128 rows of its V half
  const float sq = head_scale(a.amax_q, d3r::q_scale_index(a, b, h, q0));
  const float c = __fmul_rn(__fmul_rn(a.scale, sq), head_scale(a.amax_k, bh));

  // Hand unit u back (one thread of the warpgroup, after the wgmmas that
  // read it are done); the last of its readers loads unit u + S.
  auto release = [&](int u) {
    if (lt != 0) return;
    __threadfence_block();
    if (atomicAdd(&count[u % S], 1) == C::kReaders - 1) {
      count[u % S] = 0;
      __threadfence_block();
      if (u + S < units) load_unit<D>(u + S, n_tiles, ring, full, &k_map, &v_map, h, b, bh, a.M);
    }
  };

  sm90::mbar_wait(q_full, 0);
  int s[C::kWgKeys / 2];

  // S of this warpgroup's keys, from the K half in unit u's slot
  auto scores = [&](int u) {
    const uint8_t* kh = ring + (u % S) * C::kUnitBytes + in_half * 128;
    sm90::fence_sums(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int ch = 0; ch < D / 128; ++ch) {
      const uint64_t dq = sm90::smem_desc(base + C::kQ + ch * kChunk);
      const uint64_t dk = sm90::smem_desc(kh + ch * kChunk);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sm90::wgmma<int, C::kWgKeys>(s, dq + 2 * k, dk + 2 * k, ch > 0 || k > 0);
      }
    }
    sm90::wgmma_commit();
  };

  // pass 1: the rows' integer max (rows frag_row(0) and frag_row(2))
  int run_max[2] = {INT_MIN, INT_MIN};
  for (int t = 0; t < n_tiles; ++t) {
    const int u = 2 * t + half;
    sm90::mbar_wait(&full[u % S], (u / S) & 1);
    scores(u);
    sm90::wgmma_wait<0>();
    sm90::fence_sums(s);
    release(u);
    const int valid = a.M - t * kKeys - key_off;
    if (valid >= C::kWgKeys) {
      d3r::rows::row_max<false>(s, run_max, valid);
    } else {
      d3r::rows::row_max<true>(s, run_max, valid);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // a row's keys live in one quad of lanes
    run_max[i] = max(run_max[i], __shfl_xor_sync(0xffffffffu, run_max[i], 1));
    run_max[i] = max(run_max[i], __shfl_xor_sync(0xffffffffu, run_max[i], 2));
    if (lt % 4 == 0) red_max[wg * kRows + sm90::frag_row(2 * i)] = run_max[i];
  }
  block_sync<C::kThreads>();
  float m_row[2], l_row[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int mx = INT_MIN;
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g) mx = max(mx, red_max[g * kRows + sm90::frag_row(2 * i)]);
    m_row[i] = __fmul_rn((float)mx, c);
  }

  // pass 2: P and O += P V^T
  int o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0;
  sm90::fence_sums(o);  // the zeros stay ahead of the first wgmma (else ptxas serializes)
  const int u2 = 2 * n_tiles;  // pass 2's first unit
  for (int t = 0; t < n_tiles; ++t) {
    const int uk = u2 + 4 * t + half, uv = uk + 2;
    sm90::mbar_wait(&full[uk % S], (uk / S) & 1);
    scores(uk);
    sm90::wgmma_wait<1>();  // the last tile's P V^T
    sm90::fence_sums(o);
    if (t > 0) release(uv - 4);
    sm90::wgmma_wait<0>();  // this tile's S
    sm90::fence_sums(s);
    release(uk);
    uint8_t* pt = base + C::kP + (t & 1) * kPBytes;
    const int valid = a.M - t * kKeys - key_off;
    if (valid >= C::kWgKeys) {
      d3r::rows::softmax_tile<false>(s, c, m_row, l_row, pt, valid, key_off);
    } else {
      d3r::rows::softmax_tile<true>(s, c, m_row, l_row, pt, valid, key_off);
    }
    sm90::fence_proxy_async();
    block_sync<C::kThreads>();  // every warpgroup's columns of the P tile are written
    sm90::mbar_wait(&full[uv % S], (uv / S) & 1);
    const uint64_t dp = sm90::smem_desc(pt);
    const uint64_t dv = sm90::smem_desc(ring + (uv % S) * C::kUnitBytes + v_off);
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kKeys / 32; ++k) sm90::wgmma<int, 128>(o, dp + 2 * k, dv + 2 * k, 1);
    sm90::wgmma_commit();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_sums(o);
  release(u2 + 4 * (n_tiles - 1) + half + 2);

  // the denominators: the quad's keys, then the warpgroups' in order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_row[i] = __fadd_rn(l_row[i], __shfl_xor_sync(0xffffffffu, l_row[i], 1));
    l_row[i] = __fadd_rn(l_row[i], __shfl_xor_sync(0xffffffffu, l_row[i], 2));
    if (lt % 4 == 0) red_sum[wg * kRows + sm90::frag_row(2 * i)] = l_row[i];
  }
  block_sync<C::kThreads>();
  const float sv127 = __fdiv_rn(head_scale(a.amax_v, bh), 127.f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = sm90::frag_row(2 * i);
    float l = 0.f;
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g) l = __fadd_rn(l, red_sum[g * kRows + r]);
    const int n = q0 + r;
    if (n >= a.N) continue;
    __nv_bfloat16* orow = a.o + (((long long)b * a.N + n) * a.H + h) * D + 128 * wg;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float v0 = __fdiv_rn(__fmul_rn((float)o[4 * j + 2 * i], sv127), l);
      const float v1 = __fdiv_rn(__fmul_rn((float)o[4 * j + 2 * i + 1], sv127), l);
      *reinterpret_cast<__nv_bfloat162*>(orow + sm90::frag_col(j, 0)) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

}  // namespace wide

// Launch the wide kernel on grid (ceil(N / 64), H, B): the TMA maps of q
// and k ([B, L, H, D] as (D, H, B L), boxes of 128 bytes x 1 head x 64 rows)
// and of vt ([B H D, Mp], boxes of 128 keys x D / 2 rows). One q scale per
// (batch, head): q_rows must be at least N.
template <int D>
cudaError_t launch_wide(const AttnArgs& a, cudaStream_t st) {
  using C = wide::Cfg<D>;
  if (a.q_rows < a.N || a.Mp < a.M || a.Mp % 16 != 0) return cudaErrorInvalidValue;
  const uint32_t box[3] = {128, 1, wide::kRows};
  const uint32_t steps[3] = {1, 1, 1};
  const uint64_t strides[2] = {D, (uint64_t)a.H * D};
  const uint64_t q_dims[3] = {D, (uint64_t)a.H, (uint64_t)a.B * a.N};
  const uint64_t k_dims[3] = {D, (uint64_t)a.H, (uint64_t)a.B * a.M};
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = d3r::sm90::tensor_map_nd(&q_map, a.q, 1, 3, q_dims, strides, box, steps);
  if (err == cudaSuccess) {
    err = d3r::sm90::tensor_map_nd(&k_map, a.k, 1, 3, k_dims, strides, box, steps);
  }
  if (err == cudaSuccess) {
    err = d3r::sm90::tensor_map(&v_map, a.vt, 1, (uint64_t)a.B * a.H * D, a.Mp, a.Mp, D / 2);
  }
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wide::mha_int8_wide_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + wide::kRows - 1) / wide::kRows, a.H, a.B);
  wide::mha_int8_wide_kernel<D><<<grid, C::kThreads, C::kBytes, st>>>(q_map, k_map, v_map, a);
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
    case 256: return (int)launch_wide<256>(a, st);
    case 512: return (int)launch_wide<512>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
