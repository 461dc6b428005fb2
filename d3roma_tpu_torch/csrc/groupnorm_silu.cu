// GroupNorm + affine + SiLU over NHWC activations in one launch, for Hopper
// (sm_90a):
//   mean_g = (sum over the group's pixels and channels of x) * inv_n
//   var_g  = (sum of x^2) * inv_n - mean_g^2          fp32, no clamp
//   scale_c = rsqrt(var_g + eps) * gamma_c,  shift_c = beta_c - mean_g * scale_c
//   y = x * scale_c + shift_c;  out = y * sigmoid(y)  fp32, cast to x's type
//
// Replaces: d3roma_tpu/ops/pallas/groupnorm.py::fused_group_norm_silu (kernel
// body _gn_silu_kernel). That TPU kernel holds one batch item's whole
// [H, W, C] slab in VMEM (the gate admits slabs up to 4 MiB), sums each
// channel over the rows, folds the channel sums to group sums with a one-hot
// matrix product, and normalizes the slab in fp32 on its second pass.
//
// What bounds it on the H100: bytes (x read once, the output written once,
// a few operations an element) and, at the opt-in path's slabs (0.3-3.7 MB
// a batch item), the fixed cost of each launch and each pass over x: so
// one launch, one read of x, and no copies of gamma and beta.
//
// Design: one launch on thread block clusters. A cluster owns one batch
// item and a band of whole groups (k groups, k C/G channels, a multiple of
// 8, so a pixel's band is 16-byte aligned); its `cluster` CTAs split the
// pixels, `per` each. grid (cluster, bands, B), cluster dims (cluster, 1,
// 1); the host's plan (ops/kernels/groupnorm.py::gn_plan) picks k, the
// cluster size and `per`.
//   1. A CTA copies its [per, band] tile of x into shared memory (cp.async,
//      16 bytes a thread), so x leaves HBM once ("resident"; where the
//      plan finds no tile that fits, it reads x again, from L2, for step 5).
//   2. It sums x and x^2 per channel in a fixed order: thread (row, slot)
//      owns channels [8 slot, 8 slot + 8) and walks pixels row, row + rows,
//      ...; the rows' sums are added by a pairwise tree (row r takes row
//      r + ceil(n / 2) while n rows are left); each group's channel sums
//      are added in channel order into the CTA's group partials.
//   3. barrier.cluster; every CTA gathers every rank's partials through
//      distributed shared memory (mapa + ld.shared::cluster, a thread a
//      value) and adds them in rank order, so all CTAs of the cluster get
//      the same mean and var bit for bit. No atomics and no global scratch:
//      a run repeats bit for bit.
//   4. It arrives on the cluster barrier (its reads of the other CTAs'
//      shared memory are done) and computes its band's per-channel scale
//      and shift, a thread a channel, from gamma and beta (read as bf16 or
//      fp32 into shared memory while the tile was loading), then
//   5. normalizes its tile from shared memory, 8 channels a thread and
//      16-byte stores, with the SiLU as y / (1 + exp(-y)) on the hardware's
//      exp2 and division approximations (__expf, __fdividef: a few ulps of
//      fp32, deterministic), then waits on the barrier before it exits, so
//      no CTA's shared memory goes while another still reads it.
// 512 threads a CTA, one CTA an SM: with 256, the normalize (its exp and
// division the most of the instructions) was short of warps to hide its
// latencies (B4 45x80x512: 0.061 ms a call back to back at one CTA of 256
// an SM, 0.027 at two; scripts/probe_groupnorm.py, NVIDIA H100 80GB HBM3,
// 700 W). Cluster sizes above 8 are non-portable: the plan takes 16 only
// where 8 CTAs cannot hold a band.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 512;
constexpr int kMaxCluster = 16;

template <typename T>
struct Vec8;  // 8 elements of T as one 16-byte (bf16) or two (fp32) accesses

template <>
struct Vec8<bf16> {
  __device__ static void load(const bf16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  __device__ static void store(bf16* p, const float (&v)[8]) {
    uint4 u;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Vec8<float> {
  __device__ static void load(const float* p, float (&v)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ static void store(float* p, const float (&v)[8]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
};

struct Args {
  const void* x;      // [B, P, C]
  const void* gamma;  // [C], bf16 or fp32
  const void* beta;   // [C], gamma's type
  void* out;          // [B, P, C], x's type
  int P, C, cg;       // pixels, channels, channels a group
  int k, band, per;   // groups a band, channels a band (k cg), pixels a CTA
  float inv_n, eps;
  int silu, gb_bf16;
};

// The shared-memory carve-up of a CTA (offsets in bytes): the tile
// [per, band] of x (resident only), the rows' sums [rows, 2, band], the
// group partials [2, k] (read by the cluster), every rank's partials
// [kMaxCluster, 2, k], gamma and beta [2, band], the groups' mean and
// rsqrt(var + eps) [2, k] and the scale and shift [2, band], all but the
// tile fp32 (ops/kernels/groupnorm.py::gn_smem_bytes mirrors it).
struct Layout {
  int rows, tile, red, part, ranks, gb, mi, ss, bytes;
  __host__ __device__ Layout(int per, int band, int k, int elem, bool resident) {
    const int slots = band / 8;
    rows = slots >= kThreads ? 1 : kThreads / slots;
    tile = 0;
    red = resident ? (per * band * elem + 15) / 16 * 16 : 0;
    part = red + rows * 2 * band * 4;
    ranks = part + 2 * k * 4;
    gb = ranks + kMaxCluster * 2 * k * 4;
    mi = gb + 2 * band * 4;
    ss = mi + 2 * k * 4;
    bytes = ss + 2 * band * 4;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float at `local` in the shared memory of CTA `rank` of the cluster.
__device__ __forceinline__ float load_rank(const float* local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ float param(const void* p, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

extern __shared__ __align__(16) uint8_t gn_smem[];

template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads) gn_silu_cluster_kernel(const Args a) {
  const int cs = gridDim.x, rank = blockIdx.x;  // cluster dims (gridDim.x, 1, 1)
  const int b = blockIdx.z, c0 = blockIdx.y * a.band;
  const int p0 = rank * a.per, n_px = max(0, min(a.per, a.P - p0));
  const Layout L(a.per, a.band, a.k, (int)sizeof(T), kResident);
  T* tile = reinterpret_cast<T*>(gn_smem + L.tile);
  float* red = reinterpret_cast<float*>(gn_smem + L.red);
  float* ranks = reinterpret_cast<float*>(gn_smem + L.ranks);
  float* part = reinterpret_cast<float*>(gn_smem + L.part);
  float* gb = reinterpret_cast<float*>(gn_smem + L.gb);
  float* mi = reinterpret_cast<float*>(gn_smem + L.mi);
  float* ss = reinterpret_cast<float*>(gn_smem + L.ss);
  const int slots = a.band / 8;
  const T* x = static_cast<const T*>(a.x) + ((long long)b * a.P + p0) * a.C + c0;
  T* out = static_cast<T*>(a.out) + ((long long)b * a.P + p0) * a.C + c0;

  // 1. the tile, 16 bytes a copy, consecutive threads on consecutive bytes
  if constexpr (kResident) {
    const int chunks = a.band * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n_px * chunks; i += kThreads) {
      const int p = i / chunks, ch = i - p * chunks;
      cp_async_16(reinterpret_cast<uint8_t*>(tile) + ((long long)p * a.band) * sizeof(T) + ch * 16,
                  reinterpret_cast<const uint8_t*>(x + (long long)p * a.C) + ch * 16);
    }
  }
  // gamma and beta of the band while the tile is on its way
  for (int i = threadIdx.x; i < a.band; i += kThreads) {
    gb[i] = param(a.gamma, c0 + i, a.gb_bf16);
    gb[a.band + i] = param(a.beta, c0 + i, a.gb_bf16);
  }
  if constexpr (kResident) {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();
  auto load8 = [&](int p, int slot, float (&v)[8]) {
    if constexpr (kResident) {
      Vec8<T>::load(tile + p * a.band + 8 * slot, v);
    } else {
      Vec8<T>::load(x + (long long)p * a.C + 8 * slot, v);
    }
  };

  // 2. per-channel sums of x and x^2: each row's pixels in order, then the
  // rows in order, then each group's channels in order
  const int rows = L.rows;
  const int row = threadIdx.x / (slots >= kThreads ? kThreads : slots);
  if (row < rows) {
    for (int slot = threadIdx.x % (slots >= kThreads ? kThreads : slots); slot < slots;
         slot += kThreads) {
      float s[8], q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
      for (int p = row; p < n_px; p += rows) {
        float v[8];
        load8(p, slot, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j] = __fadd_rn(s[j], v[j]);
          q[j] = __fadd_rn(q[j], __fmul_rn(v[j], v[j]));
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        red[row * 2 * a.band + 8 * slot + j] = s[j];
        red[row * 2 * a.band + a.band + 8 * slot + j] = q[j];
      }
    }
  }
  __syncthreads();
  // the rows' sums by a pairwise tree: row r += row r + h for r < n - h,
  // h = ceil(n / 2), until one row is left (row 0: the channel sums)
  for (int n = rows; n > 1;) {
    const int h = (n + 1) / 2, stride = h * 2 * a.band;
    for (int i = threadIdx.x; i < (n - h) * 2 * a.band; i += kThreads) {
      red[i] = __fadd_rn(red[i], red[i + stride]);
    }
    __syncthreads();
    n = h;
  }
  for (int i = threadIdx.x; i < 2 * a.k; i += kThreads) {
    const int which = i / a.k, g = i - which * a.k;
    const float* src = red + which * a.band + g * a.cg;
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < a.cg; ++j) acc = __fadd_rn(acc, src[j]);
    part[i] = acc;
  }

  // 3. the cluster's sums: every rank's partials gathered into this CTA's
  // shared memory (all the remote loads in flight at once), then each
  // group's added in rank order
  cluster_arrive();
  cluster_wait();
  for (int i = threadIdx.x; i < cs * 2 * a.k; i += kThreads) {
    const int r = i / (2 * a.k);
    ranks[i] = load_rank(part + (i - r * 2 * a.k), (uint32_t)r);
  }
  cluster_arrive();  // this thread's reads of the others' partials are done
  __syncthreads();
  for (int g = threadIdx.x; g < a.k; g += kThreads) {
    float s = 0.f, q = 0.f;
    for (int r = 0; r < cs; ++r) {
      s = __fadd_rn(s, ranks[r * 2 * a.k + g]);
      q = __fadd_rn(q, ranks[r * 2 * a.k + a.k + g]);
    }
    const float mean = __fmul_rn(s, a.inv_n);
    const float ex2 = __fmul_rn(q, a.inv_n);
    mi[g] = mean;
    mi[a.k + g] = rsqrtf(__fadd_rn(__fsub_rn(ex2, __fmul_rn(mean, mean)), a.eps));
  }
  __syncthreads();
  // 4. the band's per-channel scale and shift
  for (int c = threadIdx.x; c < a.band; c += kThreads) {
    const int g = c / a.cg;
    const float scale = __fmul_rn(mi[a.k + g], gb[c]);
    ss[c] = scale;
    ss[a.band + c] = __fsub_rn(gb[a.band + c], __fmul_rn(mi[g], scale));
  }
  __syncthreads();

  // 5. normalize, SiLU, store
  for (int i = threadIdx.x; i < n_px * slots; i += kThreads) {
    const int p = i / slots, slot = i - p * slots, cb = 8 * slot;
    float v[8];
    load8(p, slot, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float y = __fadd_rn(__fmul_rn(v[j], ss[cb + j]), ss[a.band + cb + j]);
      if (a.silu) y = __fdividef(y, __fadd_rn(1.f, __expf(-y)));
      v[j] = y;
    }
    Vec8<T>::store(out + (long long)p * a.C + cb, v);
  }
  cluster_wait();
}

// The largest dynamic shared memory each kernel instance has been allowed
// on each device (the attribute is set once per size class, not per call).
template <typename T, bool kResident>
cudaError_t allow(int smem, int cluster) {
  static std::atomic<int> allowed[64];
  static std::atomic<bool> nonportable[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  auto kernel = gn_silu_cluster_kernel<T, kResident>;
  if (smem > allowed[dev].load()) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed[dev].store(smem);
  }
  if (cluster > 8 && !nonportable[dev].load()) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    nonportable[dev].store(true);
  }
  return cudaSuccess;
}

template <typename T, bool kResident>
cudaError_t launch(const Args& a, int B, int bands, int cluster, cudaStream_t st) {
  const Layout L(a.per, a.band, a.k, (int)sizeof(T), kResident);
  cudaError_t err = allow<T, kResident>(L.bytes, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)bands, (unsigned)B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)L.bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gn_silu_cluster_kernel<T, kResident>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x and out [B, P, C] (P = H * W), bf16 or fp32, contiguous, 16-byte
// aligned; gamma, beta [C], bf16 or fp32 (both one type). plan: the int
// array [B, P, C, G, k, cluster, per, resident, silu, x_bf16, gb_bf16] of
// ops/kernels/groupnorm.py::gn_plan (k groups a band, C / G * k a multiple
// of 8; per pixels a CTA, cluster CTAs a cluster, their pixels covering P).
// Returns the launch's CUDA error.
extern "C" int d3r_group_norm_silu(const void* x, const void* gamma, const void* beta, void* out,
                                   const int* plan, float inv_n, float eps, void* stream) {
  const int B = plan[0], P = plan[1], C = plan[2], G = plan[3], k = plan[4];
  const int cluster = plan[5], per = plan[6], resident = plan[7];
  if (B <= 0 || P <= 0 || C <= 0 || G <= 0 || C % G != 0 || k <= 0 || G % k != 0 ||
      (C / G * k) % 8 != 0 || cluster < 1 || cluster > kMaxCluster || per <= 0 ||
      (long long)per * cluster < P || (long long)per * (cluster - 1) >= P ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{x, gamma, beta, out, P, C, C / G, k, C / G * k, per, inv_n, eps, plan[8], plan[10]};
  const int bands = G / k;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (plan[9]) {
    err = resident ? launch<bf16, true>(a, B, bands, cluster, st)
                   : launch<bf16, false>(a, B, bands, cluster, st);
  } else {
    err = resident ? launch<float, true>(a, B, bands, cluster, st)
                   : launch<float, false>(a, B, bands, cluster, st);
  }
  return (int)err;
}
