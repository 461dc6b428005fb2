// Fused GEGLU feed-forward for Hopper (sm_90a), bf16 in and out:
//   out = ((x @ W1h + b1h) * gelu_tanh(x @ W1g + b1g)) @ W2 + b2
//
// Replaces: d3roma_tpu/ops/pallas/geglu.py::geglu_ff, its bf16 path (kernel
// body _kernel_bf16). That TPU kernel keeps a [blk_rows, C] fp32 accumulator
// (512 or 2048 rows) in VMEM and walks the hidden axis F in column chunks, so
// the [rows, F] intermediate never exists in device memory.
//
// What bounds it on the H100: operations. Per row it does 6*C*F flops
// (2*C*F for each of h, gate and the output product) against the weights,
// which are read once per row tile; at the flagship widths (C, F) =
// (320, 1280), (640, 2560), (1280, 5120) the products dominate.
//
// Design: one block of 8 warps per (tile of 32 rows, chunk of Cb output
// columns, range of F). The fp32 accumulator [32, Cb] lives in shared memory,
// initialised with b2. A [64, 1280] fp32 accumulator would be 320 KB, beyond
// the 227 KB a block can use; with 32 rows and Cb <= 640 it is at most 82 KB.
// So the launcher takes Cb = C for C <= 640 and splits wider C into Cb-wide
// chunks (C = 1280 -> two chunks), each block recomputing the h/gate chunk
// for its own columns: a recompute factor of C / Cb on the first product (1
// at C = 320 and 640, 2 at C = 1280). The block walks F in chunks of 64:
//   1. h and gate [32, 64] = x @ W1h/W1g over C in chunks of 64, on the
//      tensor cores (WMMA bf16 16x16x16, fp32 accumulation in registers);
//   2. y = (h + b1h) * gelu_tanh(gate + b1g) in fp32, cast to bf16 (the input
//      type) into shared memory;
//   3. acc[32, Cb] += y @ W2[chunk, Cb], again on the tensor cores.
// The [rows, F] intermediate thus never leaves shared memory. The output is
// cast to bf16 once, at the end. The x, W1 and W2 chunks arrive by cp.async
// into two stage buffers that take turns, so the next chunk's loads overlap
// this chunk's products. Shared memory at Cb = 640: 82 KB accumulator +
// 22 KB of h, gate and y + 2 x 23 KB stages = 150 KB (one block per SM); at
// Cb = 320, 110 KB (two blocks per SM).
//
// Few rows (the 240- and 60-token levels: 480 and 120 rows at batch 2) give
// too few (row tile, column chunk) blocks to fill the card, and each walks
// all of F. There the hidden axis F is split across blocks as well:
// d3r_geglu_ff_splits picks the number of splits S (a divisor of F / 64)
// from the SM count and this kernel's occupancy, each block accumulates its
// F range from zero into an fp32 workspace [S, rows, C], and a second small
// kernel adds b2 and the S partial sums in a fixed order and casts once. The
// intermediate still never leaves the chip; the workspace holds only
// [rows, C] partial outputs.
//
// Numerics: as the TPU kernel: fp32 h and gate plus fp32 biases, gelu in its
// tanh form, the gated product cast to the input type before the second
// product, fp32 accumulation of that product with b2, one cast at the end.
// Only the order of the fp32 sums differs (and is fixed: results do not vary
// from run to run).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kRows = 32;   // rows per block
constexpr int kFc = 64;     // hidden (F) chunk
constexpr int kKc = 64;     // C chunk of the first product
constexpr int kNc = 64;     // output-column chunk of the second product
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCb = 640;
constexpr int kPadH = 8;    // bf16 row padding, elements
constexpr int kPadF = 4;    // fp32 row padding, elements
constexpr int kLdx = kKc + kPadH;
constexpr int kLdw1 = kFc + kPadH;
constexpr int kLdhg = kFc + kPadF;
constexpr int kLdy = kFc + kPadH;
constexpr int kLdw2 = kNc + kPadH;

// Shared-memory carve-up for an output chunk of cb columns. Two stage
// buffers take turns: a first-product stage holds an x chunk [32, 64] and
// W1h/W1g chunks [64, 64]; a second-product stage holds a W2 chunk [64, 64].
// Every region starts on a 32-byte boundary, as WMMA loads and stores require.
constexpr size_t kStageX = 0;
constexpr size_t kStageW1h = kStageX + sizeof(bf16) * kRows * kLdx;
constexpr size_t kStageW1g = kStageW1h + sizeof(bf16) * kKc * kLdw1;
constexpr size_t kStageBytes = kStageW1g + sizeof(bf16) * kKc * kLdw1;
static_assert(sizeof(bf16) * kFc * kLdw2 <= kStageBytes, "a W2 chunk fits a stage");

struct Layout {
  int ld_acc;
  size_t acc, h, g, y, stage, bytes;
  __host__ __device__ explicit Layout(int cb) {
    ld_acc = cb + kPadF;
    acc = 0;
    h = acc + sizeof(float) * kRows * ld_acc;
    g = h + sizeof(float) * kRows * kLdhg;
    y = g + sizeof(float) * kRows * kLdhg;
    stage = y + sizeof(bf16) * kRows * kLdy;
    bytes = stage + 2 * kStageBytes;
  }
};

__device__ __forceinline__ float gelu_tanh(float g) {
  return 0.5f * g * (1.f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
}

// 16-byte global -> shared copy; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The block's work is one sequence of stages: for each 64-wide chunk of its
// F range, ceil(C / 64) first-product stages then ceil(cb / 64)
// second-product stages. Stage idx + 1 is copied in (cp.async) while stage
// idx computes.
struct Stages {
  const bf16* x;
  const bf16* w1h;
  const bf16* w1g;
  const bf16* w2;
  int rows, C, F, cb, row0, c0, f_begin, k_stages, per_chunk;

  __device__ void fetch(unsigned char* buf, int idx) const {
    const int f0 = f_begin + (idx / per_chunk) * kFc;
    const int st = idx % per_chunk;
    if (st < k_stages) {
      const int k0 = st * kKc;
      bf16* xs = reinterpret_cast<bf16*>(buf + kStageX);
      bf16* w1hs = reinterpret_cast<bf16*>(buf + kStageW1h);
      bf16* w1gs = reinterpret_cast<bf16*>(buf + kStageW1g);
      for (int i = threadIdx.x; i < kRows * kKc / 8; i += kThreads) {
        const int r = i / (kKc / 8);
        const int c = (i % (kKc / 8)) * 8;
        const bool ok = row0 + r < rows && k0 + c < C;
        cp_async_16(xs + r * kLdx + c, ok ? x + (long long)(row0 + r) * C + k0 + c : x,
                    ok ? 16 : 0);
      }
      for (int i = threadIdx.x; i < kKc * kFc / 8; i += kThreads) {
        const int r = i / (kFc / 8);
        const int c = (i % (kFc / 8)) * 8;
        const bool ok = k0 + r < C;
        const long long off = ok ? (long long)(k0 + r) * F + f0 + c : 0;
        cp_async_16(w1hs + r * kLdw1 + c, w1h + off, ok ? 16 : 0);
        cp_async_16(w1gs + r * kLdw1 + c, w1g + off, ok ? 16 : 0);
      }
    } else {
      const int n0 = (st - k_stages) * kNc;
      const int nw = min(kNc, cb - n0);
      bf16* w2s = reinterpret_cast<bf16*>(buf);
      for (int i = threadIdx.x; i < kFc * nw / 8; i += kThreads) {
        const int r = i / (nw / 8);
        const int c = (i % (nw / 8)) * 8;
        cp_async_16(w2s + r * kLdw2 + c, w2 + (long long)(f0 + r) * C + c0 + n0 + c, 16);
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads)
geglu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1h,
             const bf16* __restrict__ w1g, const bf16* __restrict__ w2,
             const float* __restrict__ b1h, const float* __restrict__ b1g,
             const float* __restrict__ b2, bf16* __restrict__ out,
             float* __restrict__ partial, int rows, int C, int cb, int f_per_split) {
  const Layout L(cb);
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* hs = reinterpret_cast<float*>(smem + L.h);
  float* gs = reinterpret_cast<float*>(smem + L.g);
  bf16* ys = reinterpret_cast<bf16*>(smem + L.y);

  const int warp = threadIdx.x / 32;
  const int tm = warp / 4;  // this warp's 16x16 tile of the [32, 64] h/gate chunk
  const int tn = warp % 4;
  const int k_stages = (C + kKc - 1) / kKc;
  const Stages stages{x, w1h, w1g, w2, rows, C, f_per_split * (int)gridDim.z, cb,
                      (int)blockIdx.x * kRows, (int)blockIdx.y * cb,
                      (int)blockIdx.z * f_per_split, k_stages,
                      k_stages + (cb + kNc - 1) / kNc};
  const int total = (f_per_split / kFc) * stages.per_chunk;

  // a split block sums its F range from zero; b2 joins in geglu_reduce
  for (int i = threadIdx.x; i < kRows * cb; i += kThreads) {
    acc[(i / cb) * L.ld_acc + i % cb] = partial ? 0.f : b2[stages.c0 + i % cb];
  }

  stages.fetch(smem + L.stage, 0);
  cp_async_commit();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> hf, gf;
  for (int idx = 0; idx < total; ++idx) {
    unsigned char* buf = smem + L.stage + (idx & 1) * kStageBytes;
    if (idx + 1 < total) {
      stages.fetch(smem + L.stage + ((idx + 1) & 1) * kStageBytes, idx + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int f0 = stages.f_begin + (idx / stages.per_chunk) * kFc;
    const int st = idx % stages.per_chunk;
    if (st < k_stages) {
      // 1. h and gate [32, 64] for hidden columns [f0, f0 + 64), this C chunk.
      const bf16* xs = reinterpret_cast<const bf16*>(buf + kStageX);
      const bf16* w1hs = reinterpret_cast<const bf16*>(buf + kStageW1h);
      const bf16* w1gs = reinterpret_cast<const bf16*>(buf + kStageW1g);
      if (st == 0) {
        wmma::fill_fragment(hf, 0.f);
        wmma::fill_fragment(gf, 0.f);
      }
#pragma unroll
      for (int kk = 0; kk < kKc / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
        wmma::load_matrix_sync(af, xs + tm * 16 * kLdx + kk * 16, kLdx);
        wmma::load_matrix_sync(bf, w1hs + kk * 16 * kLdw1 + tn * 16, kLdw1);
        wmma::mma_sync(hf, af, bf, hf);
        wmma::load_matrix_sync(bf, w1gs + kk * 16 * kLdw1 + tn * 16, kLdw1);
        wmma::mma_sync(gf, af, bf, gf);
      }
      if (st == k_stages - 1) {
        // 2. The gated product, cast to the input type.
        wmma::store_matrix_sync(hs + tm * 16 * kLdhg + tn * 16, hf, kLdhg, wmma::mem_row_major);
        wmma::store_matrix_sync(gs + tm * 16 * kLdhg + tn * 16, gf, kLdhg, wmma::mem_row_major);
        __syncthreads();
        for (int i = threadIdx.x; i < kRows * kFc; i += kThreads) {
          const int r = i / kFc;
          const int c = i % kFc;
          const float hv = hs[r * kLdhg + c] + b1h[f0 + c];
          const float gv = gs[r * kLdhg + c] + b1g[f0 + c];
          ys[r * kLdy + c] = __float2bfloat16(hv * gelu_tanh(gv));
        }
      }
    } else {
      // 3. acc[:, n0:n0+64] += y @ W2[f0:f0+64, c0+n0:c0+n0+64].
      const bf16* w2s = reinterpret_cast<const bf16*>(buf);
      const int n0 = (st - k_stages) * kNc;
      const int tiles_n = min(kNc, cb - n0) / 16;
      for (int t = warp; t < (kRows / 16) * tiles_n; t += kWarps) {
        const int tr = t / tiles_n;
        const int tc = t % tiles_n;
        float* tile = acc + tr * 16 * L.ld_acc + n0 + tc * 16;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
        wmma::load_matrix_sync(of, tile, L.ld_acc, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kFc / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
          wmma::load_matrix_sync(af, ys + tr * 16 * kLdy + kk * 16, kLdy);
          wmma::load_matrix_sync(bf, w2s + kk * 16 * kLdw2 + tc * 16, kLdw2);
          wmma::mma_sync(of, af, bf, of);
        }
        wmma::store_matrix_sync(tile, of, L.ld_acc, wmma::mem_row_major);
      }
    }
    __syncthreads();  // stage idx + 2 overwrites this buffer
  }

  for (int i = threadIdx.x; i < kRows * cb; i += kThreads) {
    const int r = i / cb;
    const int c = i % cb;
    if (stages.row0 + r < rows) {
      const long long o = (long long)(stages.row0 + r) * C + stages.c0 + c;
      if (partial) {
        partial[(long long)blockIdx.z * rows * C + o] = acc[r * L.ld_acc + c];
      } else {
        out[o] = __float2bfloat16(acc[r * L.ld_acc + c]);
      }
    }
  }
}

// out = b2 + the splits' partial sums, added in split order, cast once.
__global__ void geglu_reduce(const float* __restrict__ partial,
                             const float* __restrict__ b2, bf16* __restrict__ out,
                             long long n, int C, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = b2[i % C];
  for (int s = 0; s < splits; ++s) v += partial[s * n + i];
  out[i] = __float2bfloat16(v);
}

bool shape_ok(int rows, int C, int F, int cb) {
  return rows > 0 && C > 0 && F > 0 && C % 16 == 0 && F % kFc == 0 && cb > 0 &&
         cb % 16 == 0 && C % cb == 0 && cb <= kMaxCb;
}

}  // namespace

// How many blocks share the hidden axis F. A wave is the number of blocks
// the card runs at once (SMs x this kernel's occupancy at this cb); the
// unsplit grid has ceil(rows / 32) * (C / cb) blocks. If that fills at least
// half a wave, no split (a split adds partial-sum traffic and a reduce);
// otherwise the largest divisor S of F / 64 whose grid still fits one wave.
// Returns S, or a negative CUDA error code.
extern "C" int d3r_geglu_ff_splits(int rows, int C, int F, int cb) {
  if (!shape_ok(rows, C, F, cb)) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  const Layout L(cb);
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(geglu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L.bytes);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, geglu_kernel, kThreads,
                                                        L.bytes);
  }
  if (err != cudaSuccess) return -(int)err;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long base = (long long)((rows + kRows - 1) / kRows) * (C / cb);
  int best = 1;
  if (2 * base < slots) {
    for (int s = 2; s <= F / kFc; ++s) {
      if ((F / kFc) % s == 0 && base * s <= slots) best = s;
    }
  }
  return best;
}

// x [rows, C], w1h and w1g [C, F], w2 [F, C], out [rows, C]: bf16, contiguous,
// 16-byte aligned; b1h, b1g [F] and b2 [C]: fp32. C % 16 == 0, F % 64 == 0;
// cb (output columns per block) is a multiple of 16 dividing C, <= 640.
// splits (from d3r_geglu_ff_splits) divides F / 64; with splits > 1,
// workspace is fp32 [splits, rows, C] scratch. Returns cudaGetLastError().
extern "C" int d3r_geglu_ff_bf16(const void* x, const void* w1h, const void* w1g,
                                 const void* w2, const void* b1h, const void* b1g,
                                 const void* b2, void* out, void* workspace, int rows,
                                 int C, int F, int cb, int splits, void* stream) {
  if (!shape_ok(rows, C, F, cb) || splits < 1 || (F / kFc) % splits != 0 ||
      (splits > 1 && workspace == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L(cb);
  cudaError_t err = cudaFuncSetAttribute(
      geglu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  auto* partial = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  const dim3 grid((rows + kRows - 1) / kRows, C / cb, splits);
  geglu_kernel<<<grid, kThreads, L.bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1h),
      static_cast<const bf16*>(w1g), static_cast<const bf16*>(w2),
      static_cast<const float*>(b1h), static_cast<const float*>(b1g),
      static_cast<const float*>(b2), static_cast<bf16*>(out), partial, rows, C, cb,
      F / splits);
  if (partial) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long n = (long long)rows * C;
    geglu_reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        partial, static_cast<const float*>(b2), static_cast<bf16*>(out), n, C, splits);
  }
  return (int)cudaGetLastError();
}
