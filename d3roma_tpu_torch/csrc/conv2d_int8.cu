// int8 implicit-GEMM convolution for Hopper (sm_90a), NHWC, with the
// dequantization and the bias in the epilogue:
//   out[b, oy, ox, co] = bf16(bf16(deq(acc)) + bias[co])   (bf16 output), or
//   out[b, oy, ox, co] = deq(acc)                          (fp32 output, no bias)
//   acc = sum over (ky, kx, ci) of xq[b, oy*s + ky - pt, ox*s + kx - pl, ci]
//                                  * wq[co, ky, kx, ci]          (exact int32)
// in one of three epilogues, each the order of arithmetic of one reference:
//   "xla"  (0): deq = (acc * act_scale) * ws[co], the XLA int8 convolution of
//               the JAX package's quant="static" mode
//               (ops/quant.py::int8_conv_general_dilated_static);
//   "tpu"  (1): deq = acc * (act_scale * ws[co]), the Pallas kernels
//               conv2d.py::conv3x3_flat (_kernel_int8, quant="mxu") and
//               conv2d.py::conv3x3_rowtap (_kernel_rowtap_int8);
//   "halo" (2): as "tpu", but the sum is taken as conv2d_halo.py::_kernel
//               takes it: one exact int32 partial per row of taps (ky), each
//               converted to fp32 and added to an fp32 sum in ky order. It
//               differs from "tpu" once a partial or the sum passes 2^24.
//
// Replaces: d3roma_tpu/ops/pallas/conv2d.py::conv3x3_flat, its int8 path
// (kernel body _kernel_int8), conv2d.py::conv3x3_rowtap and
// conv2d_halo.py::conv3x3_halo (int8 body), and with them the XLA int8
// convolution and dot that the JAX package's static modes run at every
// other quantized site: the 3x3 stride-1 convs of the resnets and
// upsamplers, the stride-2 downsamplers (UNet: padding 1; VAE: padding
// (0, 1) and VALID), the 1x1 conv_shortcut, and every int8 dense layer (a
// 1x1 convolution over its rows, ops/quant.py::int8_linear). All compute
// the same integers: per-output-channel weight scales over all KH*KW*Cin
// taps (zero channels that the TPU kernels pad on change neither the
// scales nor the sums), activations quantized with one static scale (the
// entry point's quantize launch), exact int32 sums. The TPU kernels hold a whole
// padded frame (or a window of rows) in VMEM and run the taps as
// row-shifted GEMMs; a Hopper block cannot hold a frame (the VAE's
// full-resolution frames are 29 MB each), so the kernel loads, per k step,
// the tap-shifted box of its output tile's pixels (implicit GEMM).
//
// What bounds it on the H100: operations at the UNet's 3x3 sites (each
// input element takes part in 2*Cout*KH*KW/stride^2 operations, thousands,
// against the ~590 operations per byte where the int8 tensor cores, 1979
// TOP/s, become the limit); bytes at the VAE's full-resolution 128-channel
// sites and the 1x1 shortcuts, and at the dense layers below ~600 rows.
//
// Design: sm90_conv.cuh, the TMA + int8 wgmma implicit GEMM of the port's
// convolutions (4D pixel-box maps of x, a 3D map of w, persistent blocks,
// a K split with exact int32 partials where tiles are few); the epilogue is
// a template parameter of its kernel (conv_int8_sm90_kernel<epilogue, N>),
// "halo" keeping a second, fp32 accumulator. The tiles and the split come
// from the wrapper's plan (ops/kernels/conv2d.py::conv_plan). The entry
// point quantizes x itself (act_quantize.cuh) into the wrapper's int8
// workspace and launches the tiles as a dependent launch on that quantize
// (pdl.cuh): one host call per convolution or dense layer.
//
// The dynamic int8 modes (quant=True / "all" / "dense": the XLA int8
// convolution and dot of d3roma_tpu/ops/quant.py::int8_conv_general_dilated
// and int8_dot_general, which have no Pallas kernel) take the second entry
// point: the scale of each batch item (convolution) or row (dense) is its
// absmax / 127, computed on the device, and the "xla" epilogue dequantizes
// each output row at its group's scale, (acc * s[g]) * ws[co]. The scales
// never leave the device and nothing is zeroed first. What bounds these
// calls on the H100 is the host at the small sites (a launch costs the host
// more than the device's work: the dense layers below ~2000 rows, the
// UNet's convolutions at batch 2) and bytes at the VAE's, so the design cuts
// launches and passes over x. A call is one of four routes, which the host's
// plan picks per site (ops/kernels/conv2d.py::dynamic_plan):
//   dense, rows <= 64:  one launch (dense::small below);
//   dense:              the row quantize (act_quantize.cuh, one read of x,
//                       x's int8 copy and each row's absmax), then the GEMM;
//   conv 1x1, stride 2: the absmax into per-(item, chunk) slots, then the
//                       conv quantizing bf16 x in its loader
//                       (sm90_conv.cuh, kLoadQ);
//   conv 3x3 stride 1:  the slots, the quantize at the items' scales into
//                       x's int8 copy, then the conv;
// each kernel after the first a dependent launch on the one before
// (pdl.cuh), a split of K adding its sum.

#include "act_quantize.cuh"
#include "sm90_conv.cuh"

// x [B, H, W, Cin] bf16, quantized at act_scale into xq (int8 workspace of
// B H W Cin bytes, 16-byte aligned), w [Cout, KH, KW, Cin] int8, ws [Cout]
// fp32, bias [Cout] bf16 or null, out [B, OH, OW, Cout] bf16 (fp32 with
// out_f32, then bias null); all contiguous, all but x 16-byte aligned. Cin % 32 == 0, Cout % 2 ==
// 0. shape: the int array of sm90_conv.cuh's call_of, [B, H, W, Cin, OH, OW,
// Cout, KH, KW, stride, pad_t, pad_l, bw, bh, bb, bn, splits, per, epilogue,
// out_f32], with the plan's output box bw x bh x bb, bn output channels a
// tile and K in `splits` splits of `per` k steps, and epilogue 0 "xla", 1
// "tpu", 2 "halo" (see the top of this file). partial: [splits, B OH OW,
// Cout] int32 (fp32 for "halo") scratch when splits > 1. Returns the first
// CUDA error of the quantize and the conv's launches.
extern "C" int d3r_conv2d_int8(const void* x, void* xq, const void* w, const void* ws,
                               const void* bias, void* out, void* partial, const int* shape,
                               float act_scale, void* stream) {
  const int epilogue = shape[18];
  if (epilogue < d3r::conv::kXla || epilogue > d3r::conv::kHalo ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)shape[0] * shape[1] * shape[2] * shape[3];
  const cudaError_t err = d3r::actq::quantize(x, xq, n, true, act_scale, st);
  if (err != cudaSuccess) return (int)err;
  d3r::conv::Call c = d3r::conv::call_of(xq, w, shape);
  c.ws = static_cast<const float*>(ws);
  c.bias = static_cast<const __nv_bfloat16*>(bias);
  c.out = out;
  c.partial = partial;
  c.act_scale = act_scale;
  return (int)d3r::conv::run<int8_t>(c, epilogue, st);
}

// ------------------------------------------------------- the dynamic modes
//
// The small dense layers (rows <= 64: the cross-attention's key and value
// projections of the 2-token context, the time-embedding layers) in one
// launch: a block owns kSmallBN output columns of every row. Thread 0 issues
// the TMA loads of the block's whole weight slice (K x kSmallBN, 128-byte
// boxes, one mbarrier) first; meanwhile each of the block's eight warps
// takes rows w, w + 8, ...: it holds the row in registers (K <= 2048: at
// most eight 16-byte vectors a lane, all loads in flight at once), reduces
// its absmax, forms the scale and writes the int8 row into the A tiles in
// shared memory as TMA would have written them (64 rows x 128 bytes a k
// step, the 16-byte chunk c of row r at c ^ (r % 8)); the stores are fenced
// for the async proxy and the block syncs; the first warpgroup then runs
// the wgmmas over all of K from shared memory and the epilogue dequantizes
// each row at its scale. Every block quantizes the rows again (at most 64 x
// 2048 elements, from L2): no workspace, no second launch, no split of K.
namespace d3r {
namespace dense {

constexpr int kSmallRows = 64;  // one wgmma M
constexpr int kSmallBN = 32;
constexpr int kSmallThreads = 256;  // the quantize's warps; the first 128 run the wgmmas
constexpr int kSmallVecs = 8;       // 16-byte vectors of a row a lane: K <= 2048

struct Small {
  const __nv_bfloat16* x;  // [rows, k], 16-byte aligned
  int rows, k, n, k_steps;
  const float* ws;
  const __nv_bfloat16* bias;  // or null
  __nv_bfloat16* out;         // [rows, n]
};

// Dynamic shared memory of a call with k_steps k steps: the A and B tiles
// (1024-aligned), the rows' scales, the mbarrier.
inline size_t small_smem_bytes(int k_steps) {
  return 1024 + (size_t)k_steps * (kSmallRows + kSmallBN) * sm90::kKBytes + kSmallRows * 4 + 8;
}

__global__ void __launch_bounds__(kSmallThreads, 1)
    dense_small_int8_kernel(const __grid_constant__ CUtensorMap w_map, const Small a) {
  extern __shared__ __align__(16) uint8_t small_smem[];
  constexpr int kATile = kSmallRows * sm90::kKBytes, kBTile = kSmallBN * sm90::kKBytes;
  uint8_t* at = small_smem + ((1024 - (sm90::smem_u32(small_smem) & 1023)) & 1023);
  uint8_t* bt = at + a.k_steps * kATile;
  float* scale = reinterpret_cast<float*>(bt + a.k_steps * kBTile);
  uint64_t* bar = reinterpret_cast<uint64_t*>(scale + kSmallRows);
  const int t = threadIdx.x, n0 = blockIdx.x * kSmallBN;
  if (t == 0) {
    sm90::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm90::prefetch_map(&w_map);
  }
  __syncthreads();
  if (t == 0) {
    sm90::mbar_expect_tx(bar, (uint32_t)(a.k_steps * kBTile));
    for (int ks = 0; ks < a.k_steps; ++ks) {
      sm90::tma_load_3d(bt + ks * kBTile, &w_map, bar, ks * sm90::kKBytes, 0, n0);
    }
  }
  const int lane = t % 32, nv = a.k / 8;
  for (int r = t / 32; r < a.rows; r += kSmallThreads / 32) {
    const uint4* src = reinterpret_cast<const uint4*>(a.x + (long long)r * a.k);
    uint4 v[kSmallVecs];
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < kSmallVecs; ++j) {
      const int i = lane + 32 * j;
      v[j] = i < nv ? src[i] : make_uint4(0u, 0u, 0u, 0u);
      m = actq::absmax8(v[j], m);
    }
    m = actq::warp_max(m);
    const float sc = actq::group_scale(m), rc = __frcp_rn(sc);
    if (lane == 0) scale[r] = sc;
    // vector i: K positions 8i..8i+7, k step i / 16, half i % 2 of 16-byte
    // chunk (i % 16) / 2
#pragma unroll
    for (int j = 0; j < kSmallVecs; ++j) {
      const int i = lane + 32 * j;
      if (i < nv) {
        *reinterpret_cast<uint2*>(at + (i / 16) * kATile + r * sm90::kKBytes +
                                  ((((i % 16) / 2) ^ (r % 8)) << 4) + (i % 2) * 8) =
            actq::quant8(v[j], sc, rc);
      }
    }
  }
  // Rows past a.rows and the K tail of the last k step hold stale bytes:
  // the former reach only output rows that are not stored, the latter meet
  // TMA's zero fill in B.
  sm90::fence_proxy_async();
  __syncthreads();
  if (t >= 128) return;
  sm90::mbar_wait(bar, 0);
  int acc[kSmallBN / 2];
  sm90::wgmma_fence();
  for (int ks = 0; ks < a.k_steps; ++ks) {
    const uint64_t da = sm90::smem_desc(at + ks * kATile);
    const uint64_t db = sm90::smem_desc(bt + ks * kBTile);
#pragma unroll
    for (int k = 0; k < sm90::kKBytes / 32; ++k) {
      sm90::wgmma<int, kSmallBN>(acc, da + 2 * k, db + 2 * k, ks > 0 || k > 0);
    }
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_sums(acc);
#pragma unroll
  for (int j = 0; j < kSmallBN / 8; ++j) {
    const int col = n0 + sm90::frag_col(j, 0);
    if (col >= a.n) continue;
    const float w0 = a.ws[col], w1 = a.ws[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = sm90::frag_row(2 * h);
      if (row >= a.rows) continue;
      float v0 = conv::dequant<conv::kXla>(__int2float_rn(acc[4 * j + 2 * h]), scale[row], w0);
      float v1 = conv::dequant<conv::kXla>(__int2float_rn(acc[4 * j + 2 * h + 1]), scale[row], w1);
      if (a.bias != nullptr) {
        v0 = conv::add_bias(v0, __bfloat162float(a.bias[col]));
        v1 = conv::add_bias(v1, __bfloat162float(a.bias[col + 1]));
      }
      *reinterpret_cast<__nv_bfloat162*>(a.out + (long long)row * a.n + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

static cudaError_t small(const Small& a, const void* w, cudaStream_t st) {
  if (a.rows < 1 || a.rows > kSmallRows || a.k % 32 != 0 || a.k > 256 * kSmallVecs ||
      a.n % 2 != 0 || a.n < 2 ||
      a.k_steps != (a.k + sm90::kKBytes - 1) / sm90::kKBytes ||
      small_smem_bytes(a.k_steps) > 232448 || reinterpret_cast<uintptr_t>(a.x) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  static std::atomic<bool> smem_set[sm90::kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= sm90::kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev].load()) {
    err = cudaFuncSetAttribute(dense_small_int8_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    smem_set[dev].store(true);
  }
  const uint64_t dims[3] = {(uint64_t)a.k, 1, (uint64_t)a.n};
  const uint64_t strides[2] = {(uint64_t)a.k, (uint64_t)a.k};
  const uint32_t box[3] = {(uint32_t)sm90::kKBytes, 1, (uint32_t)kSmallBN};
  const uint32_t steps[3] = {1, 1, 1};
  CUtensorMap w_map;
  err = sm90::tensor_map_nd(&w_map, w, 1, 3, dims, strides, box, steps);
  if (err != cudaSuccess) return err;
  dense_small_int8_kernel<<<(a.n + kSmallBN - 1) / kSmallBN, kSmallThreads,
                            small_smem_bytes(a.k_steps), st>>>(w_map, a);
  return cudaGetLastError();
}

}  // namespace dense
}  // namespace d3r

// The dynamic-scale call: x [B, H, W, Cin] bf16 (16-byte aligned), w, ws,
// bias, out, partial and shape as d3r_conv2d_int8's (epilogue "xla"), each
// scale group of x (a batch item; a row for a dense layer, which comes as
// the 1x1 view [1, 1, rows, Cin]) quantized at its own scale, computed on
// the device. dyn: the plan's route and its parameters (ops/kernels/
// conv2d.py::dynamic_plan, which mirrors what the routes take), [route,
// group_elems, group_pixels, chunk, chunks, team, vecs, groups]:
//   0 "small":    dense, rows <= 64: one launch (dense_small_int8_kernel);
//   1 "rows":     dense: the row quantize (team threads and vecs 16-byte
//                 vectors a thread a row) into work (x's int8 copy, then one
//                 absmax a row at the next multiple of 128 bytes), then the
//                 GEMM as a dependent launch, one scale a row;
//   2 "loader":   convolution: the absmax of each of the `groups` batch
//                 items (group_elems elements, group_pixels output pixels
//                 each) into `chunks` slots a group in work, each slot
//                 `chunk` elements, then the conv quantizing bf16 x in its
//                 loader, as a dependent launch;
//   3 "separate": convolution: the slots as in "loader" behind x's int8
//                 copy in work, the quantize of x (dependent), then the conv
//                 (dependent).
// A split of K adds its sum launch. work is 16-byte aligned and reused by
// every call in stream order. Returns the first CUDA error of the launches.
extern "C" int d3r_conv2d_int8_dynamic(const void* x, void* work, const void* w, const void* ws,
                                       const void* bias, void* out, void* partial,
                                       const int* shape, const int* dyn, void* stream) {
  enum { kSmall = 0, kRows = 1, kLoader = 2, kSeparate = 3 };
  const int route = dyn[0], group_elems = dyn[1], group_pixels = dyn[2], chunk = dyn[3],
            chunks = dyn[4], team = dyn[5], vecs = dyn[6], groups = dyn[7];
  if (shape[18] != d3r::conv::kXla || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(work) % 16 != 0 || route < kSmall || route > kSeparate) {
    return (int)cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int cin = shape[3];
  const long long n = (long long)shape[0] * shape[1] * shape[2] * cin;
  if (route == kSmall) {
    d3r::dense::Small a{};
    a.x = static_cast<const __nv_bfloat16*>(x);
    a.rows = (int)(n / cin);
    a.k = cin;
    a.n = shape[6];
    a.k_steps = (cin + d3r::sm90::kKBytes - 1) / d3r::sm90::kKBytes;
    a.ws = static_cast<const float*>(ws);
    a.bias = static_cast<const __nv_bfloat16*>(bias);
    a.out = static_cast<__nv_bfloat16*>(out);
    return (int)d3r::dense::small(a, w, st);
  }
  uint8_t* base = static_cast<uint8_t*>(work);
  const long long after_xq = (n + 127) / 128 * 128;  // the slots behind x's int8 copy
  float* slots = reinterpret_cast<float*>(route == kLoader ? base : base + after_xq);
  cudaError_t err;
  if (route == kRows) {
    err = d3r::actq::quantize_rows(x, base, slots, n / cin, cin, team, vecs, st);
  } else {
    err = d3r::actq::absmax_slots(x, slots, groups, group_elems, chunk, chunks, st);
    if (err == cudaSuccess && route == kSeparate) {
      err = d3r::actq::quantize_groups(x, base, slots, n, group_elems, chunks, st);
    }
  }
  if (err != cudaSuccess) return (int)err;
  d3r::conv::Call c = d3r::conv::call_of(route == kLoader ? x : base, w, shape);
  c.ws = static_cast<const float*>(ws);
  c.bias = static_cast<const __nv_bfloat16*>(bias);
  c.out = out;
  c.partial = partial;
  c.act_scale = 0.f;
  c.act_amax = slots;
  c.group_pixels = route == kRows ? 1 : group_pixels;
  c.amax_chunks = route == kRows ? 0 : chunks;
  c.groups = route == kRows ? 0 : groups;
  c.loadq = route == kLoader;
  return (int)d3r::conv::run<int8_t>(c, d3r::conv::kXla, st);
}
