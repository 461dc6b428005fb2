// Stride-1 SAME 3x3 convolution by Winograd F(2x2, 3x3) for Hopper (sm_90a),
// NHWC, bf16 in and out:
//   per 2x2 output tile: d = the 4x4 input patch (zero outside the frame),
//   V = B^T d B in fp32, rounded to bf16; M_t = sum over c of V_t[c] U_t[c, o]
//   for the 16 taps t (bf16 products, fp32 sums); Y = A^T M A in fp32,
//   rounded to bf16; then + bias in bf16 (as Flax adds a conv's bias).
// U = G g G^T is made once per weight by the wrapper ([16, O, C] bf16).
//
// Replaces: d3roma_tpu/ops/pallas/winograd_fused.py::conv3x3_wino_fused
// (kernel body _kernel), which the JAX package's "wino_static" mode runs at
// every stride-1 3x3 conv its pick_config admits. That TPU kernel DMAs a
// window of tile rows into VMEM, keeps all 16 transformed taps V of the
// window there and runs the 16 tap GEMMs against a 128-wide block of U.
//
// What bounds it on the H100: operations. The 16 tap GEMMs do
// 2 * 16 * (H/2)(W/2) * C * O operations (2.25x fewer than the direct conv's
// 2 * 9 * H * W * C * O) against ~2 * H * W * (C + O) bytes: hundreds of
// operations per byte at the UNet's 320-640 channels, above the ~295 per
// byte where the bf16 tensor cores become the limit.
//
// Design: two launches on the caller's stream (three when the taps are
// split).
//   1. wino_input_kernel: the input transform, once per call. A thread takes
//      one tile and 4 channels: the 4x4 patch in 8-byte loads (zero outside
//      the frame: the SAME padding and the odd H or W edge), B^T d B in fp32,
//      and one 8-byte store of bf16 per tap into V [16, Mt, C] (Mt =
//      B * ceil(H/2) * ceil(W/2) tiles, C contiguous: each tap's V_t is the
//      K-major A operand of a GEMM). Memory-bound: it reads x about 4 times
//      (from L2; neighbouring patches overlap) and writes 4x x's bytes.
//   2. wino_gemm_kernel: the 16 tap GEMMs on the TMA + wgmma mainloop of
//      sm90_gemm.cuh (two consumer warpgroups, one producer, a 4-stage ring
//      of 128 bytes of C a stage, persistent blocks). A tile is 128 Winograd
//      tiles x 64 output channels (x a group of taps when split). The
//      producer walks the tile's taps and, per tap, C in boxes of 64
//      channels from two 3D maps, V (C, Mt, 16) and U (C, O, 16): a box past
//      C reads zeros, not the next tap's channels. After each tap the
//      consumers fold the tap's fp32 sums M_t into four output accumulators
//      Y[u][v] += A^T[u][x] A^T[v][y] M_t (t = 4x + y; coefficients +1, -1
//      or 0: A^T M A is linear in M). Registers: the tap's sums and the four
//      Y, 5 x 32 fp32 a thread at 64 channels (so the tile is 64 wide, not
//      128). After the last tap the epilogue rounds each Y[u][v] to bf16,
//      adds the bias, and writes output pixel (2 ty + u, 2 tx + v), staged in
//      shared memory for 16-byte stores; pixels past the odd H or W edge and
//      channels past O are not written. Tiles are ordered channel block
//      fastest, so the blocks in flight share their V rows through L2 while
//      U stays there.
//   3. Where the tiles are too few for the SMs, the host's plan
//      (ops/kernels/winograd.py::wino_plan) splits the 16 taps into 2 or 4
//      groups: each writes its fp32 Y to a partial buffer [splits, B*H*W, O]
//      and wino_reduce_kernel adds them in split order, rounds and adds the
//      bias.
// The fold adds the taps' M in tap order, and a split's partials in split
// order, where the TPU kernel adds f = (m0 + m1) + m2 per row of taps and
// then y = (f0 + f1) + f2; V, U, the bf16 products and the roundings are
// the same. The difference is fp32 rounding before the bf16 rounding of the
// output, well inside the check's 1e-2 x max |ref|.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_conv.cuh"
#include "sm90_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace sm90 = d3r::sm90;

constexpr int kBN = 64;                      // output channels of a tile
constexpr int kTaps = 16;
constexpr int kKElems = sm90::kKBytes / 2;   // channels of a k step
using Staging = d3r::conv::Smem<kBN>;        // the ring, then the output staging

// --------------------------------------------------------------------------
// 1. The input transform.

struct InArgs {
  const bf16* x;  // [B, H, W, C]
  bf16* v;        // [16, Mt, C]
  int B, H, W, C, Th, Tw, Mt;
};

__global__ void __launch_bounds__(256) wino_input_kernel(const InArgs a) {
  const int groups = a.C / 4;
  const int per_image = a.Th * a.Tw;
  const long long n = (long long)a.Mt * groups;
  const long long tap_stride = (long long)a.Mt * a.C;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int m = (int)(i / groups), c0 = (int)(i - (long long)m * groups) * 4;
    const int b = m / per_image, r = m - b * per_image;
    const int ty = r / a.Tw, tx = r - ty * a.Tw;
    const bf16* xb = a.x + (long long)b * a.H * a.W * a.C + c0;
    uint2 raw[16];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int iy = 2 * ty - 1 + p;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ix = 2 * tx - 1 + q;
        raw[p * 4 + q] = make_uint2(0u, 0u);
        if (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W) {
          raw[p * 4 + q] =
              *reinterpret_cast<const uint2*>(xb + ((long long)iy * a.W + ix) * a.C);
        }
      }
    }
    uint2 packed[16];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float d[4][4];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        d[k / 4][k % 4] = __bfloat162float(reinterpret_cast<const bf16*>(&raw[k])[c]);
      }
      float e[4][4];  // B^T over the rows of the patch: e[column][x]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        e[j][0] = __fsub_rn(d[0][j], d[2][j]);
        e[j][1] = __fadd_rn(d[1][j], d[2][j]);
        e[j][2] = __fsub_rn(d[2][j], d[1][j]);
        e[j][3] = __fsub_rn(d[1][j], d[3][j]);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float vv[4] = {__fsub_rn(e[0][x], e[2][x]), __fadd_rn(e[1][x], e[2][x]),
                             __fsub_rn(e[2][x], e[1][x]), __fsub_rn(e[1][x], e[3][x])};
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          reinterpret_cast<bf16*>(&packed[x * 4 + y])[c] = __float2bfloat16_rn(vv[y]);
        }
      }
    }
    bf16* vm = a.v + (long long)m * a.C + c0;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) *reinterpret_cast<uint2*>(vm + t * tap_stride) = packed[t];
  }
}

// --------------------------------------------------------------------------
// 2. The tap GEMMs with the output transform in the epilogue.

struct GemmArgs {
  int B, H, W, O, Th, Tw, Mt;
  int m_tiles, n_tiles, splits, taps, kc;  // taps a split, k steps a tap
  const bf16* bias;                        // [O] or null
  bf16* out;                               // [B, H, W, O]
  float* partial;                          // [splits, B*H*W, O] when split
};

struct Tile {
  int m0, n0, s;
};

// Tile t: the channel block varies fastest, then the split, then the rows.
__device__ __forceinline__ Tile tile_of(const GemmArgs& a, int t) {
  Tile r;
  r.n0 = t % a.n_tiles * kBN;
  const int rest = t / a.n_tiles;
  r.s = rest % a.splits;
  r.m0 = rest / a.splits * sm90::kBlockRows;
  return r;
}

// A^T = [[1, 1, 1, 0], [0, 1, -1, -1]]
__device__ __forceinline__ int at(int u, int x) {
  return u == 0 ? (x < 3 ? 1 : 0) : (x == 0 ? 0 : (x == 1 ? 1 : -1));
}

// The flat output pixel (b * H + oy) * W + ox of output (u, v) of Winograd
// tile m, or -1 past the last tile or the frame's odd edge.
__device__ __forceinline__ long long pixel_of(const GemmArgs& a, int m, int u, int v) {
  if (m >= a.Mt) return -1;
  const int per_image = a.Th * a.Tw;
  const int b = m / per_image, r = m - b * per_image;
  const int oy = 2 * (r / a.Tw) + u, ox = 2 * (r % a.Tw) + v;
  if (oy >= a.H || ox >= a.W) return -1;
  return ((long long)b * a.H + oy) * a.W + ox;
}

__global__ void __launch_bounds__(sm90::kThreads, 1)
    wino_gemm_kernel(const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap u_map, const GemmArgs a) {
  extern __shared__ __align__(16) uint8_t wino_smem[];
  const sm90::Stages<kBN> st(wino_smem);
  if (threadIdx.x == 0) st.init();
  __syncthreads();
  const int tiles = a.m_tiles * a.n_tiles * a.splits;
  const int wg = threadIdx.x / 128;
  if (wg == sm90::kConsumers) {
    sm90::regs_dealloc<40>();
    if (threadIdx.x == sm90::kConsumers * 128) {
      sm90::Ring ring;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_of(a, t);
        for (int tap = tl.s * a.taps; tap < (tl.s + 1) * a.taps; ++tap) {
          for (int k = 0; k < a.kc; ++k) {
            st.acquire(ring, sm90::Stages<kBN>::kStageBytes);
            sm90::tma_load_3d(st.a(ring.stage), &v_map, &st.full[ring.stage], k * kKElems,
                              tl.m0, tap);
            sm90::tma_load_3d(st.b(ring.stage), &u_map, &st.full[ring.stage], k * kKElems,
                              tl.n0, tap);
            ring.next();
          }
        }
      }
    }
    return;
  }

  sm90::regs_alloc<232>();
  uint8_t* staging = wino_smem + sm90::Stages<kBN>::kSmemBytes + wg * Staging::kStaging;
  long long* row_pix = reinterpret_cast<long long*>(staging + 64 * Staging::kPitch);
  const int lt = threadIdx.x % 128, r0 = wg * 64;
  const long long pixels = (long long)a.B * a.H * a.W;
  sm90::Ring ring;
  float acc[kBN / 2];
  float y[4][kBN / 2];  // Y[u][v] at [2 u + v]
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl = tile_of(a, t);
#pragma unroll
    for (int uv = 0; uv < 4; ++uv)
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) y[uv][i] = 0.f;
    for (int tap = tl.s * a.taps; tap < (tl.s + 1) * a.taps; ++tap) {
      st.mma(ring, wg, acc, a.kc);
#pragma unroll
      for (int uv = 0; uv < 4; ++uv) {
        const int cf = at(uv >> 1, tap >> 2) * at(uv & 1, tap & 3);
        if (cf > 0) {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) y[uv][i] = __fadd_rn(y[uv][i], acc[i]);
        } else if (cf < 0) {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) y[uv][i] = __fsub_rn(y[uv][i], acc[i]);
        }
      }
    }

    if (a.splits > 1) {
      // the split's fp32 partial, straight from the registers
      float* part = a.partial + (long long)tl.s * pixels * a.O;
#pragma unroll
      for (int uv = 0; uv < 4; ++uv) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long pix =
              pixel_of(a, tl.m0 + r0 + sm90::frag_row(2 * h), uv >> 1, uv & 1);
          if (pix < 0) continue;
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j) {
            const int col = tl.n0 + sm90::frag_col(j, 0);
            if (col >= a.O) continue;
            *reinterpret_cast<float2*>(part + pix * a.O + col) =
                make_float2(y[uv][4 * j + 2 * h], y[uv][4 * j + 2 * h + 1]);
          }
        }
      }
      continue;
    }

#pragma unroll
    for (int uv = 0; uv < 4; ++uv) {
      sm90::warpgroup_sync(wg);  // the last stores have left the staging area
      if (lt < 64) row_pix[lt] = pixel_of(a, tl.m0 + r0 + lt, uv >> 1, uv & 1);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int cl = sm90::frag_col(j, 0), col = tl.n0 + cl;
        if (col >= a.O) continue;
        float2 b2 = make_float2(0.f, 0.f);
        if (a.bias != nullptr) {
          b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.bias + col));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = y[uv][4 * j + 2 * h], v1 = y[uv][4 * j + 2 * h + 1];
          if (a.bias != nullptr) {
            v0 = d3r::conv::add_bias(v0, b2.x);
            v1 = d3r::conv::add_bias(v1, b2.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(staging + sm90::frag_row(2 * h) * Staging::kPitch +
                                             2 * cl) = __floats2bfloat162_rn(v0, v1);
        }
      }
      sm90::warpgroup_sync(wg);
      d3r::conv::store_rows(staging, Staging::kPitch, row_pix, a.out + tl.n0, a.O,
                            min(kBN, a.O - tl.n0));
    }
  }
}

// --------------------------------------------------------------------------
// 3. The split sums: out[i] = bf16(sum over s of partial[s][i]) (+ bias).

__global__ void wino_reduce_kernel(const GemmArgs a) {
  const long long n = (long long)a.B * a.H * a.W * a.O;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < a.splits; ++s) v = __fadd_rn(v, a.partial[s * n + i]);
    if (a.bias != nullptr) v = d3r::conv::add_bias(v, __bfloat162float(a.bias[i % a.O]));
    a.out[i] = __float2bfloat16_rn(v);
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

// x [B, H, W, C] bf16, u [16, O, C] bf16, bias [O] bf16 or null, out
// [B, H, W, O] bf16; v [16, Mt, C] bf16 scratch (Mt = B ceil(H/2) ceil(W/2));
// partial [splits, B H W, O] fp32 scratch when splits > 1. All contiguous,
// x, u and v 16-byte aligned. C % 32 == 0, O % 8 == 0, splits in {1, 2, 4}
// (the host's plan). Returns the first CUDA error of the launches.
extern "C" int d3r_conv3x3_winograd(const void* x, const void* u, const void* bias, void* out,
                                    void* v, void* partial, int B, int H, int W, int C, int O,
                                    int splits, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 32 != 0 || O <= 0 || O % 8 != 0 ||
      (splits != 1 && splits != 2 && splits != 4) || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int th = (H + 1) / 2, tw = (W + 1) / 2, mt = B * th * tw;

  const InArgs ia{static_cast<const bf16*>(x), static_cast<bf16*>(v), B, H, W, C, th, tw, mt};
  const int in_blocks = std::max(1, std::min(ceil_div((long long)mt * (C / 4), 256), 132 * 32));
  wino_input_kernel<<<in_blocks, 256, 0, st>>>(ia);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const uint64_t c_bytes = (uint64_t)C * 2;
  const uint64_t v_dims[3] = {(uint64_t)C, (uint64_t)mt, kTaps};
  const uint64_t v_strides[2] = {c_bytes, c_bytes * mt};
  const uint32_t v_box[3] = {kKElems, sm90::kBlockRows, 1};
  const uint64_t u_dims[3] = {(uint64_t)C, (uint64_t)O, kTaps};
  const uint64_t u_strides[2] = {c_bytes, c_bytes * O};
  const uint32_t u_box[3] = {kKElems, kBN, 1};
  const uint32_t steps[3] = {1, 1, 1};
  CUtensorMap v_map, u_map;
  err = sm90::tensor_map_nd(&v_map, v, 2, 3, v_dims, v_strides, v_box, steps);
  if (err == cudaSuccess) err = sm90::tensor_map_nd(&u_map, u, 2, 3, u_dims, u_strides, u_box, steps);
  if (err != cudaSuccess) return (int)err;

  GemmArgs a{};
  a.B = B;
  a.H = H;
  a.W = W;
  a.O = O;
  a.Th = th;
  a.Tw = tw;
  a.Mt = mt;
  a.m_tiles = ceil_div(mt, sm90::kBlockRows);
  a.n_tiles = ceil_div(O, kBN);
  a.splits = splits;
  a.taps = kTaps / splits;
  a.kc = ceil_div(c_bytes, sm90::kKBytes);
  a.bias = static_cast<const bf16*>(bias);
  a.out = static_cast<bf16*>(out);
  a.partial = static_cast<float*>(partial);
  err = sm90::launch<wino_gemm_kernel>(a.m_tiles * a.n_tiles * splits, Staging::kBytes, st,
                                       v_map, u_map, a);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = (long long)B * H * W * O;
  wino_reduce_kernel<<<std::max(1, std::min(ceil_div(n, 256), 132 * 16)), 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}
