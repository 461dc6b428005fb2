// Implicit-GEMM convolution for Hopper (sm_90a) on the TMA + wgmma building
// blocks of sm90_gemm.cuh, NHWC, generic in the operand type (int8 with
// int32 sums, bf16 with fp32 sums) and in the epilogue:
//   acc[b, oy, ox, co] = sum over (ky, kx, ci) of
//       x[b, oy*s + ky - pt, ox*s + kx - pl, ci] * w[co, ky, kx, ci]
// Used by conv2d_int8.cu (its three dequantizing epilogues), conv2d_bf16.cu
// and attention_fused_bf16.cu (the QKV projection, a 1x1 convolution over
// the rows).
//
// The GEMM is M = output pixels by N = Cout by K = KH * KW * Cin, walked in
// k steps of 128 bytes of Cin of one tap (ky, kx); a tap is ceil(Cin bytes
// / 128) steps, the last one's tail zero-filled by TMA.
//   A: a tile is a rectangle of output pixels, bw wide, bh high, over bb
//      batch items (bw * bh * bb <= 128 rows; the host's plan picks the box
//      that wastes the fewest rows at the frame's ragged edges). For each k
//      step the producer loads one 4D TMA box of x [B, H, W, Cin] at
//      (c, ox0 * s + kx - pl, oy0 * s + ky - pt, b0) with element strides
//      (1, s, s, 1): a stride-2 convolution takes every second pixel of the
//      box, and the pixels outside the frame are TMA's zero fill, which is
//      the convolution's zero padding. So no padded copy, no im2col buffer
//      and no address arithmetic in the consumers. Of the TPU kernel's two
//      designs this is the tiled-map one, not the padded flat frame
//      (conv2d.py::conv3x3_flat): the flat frame computes the 2 padding
//      columns of every row (7-37% more rows at the UNet's frames) and needs
//      a padded copy of bf16 x, while a box of the frame's own width wastes
//      6-10% at the UNet's frames (45 and 23 rows) and nothing at the VAE's.
//      A dense layer or a 1x1 stride-1 convolution arrives from the wrapper
//      as one row of B*H*W pixels (boxes of 128).
//   B: a 3D TMA map (Cin, KH * KW, Cout) of w [Cout, KH, KW, Cin], box
//      (128 bytes, 1, kBN), so a box past the end of Cin reads zeros, not the
//      next tap's weights.
// The int8 kernels run as dependent launches (pdl.cuh) right after the
// quantize of x that conv2d_int8.cu launches: the producer prefetches the
// two maps and issues the weight boxes of its first tile's first stages,
// then waits on the quantize before its first x box.
// Blocks are persistent (sm90::launch); a tile is (pixel box, kBN output
// channels, split of K). Where tiles are too few for the SMs the plan splits
// K: each split writes its sums to a partial buffer [splits, M, Cout] and
// conv_*_reduce_kernel adds them and runs the epilogue. int8 partials are
// int32 (exact, in any order); "halo" splits fall only at rows of taps (ky),
// each split's partial being its rows' fp32 sum, so the reduction adds them
// in ky order as the unsplit kernel does; bf16 partials are fp32 (another
// order of the sums).
//
// Epilogues (kEpi):
//   kXla  (0): v = (float(acc) * act_scale) * ws[co]
//   kTpu  (1): v = float(acc) * (act_scale * ws[co])
//   kHalo (2): v = fsum * (act_scale * ws[co]), fsum the fp32 sum, in ky
//              order from 0, of each row of taps' exact int32 partial: the
//              consumers drain the wgmma pipeline at the end of each ky row
//              and fold the registers into fsum
//   kBf16 (3): v = acc (fp32)
// With per-group activation scales (the dynamic int8 modes: act_amax set,
// conv2d_int8.cu's dynamic entry point), act_scale is replaced, in kXla's
// order, by the scale of the output row's group g = pixel / group_pixels (a
// batch item of a convolution, a row of a dense layer), read per row, since
// one tile's box may span two batch items: s[g] =
// act_quantize.cuh::group_scale(act_amax[g]) for a dense layer's rows (one
// slot a row), or, for a convolution's batch items (amax_chunks slots a
// group), from a table of every group's scale that the consumers fold from
// the slots into shared memory once a block, after the grid dependency.
// then bf16(bf16(v) + bias[co]) with a bias, bf16(v) without, or v itself
// for an fp32 output (int8 only, no bias): the orders of the references
// (conv2d_int8.cu's note), with no fused multiply-add. A bf16 output tile is
// staged in shared memory and stored 16 bytes a thread (4 where Cout % 8 !=
// 0); fp32 outputs and partials go straight from the registers, 8 bytes a
// store.
//
// The loader quantize (kLoadQ, the dynamic 1x1 and stride-2 convolutions):
// the A operand is bf16 x itself. A k step's 128 int8 channels are two TMA
// boxes of 64 bf16 channels (128 bytes a row, the second left out where it
// would lie wholly past Cin: those channels are zeros), 32 KB a stage in
// a ring of kLoadQStages. Each consumer thread, once a stage is full, reads
// the bf16 values of its wgmma A fragments from the swizzled boxes (8 bytes
// a load), quantizes them at its rows' group scales (act_quantize.cuh::
// quant_fast, no division) into the fragments' registers and issues the
// wgmmas with A from registers (mma_loadq): no int8 tile in shared memory,
// so no generic-to-async proxy fence and no warpgroup barrier. No int8 copy
// of x and no quantize pass: x is read by the absmax and by this loader, and
// an element is converted about as often as the boxes load it (once at
// 1x1, 2.25 times at 3x3 stride 2, per output-channel tile). Measured on the
// H100 (PERF.md section 6): writing an int8 tile to shared memory instead (a
// fence and two barriers a k step) ran 15-18% slower; four stages with the
// bf16 output stored from the registers, slower still.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "act_quantize.cuh"
#include "sm90_gemm.cuh"

namespace d3r {
namespace conv {

using bf16 = __nv_bfloat16;
using sm90::kConsumers;
using sm90::kKBytes;
using sm90::kThreads;
using sm90::Ring;
using sm90::Stages;

enum Epilogue { kXla = 0, kTpu = 1, kHalo = 2, kBf16 = 3 };

// One call: the geometry, the plan's tiles, and the epilogue's operands.
struct Call {
  const void* x;  // [B, H, W, Cin] int8 or bf16
  const void* w;  // [Cout, KH, KW, Cin], x's type
  int B, H, W, Cin, OH, OW, Cout, KH, KW, stride, pad_t, pad_l;
  int bw, bh, bb;  // the output box of a tile
  int bn;          // output channels of a tile: 64, 128 or 160 (halo: 64, 128)
  int splits, per; // splits of the k steps, per k steps each (the last may have fewer)
  const float* ws;    // int8: [Cout] weight scales
  const bf16* bias;   // int8, bf16 output: [Cout] or null
  void* out;          // [B, OH, OW, Cout] bf16, or fp32 with out_f32
  void* partial;      // [splits, B * OH * OW, Cout] int32 / fp32, when splits > 1
  float act_scale;
  int out_f32;
  const float* act_amax;     // per-group activation absmax slots, or null
  long long group_pixels;    // output pixels of a scale group, with act_amax
  int amax_chunks;           // slots a group (a table of `groups` scales), or 0: one a row
  int groups;
  bool loadq;                // x is bf16, quantized in the loader (kXla only)
};

// The call's geometry, plan and epilogue from the int array the C entry
// points take (the wrappers cache one per call signature, so a call passes
// one pointer instead of twenty arguments): [B, H, W, Cin, OH, OW, Cout, KH,
// KW, stride, pad_t, pad_l, bw, bh, bb, bn, splits, per, epilogue,
// out_f32]. The operands and act_scale are the caller's to fill.
inline Call call_of(const void* x, const void* w, const int* g) {
  Call c{};
  c.x = x;
  c.w = w;
  int* fields[18] = {&c.B,    &c.H,  &c.W,  &c.Cin,    &c.OH,    &c.OW,
                     &c.Cout, &c.KH, &c.KW, &c.stride, &c.pad_t, &c.pad_l,
                     &c.bw,   &c.bh, &c.bb, &c.bn,     &c.splits, &c.per};
  for (int i = 0; i < 18; ++i) *fields[i] = g[i];
  c.out_f32 = g[19];
  return c;
}

// What the kernels read: the call's geometry and derived counts.
struct Args {
  int B, OH, OW, Cout, KW, stride, pad_t, pad_l;
  int bw, bh, bb, tx, ty, m_tiles, n_tiles, splits, per;
  int kc, k_steps, row_steps;  // k steps per tap, in all, per row of taps
  uint32_t a_bytes;            // bytes of one A box
  long long pixels;            // B * OH * OW
  const float* ws;
  const bf16* bias;
  void* out;
  void* partial;
  float act_scale;
  int out_f32;
  const float* act_amax;
  long long group_pixels;
  int amax_chunks, groups;
  int cin;
};

// The activation scale of output pixel p (p >= 0): the call's static scale,
// or its group's dynamic one (from `table` where the call has one).
__device__ __forceinline__ float act_of(const Args& a, const float* table, long long p) {
  if (a.act_amax == nullptr) return a.act_scale;
  const long long g = p / a.group_pixels;
  return a.amax_chunks > 0 ? table[g] : actq::group_scale(a.act_amax[g]);
}

// The table of a convolution's group scales, folded from the slots by the
// threads [t0, t0 + threads) of the block (the caller syncs them after).
__device__ __forceinline__ void fold_table(const Args& a, float* table, int t, int threads) {
  for (int g = t; g < a.groups; g += threads) {
    table[g] = actq::group_scale(actq::fold_slots(a.act_amax, g, a.amax_chunks));
  }
}

// The loader quantize's ring: two bf16 boxes and a B tile a stage, one
// stage fewer than Stages (each is 16 KB larger, and the output staging
// must fit beside them). Same interface.
constexpr int kLoadQStages = 3;
constexpr int kBoxBytes = sm90::kBlockRows * kKBytes;  // 128 rows x 64 bf16
using LoadQRing = sm90::RingN<kLoadQStages>;

template <int kBN>
struct LoadQStages {
  static constexpr int kABytes = 2 * kBoxBytes;
  static constexpr int kBBytes = kBN * kKBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr size_t kSmemBytes = 1024 + kLoadQStages * kStageBytes + 2 * kLoadQStages * 8;

  uint8_t* tiles;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit LoadQStages(uint8_t* raw)
      : tiles(raw + ((1024 - (sm90::smem_u32(raw) & 1023)) & 1023)),
        full(reinterpret_cast<uint64_t*>(tiles + kLoadQStages * kStageBytes)),
        empty(full + kLoadQStages) {}

  __device__ uint8_t* a(int s) const { return tiles + s * kStageBytes; }
  __device__ uint8_t* b(int s) const { return a(s) + kABytes; }

  __device__ void init() const {
    for (int s = 0; s < kLoadQStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  __device__ void acquire(const LoadQRing& r, uint32_t bytes) const {
    sm90::mbar_wait(&empty[r.stage], r.phase ^ 1);
    sm90::mbar_expect_tx(&full[r.stage], bytes);
  }
};

template <int kBN, bool kLoadQ>
using StagesOf = std::conditional_t<kLoadQ, LoadQStages<kBN>, Stages<kBN>>;
template <bool kLoadQ>
using RingOf = std::conditional_t<kLoadQ, LoadQRing, Ring>;

// Dynamic shared memory: the ring, then per consumer warpgroup a staging
// area for its 64 rows of bf16 output (kPitch bytes a row: 16 more than the
// row keeps the fragment writes free of bank conflicts) and the rows'
// output pixels, then the table of group scales.
template <int kBN, bool kLoadQ = false>
struct Smem {
  static constexpr int kPitch = 2 * kBN + 16;
  static constexpr int kStaging = 64 * kPitch + 64 * 8;
  static constexpr size_t kRing = StagesOf<kBN, kLoadQ>::kSmemBytes;
  static constexpr size_t kTableAt = kRing + kConsumers * kStaging;
  static constexpr size_t kBytes = kTableAt + 4 * actq::kMaxGroups;
};

struct Tile {
  int ox0, oy0, b0, n0, s, k0, k1;
};

// Tile t: pixel boxes vary fastest, so the blocks in flight share weights.
template <int kBN>
__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  const int m = t % a.m_tiles, rest = t / a.m_tiles;
  Tile r;
  r.s = rest / a.n_tiles;
  r.n0 = (rest - r.s * a.n_tiles) * kBN;
  r.ox0 = m % a.tx * a.bw;
  r.oy0 = m / a.tx % a.ty * a.bh;
  r.b0 = m / (a.tx * a.ty) * a.bb;
  r.k0 = r.s * a.per;
  r.k1 = min(r.k0 + a.per, a.k_steps);
  return r;
}

// The flat output pixel (b * OH + oy) * OW + ox of row R of the tile's A
// box, or -1 for a row past the box or outside the output frame.
__device__ __forceinline__ long long pixel_of(const Args& a, const Tile& t, int R) {
  if (R >= a.bw * a.bh * a.bb) return -1;
  const int ox = t.ox0 + R % a.bw, oy = t.oy0 + R / a.bw % a.bh, pb = t.b0 + R / (a.bw * a.bh);
  if (ox >= a.OW || oy >= a.OH || pb >= a.B) return -1;
  return ((long long)pb * a.OH + oy) * a.OW + ox;
}

// int8: one sum dequantized in the order of kEpi (sum: the int32 sum as
// fp32, or the "halo" fp32 sum).
template <int kEpi>
__device__ __forceinline__ float dequant(float sum, float act, float w) {
  return kEpi == kXla ? __fmul_rn(__fmul_rn(sum, act), w) : __fmul_rn(sum, __fmul_rn(act, w));
}

__device__ __forceinline__ float add_bias(float v, float b) {
  return __fadd_rn(__bfloat162float(__float2bfloat16_rn(v)), b);
}

// Store the warpgroup's 64 staged rows (cols bf16 values each, `pitch`
// bytes apart in shared memory) to out[pix * cout + n0 ...] for the rows
// whose pixel is not -1: 16-byte stores where Cout % 8 == 0, else 4-byte.
__device__ __forceinline__ void store_rows(const uint8_t* src, int pitch,
                                           const long long* row_pix, bf16* out, int cout,
                                           int cols) {
  const int lt = threadIdx.x % 128;
  if (cout % 8 == 0) {
    const int chunks = cols / 8;
    for (int i = lt; i < 64 * chunks; i += 128) {
      const int r = i / chunks, c = i - r * chunks;
      const long long p = row_pix[r];
      if (p >= 0) {
        *reinterpret_cast<uint4*>(out + p * cout + 8 * c) =
            *reinterpret_cast<const uint4*>(src + r * pitch + 16 * c);
      }
    }
  } else {
    const int chunks = cols / 2;
    for (int i = lt; i < 64 * chunks; i += 128) {
      const int r = i / chunks, c = i - r * chunks;
      const long long p = row_pix[r];
      if (p >= 0) {
        *reinterpret_cast<uint32_t*>(out + p * cout + 2 * c) =
            *reinterpret_cast<const uint32_t*>(src + r * pitch + 4 * c);
      }
    }
  }
}

extern __shared__ __align__(16) uint8_t conv_smem[];

// d (+)= A (64 x 32 int8, fragments in registers) . B (N x 32 int8,
// K-major in shared memory at descriptor b), int32 sums; `accumulate` 0
// overwrites d. The A fragment of warp w, lane l of the warpgroup: rows
// 16 w + l / 4 (a[0], a[2]) and 8 more (a[1], a[3]), columns 4 (l % 4)
// + 0..3 (a[0], a[1]) and 16 more (a[2], a[3]), four int8 a register in
// column order: mma.m16n8k32's A layout, a warp's 16 rows each.
template <int N>
__device__ void wgmma_ra(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ra<64>(int (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ra<128>(int (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ra<160>(int (&d)[80], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]),
        "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ uint2 ld_shared_u2(const uint8_t* p) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(sm90::smem_u32(p)));
  return v;
}

// kLoadQ: the four bf16 of fragment word e (row line0 + 8 (e & 1),
// channels 32 kk + 16 (e >> 1) + q4 + 0..3 of the k step) in the stage's
// TMA boxes at `a` (box kk / 2: 128-byte rows, 16-byte chunk c of row r at
// c ^ (r % 8)), as 8 bytes.
__device__ __forceinline__ const uint8_t* box_word(const uint8_t* a, int line0, int q4, int kk,
                                                   int e) {
  const int line = line0 + 8 * (e & 1);
  const int cb = 32 * (kk % 2) + 16 * (e >> 1) + q4;  // channel within the box
  return a + (kk / 2) * kBoxBytes + line * kKBytes + (((cb / 8) ^ (line & 7)) << 4) +
         (cb % 8) * 2;
}

// The four int8 of the four bf16 of v at scale s, reciprocal r, one word
__device__ __forceinline__ uint32_t quant4(const uint2& v, float s, float r) {
  const uint32_t w[2] = {v.x, v.y};
  uint32_t q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    q[j] = actq::quant_fast(__uint_as_float(j % 2 ? w[j / 2] & 0xffff0000u : w[j / 2] << 16), s,
                            r);
  }
  return actq::low_bytes(q[0], q[1], q[2], q[3]);
}

// kLoadQ consumer: d = its 64 rows of A . B^T over the tile's k steps, A
// converted from each stage's bf16 boxes straight into the wgmmas' register
// fragments at the rows' scales s[h], reciprocals rc[h] (h: the fragment's
// row half). The four wgmmas of a k step read their fragments until they
// complete, so a k step waits for its own before the next one overwrites
// them; the other warpgroup's conversion runs meanwhile.
template <int kBN>
__device__ __forceinline__ void mma_loadq(const LoadQStages<kBN>& st, LoadQRing& r, int wg,
                                          int (&d)[kBN / 2], const Args& a, const Tile& tl,
                                          const float (&s)[2], const float (&rc)[2]) {
  const int lane = threadIdx.x % 32;
  const int line0 = wg * 64 + 16 * ((threadIdx.x % 128) / 32) + lane / 4, q4 = 4 * (lane % 4);
  for (int ks = tl.k0; ks < tl.k1; ++ks) {
    sm90::mbar_wait(&st.full[r.stage], r.phase);
    const bool second = (ks % a.kc) * kKBytes + 64 < a.cin;
    const uint8_t* base = st.a(r.stage);
    uint32_t frag[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint2 raw = kk >= 2 && !second ? make_uint2(0u, 0u)
                                             : ld_shared_u2(box_word(base, line0, q4, kk, e));
        frag[kk][e] = quant4(raw, s[e & 1], rc[e & 1]);
      }
    }
    const uint64_t db = sm90::smem_desc(st.b(r.stage));
    sm90::fence_sums(d);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ra<kBN>(d, frag[kk], db + 2 * kk, ks > tl.k0 || kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_sums(d);
    if (threadIdx.x % 128 == 0) sm90::mbar_arrive(&st.empty[r.stage]);
    r.next();
  }
}

template <typename T, int kEpi, int kBN, bool kLoadQ = false>
__device__ __forceinline__ void conv_body(const CUtensorMap& x_map, const CUtensorMap& w_map,
                                          const Args& a) {
  constexpr bool kInt8 = sizeof(T) == 1;
  using Acc = std::conditional_t<kInt8, int, float>;  // int8: int32 sums, bf16: fp32
  constexpr int kK = kKBytes / (int)sizeof(T);  // elements of K per step
  using St = StagesOf<kBN, kLoadQ>;
  using Sm = Smem<kBN, kLoadQ>;
  using Ring = RingOf<kLoadQ>;
  const St st(conv_smem);
  if (threadIdx.x == 0) st.init();
  __syncthreads();
  const int tiles = a.m_tiles * a.n_tiles * a.splits;
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    sm90::regs_dealloc<40>();
    if (threadIdx.x != kConsumers * 128) return;
    sm90::prefetch_map(&x_map);
    sm90::prefetch_map(&w_map);
    Ring ring;
    if constexpr (kLoadQ) {
      // x is the call's input, not written by the kernel before (the
      // absmax): no wait before loading it
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_of<kBN>(a, t);
        const int x0 = tl.ox0 * a.stride - a.pad_l, y0 = tl.oy0 * a.stride - a.pad_t;
        for (int ks = tl.k0; ks < tl.k1; ++ks) {
          const int tap = ks / a.kc, c = (ks - tap * a.kc) * kKBytes;
          const int ky = tap / a.KW, kx = tap - ky * a.KW;
          const bool second = c + 64 < a.cin;
          st.acquire(ring, a.a_bytes * (second ? 2u : 1u) + St::kBBytes);
          sm90::tma_load_3d(st.b(ring.stage), &w_map, &st.full[ring.stage], c, tap, tl.n0);
          sm90::tma_load_4d(st.a(ring.stage), &x_map, &st.full[ring.stage], c, x0 + kx, y0 + ky,
                            tl.b0);
          if (second) {
            sm90::tma_load_4d(st.a(ring.stage) + kBoxBytes, &x_map, &st.full[ring.stage], c + 64,
                              x0 + kx, y0 + ky, tl.b0);
          }
          ring.next();
        }
      }
    } else {
      const uint32_t bytes = a.a_bytes + St::kBBytes;
      // The weight boxes of the first tile's first stages go out before the
      // wait on the kernel that writes x (the int8 entry point's quantize,
      // a dependent launch: pdl.cuh); `pre` counts them.
      int pre = 0;
      {
        const Tile tl = tile_of<kBN>(a, blockIdx.x);
        Ring r = ring;
        for (int ks = tl.k0; ks < tl.k1 && pre < sm90::kStages; ++ks, ++pre) {
          const int tap = ks / a.kc, c = (ks - tap * a.kc) * kK;
          st.acquire(r, bytes);
          sm90::tma_load_3d(st.b(r.stage), &w_map, &st.full[r.stage], c, tap, tl.n0);
          r.next();
        }
      }
      pdl::wait();
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_of<kBN>(a, t);
        const int x0 = tl.ox0 * a.stride - a.pad_l, y0 = tl.oy0 * a.stride - a.pad_t;
        for (int ks = tl.k0; ks < tl.k1; ++ks) {
          const int tap = ks / a.kc, c = (ks - tap * a.kc) * kK;
          const int ky = tap / a.KW, kx = tap - ky * a.KW;
          if (pre > 0) {
            --pre;  // armed, its weight box on the way
          } else {
            st.acquire(ring, bytes);
            sm90::tma_load_3d(st.b(ring.stage), &w_map, &st.full[ring.stage], c, tap, tl.n0);
          }
          sm90::tma_load_4d(st.a(ring.stage), &x_map, &st.full[ring.stage], c, x0 + kx, y0 + ky,
                            tl.b0);
          ring.next();
        }
      }
    }
    return;
  }

  sm90::regs_alloc<232>();
  // the dynamic scales come from the kernels before this one: wait, as the
  // producer does, before the first read of them (the convolutions' table,
  // folded here once)
  float* table = reinterpret_cast<float*>(conv_smem + Sm::kTableAt);
  if (a.act_amax != nullptr) {
    pdl::wait();
    if (a.amax_chunks > 0) {
      fold_table(a, table, threadIdx.x, kConsumers * 128);
      asm volatile("bar.sync 3, %0;\n" ::"n"(kConsumers * 128) : "memory");  // the consumers
    }
  }
  uint8_t* staging = conv_smem + Sm::kRing + wg * Sm::kStaging;
  long long* row_pix = reinterpret_cast<long long*>(staging + 64 * Sm::kPitch);
  const int lt = threadIdx.x % 128, r0 = wg * 64;
  Ring ring;
  Acc acc[kBN / 2];
  float fsum[kEpi == kHalo ? kBN / 2 : 1];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl = tile_of<kBN>(a, t);
    if constexpr (kLoadQ) {
      // the scales of this thread's two rows of the A fragments (mma_loadq)
      float s[2], rc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = pixel_of(a, tl, r0 + 16 * (lt / 32) + lt % 32 / 4 + 8 * h);
        s[h] = p < 0 ? 1.f : table[p / a.group_pixels];
        rc[h] = __frcp_rn(s[h]);
      }
      mma_loadq<kBN>(st, ring, wg, acc, a, tl, s, rc);
    } else if constexpr (kEpi == kHalo) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) fsum[i] = 0.f;
      for (int ks = tl.k0; ks < tl.k1; ks += a.row_steps) {
        st.mma(ring, wg, acc, a.row_steps);
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) fsum[i] = __fadd_rn(fsum[i], __int2float_rn(acc[i]));
      }
    } else {
      st.mma(ring, wg, acc, tl.k1 - tl.k0);
    }
    // the fp32 value of sum i before the dequantization
    auto sum = [&](int i) -> float {
      if constexpr (kEpi == kHalo) {
        return fsum[i];
      } else if constexpr (kInt8) {
        return __int2float_rn(acc[i]);
      } else {
        return acc[i];
      }
    };

    if (a.splits > 1 || a.out_f32) {
      // partial sums (or an fp32 output) straight from the registers
      const long long pix[2] = {pixel_of(a, tl, r0 + sm90::frag_row(0)),
                                pixel_of(a, tl, r0 + sm90::frag_row(2))};
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = tl.n0 + sm90::frag_col(j, 0);
        if (col >= a.Cout) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (pix[h] < 0) continue;
          const int i = 4 * j + 2 * h;
          const long long o = pix[h] * a.Cout + col;
          if (a.splits > 1) {
            const long long at = (long long)tl.s * a.pixels * a.Cout + o;
            if constexpr (kInt8 && kEpi != kHalo) {
              *reinterpret_cast<int2*>(static_cast<int*>(a.partial) + at) =
                  make_int2(acc[i], acc[i + 1]);
            } else {
              *reinterpret_cast<float2*>(static_cast<float*>(a.partial) + at) =
                  make_float2(sum(i), sum(i + 1));
            }
          } else if constexpr (kInt8) {
            const float act = act_of(a, table, pix[h]);
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) =
                make_float2(dequant<kEpi>(sum(i), act, a.ws[col]),
                            dequant<kEpi>(sum(i + 1), act, a.ws[col + 1]));
          }
        }
      }
      continue;
    }

    // bf16 output, staged: wait until the last tile's rows have left
    sm90::warpgroup_sync(wg);
    if (lt < 64) row_pix[lt] = pixel_of(a, tl, r0 + lt);
    float act[2] = {a.act_scale, a.act_scale};
    if (kInt8 && a.act_amax != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = pixel_of(a, tl, r0 + sm90::frag_row(2 * h));
        act[h] = p < 0 ? 0.f : act_of(a, table, p);
      }
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int cl = sm90::frag_col(j, 0), col = tl.n0 + cl;
      if (col >= a.Cout) continue;
      float2 w2 = make_float2(0.f, 0.f), b2 = make_float2(0.f, 0.f);
      if constexpr (kInt8) {
        w2 = *reinterpret_cast<const float2*>(a.ws + col);
        if (a.bias != nullptr) {
          b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.bias + col));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        float v0 = sum(i), v1 = sum(i + 1);
        if constexpr (kInt8) {
          v0 = dequant<kEpi>(v0, act[h], w2.x);
          v1 = dequant<kEpi>(v1, act[h], w2.y);
          if (a.bias != nullptr) {
            v0 = add_bias(v0, b2.x);
            v1 = add_bias(v1, b2.y);
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(staging + sm90::frag_row(2 * h) * Sm::kPitch + 2 * cl) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    sm90::warpgroup_sync(wg);
    store_rows(staging, Sm::kPitch, row_pix, static_cast<bf16*>(a.out) + tl.n0, a.Cout,
               min(kBN, a.Cout - tl.n0));
  }
}

// One kernel name per operand type and epilogue, so that a profile tells
// them apart (the epilogue first in the template arguments).
template <int kEpi, int kBN>
__global__ void __launch_bounds__(kThreads, 1)
    conv_int8_sm90_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap w_map, const Args a) {
  conv_body<int8_t, kEpi, kBN>(x_map, w_map, a);
}

// The dynamic convolutions' loader quantize: x bf16, "xla" epilogue.
template <int kBN>
__global__ void __launch_bounds__(kThreads, 1)
    conv_int8_loadq_sm90_kernel(const __grid_constant__ CUtensorMap x_map,
                                const __grid_constant__ CUtensorMap w_map, const Args a) {
  conv_body<int8_t, kXla, kBN, true>(x_map, w_map, a);
}

template <int kBN>
__global__ void __launch_bounds__(kThreads, 1)
    conv_bf16_sm90_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap w_map, const Args a) {
  conv_body<bf16, kBf16, kBN>(x_map, w_map, a);
}

// The split sums: out[i] = epilogue(sum over s of partial[s][i]), int32
// partials added exactly, fp32 ones in split order from 0.
template <typename T, int kEpi>
__device__ __forceinline__ void reduce_body(const Args& a) {
  __shared__ float table[actq::kMaxGroups];
  if (a.act_amax != nullptr && a.amax_chunks > 0) {
    fold_table(a, table, threadIdx.x, blockDim.x);
    __syncthreads();
  }
  const long long n = a.pixels * a.Cout;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int col = (int)(i % a.Cout);
    float v;
    if constexpr (sizeof(T) == 1 && kEpi != kHalo) {
      int s32 = 0;
      for (int s = 0; s < a.splits; ++s) s32 += static_cast<const int*>(a.partial)[s * n + i];
      v = dequant<kEpi>(__int2float_rn(s32), act_of(a, table, i / a.Cout), a.ws[col]);
    } else {
      float f = 0.f;
      for (int s = 0; s < a.splits; ++s) {
        f = __fadd_rn(f, static_cast<const float*>(a.partial)[s * n + i]);
      }
      v = kEpi == kBf16 ? f : dequant<kEpi>(f, act_of(a, table, i / a.Cout), a.ws[col]);
    }
    if (a.out_f32) {
      static_cast<float*>(a.out)[i] = v;
      continue;
    }
    if (kEpi != kBf16 && a.bias != nullptr) v = add_bias(v, __bfloat162float(a.bias[col]));
    static_cast<bf16*>(a.out)[i] = __float2bfloat16_rn(v);
  }
}

template <int kEpi>
__global__ void conv_int8_reduce_kernel(const Args a) {
  reduce_body<int8_t, kEpi>(a);
}

__global__ void conv_bf16_reduce_kernel(const Args a) { reduce_body<bf16, kBf16>(a); }

// ------------------------------------------------------------------ host

// The int8 kernels as dependent launches on the quantize before them
// (conv2d_int8.cu), the bf16 ones as plain launches.
template <typename T, int kEpi, int kBN>
cudaError_t launch_tiles(const CUtensorMap& x, const CUtensorMap& w, const Args& a,
                         cudaStream_t st, bool loadq) {
  const int tiles = a.m_tiles * a.n_tiles * a.splits;
  if constexpr (sizeof(T) == 1 && kEpi == kXla) {
    if (loadq) {
      return sm90::launch<conv_int8_loadq_sm90_kernel<kBN>, true>(
          tiles, Smem<kBN, true>::kBytes, st, x, w, a);
    }
  }
  if constexpr (sizeof(T) == 1) {
    return sm90::launch<conv_int8_sm90_kernel<kEpi, kBN>, true>(tiles, Smem<kBN>::kBytes, st, x,
                                                                w, a);
  } else {
    return sm90::launch<conv_bf16_sm90_kernel<kBN>>(tiles, Smem<kBN>::kBytes, st, x, w, a);
  }
}

template <typename T, int kEpi>
cudaError_t launch_bn(const CUtensorMap& x, const CUtensorMap& w, const Args& a, int bn,
                      cudaStream_t st, bool loadq = false) {
  switch (bn) {
    case 64:
      return launch_tiles<T, kEpi, 64>(x, w, a, st, loadq);
    case 128:
      return launch_tiles<T, kEpi, 128>(x, w, a, st, loadq);
    case 160:
      if constexpr (kEpi != kHalo) return launch_tiles<T, kEpi, 160>(x, w, a, st, loadq);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Check the call against what the kernels take, build the two TMA maps
// (cached by their arguments: a weight's is built once) and launch the
// tiles, then the split sums where the plan splits K. epilogue: kXla, kTpu
// or kHalo for int8 T, kBf16 for bf16. The int8 tiles are a dependent
// launch: the caller has launched the kernel that writes x (with loadq, the
// absmax whose slots the consumers fold) right before.
// Returns the first CUDA error.
template <typename T>
cudaError_t run(const Call& c, int epilogue, cudaStream_t st) {
  constexpr int es = (int)sizeof(T);
  const bool halo = epilogue == kHalo;
  if (c.B <= 0 || c.H <= 0 || c.W <= 0 || c.OH <= 0 || c.OW <= 0 || c.Cout <= 0 ||
      c.Cin % 32 != 0 || c.Cout % 2 != 0 || c.KH <= 0 || c.KW <= 0 || c.stride < 1 ||
      c.stride > 8 || c.bw < 1 || c.bh < 1 || c.bb < 1 || c.bw * c.bh * c.bb > 128 ||
      c.bw * c.stride > 256 || c.bh * c.stride > 256 || c.bb > 256 || c.splits < 1 ||
      c.per < 1 || (c.splits > 1 && c.partial == nullptr) ||
      (c.out_f32 && (es != 1 || c.bias != nullptr)) ||
      (c.act_amax != nullptr && (epilogue != kXla || c.group_pixels <= 0)) ||
      (c.amax_chunks > 0 && (c.act_amax == nullptr || c.amax_chunks > actq::kMaxChunks ||
                             c.groups < 1 || c.groups > actq::kMaxGroups ||
                             (long long)c.groups * c.group_pixels != (long long)c.B * c.OH * c.OW)) ||
      (c.loadq && (es != 1 || epilogue != kXla || c.amax_chunks <= 0)) ||
      (es == 1) != (epilogue != kBf16) || epilogue < kXla || epilogue > kBf16) {
    return cudaErrorInvalidValue;
  }
  Args a{};
  a.B = c.B;
  a.OH = c.OH;
  a.OW = c.OW;
  a.Cout = c.Cout;
  a.KW = c.KW;
  a.stride = c.stride;
  a.pad_t = c.pad_t;
  a.pad_l = c.pad_l;
  a.bw = c.bw;
  a.bh = c.bh;
  a.bb = c.bb;
  a.tx = ceil_div(c.OW, c.bw);
  a.ty = ceil_div(c.OH, c.bh);
  a.m_tiles = a.tx * a.ty * ceil_div(c.B, c.bb);
  a.n_tiles = ceil_div(c.Cout, c.bn);
  a.splits = c.splits;
  a.per = c.per;
  a.kc = ceil_div((long long)c.Cin * es, kKBytes);
  a.row_steps = c.KW * a.kc;
  a.k_steps = c.KH * a.row_steps;
  a.a_bytes = (uint32_t)(c.bw * c.bh * c.bb * kKBytes);
  a.pixels = (long long)c.B * c.OH * c.OW;
  a.ws = c.ws;
  a.bias = c.bias;
  a.out = c.out;
  a.partial = c.partial;
  a.act_scale = c.act_scale;
  a.out_f32 = c.out_f32;
  a.act_amax = c.act_amax;
  a.group_pixels = c.group_pixels;
  a.amax_chunks = c.amax_chunks;
  a.groups = c.groups;
  a.cin = c.Cin;
  // every split non-empty; "halo" splits only at rows of taps
  if ((long long)(c.splits - 1) * c.per >= a.k_steps || (long long)c.splits * c.per < a.k_steps ||
      (halo && c.per % a.row_steps != 0)) {
    return cudaErrorInvalidValue;
  }

  const uint64_t cin_bytes = (uint64_t)c.Cin * es;
  const int xes = c.loadq ? 2 : es;  // the loader quantize reads bf16 x
  const uint64_t x_dims[4] = {(uint64_t)c.Cin, (uint64_t)c.W, (uint64_t)c.H, (uint64_t)c.B};
  const uint64_t x_strides[3] = {cin_bytes * xes / es, cin_bytes * xes / es * c.W,
                                 cin_bytes * xes / es * c.W * c.H};
  const uint32_t x_box[4] = {(uint32_t)(kKBytes / xes), (uint32_t)(c.bw * c.stride),
                             (uint32_t)(c.bh * c.stride), (uint32_t)c.bb};
  const uint32_t x_steps[4] = {1, (uint32_t)c.stride, (uint32_t)c.stride, 1};
  const uint64_t w_dims[3] = {(uint64_t)c.Cin, (uint64_t)(c.KH * c.KW), (uint64_t)c.Cout};
  const uint64_t w_strides[2] = {cin_bytes, cin_bytes * c.KH * c.KW};
  const uint32_t w_box[3] = {(uint32_t)(kKBytes / es), 1, (uint32_t)c.bn};
  const uint32_t w_steps[3] = {1, 1, 1};
  CUtensorMap x_map, w_map;
  cudaError_t err = sm90::tensor_map_nd(&x_map, c.x, xes, 4, x_dims, x_strides, x_box, x_steps);
  if (err == cudaSuccess) {
    err = sm90::tensor_map_nd(&w_map, c.w, es, 3, w_dims, w_strides, w_box, w_steps);
  }
  if (err != cudaSuccess) return err;

  if constexpr (es == 1) {
    switch (epilogue) {
      case kXla:
        err = launch_bn<T, kXla>(x_map, w_map, a, c.bn, st, c.loadq);
        break;
      case kTpu:
        err = launch_bn<T, kTpu>(x_map, w_map, a, c.bn, st);
        break;
      default:
        err = launch_bn<T, kHalo>(x_map, w_map, a, c.bn, st);
    }
  } else {
    err = launch_bn<T, kBf16>(x_map, w_map, a, c.bn, st);
  }
  if (err != cudaSuccess || c.splits == 1) return err;
  const int blocks = std::max(1, std::min(ceil_div(a.pixels * a.Cout, 256), 132 * 16));
  if constexpr (es == 1) {
    switch (epilogue) {
      case kXla:
        conv_int8_reduce_kernel<kXla><<<blocks, 256, 0, st>>>(a);
        break;
      case kTpu:
        conv_int8_reduce_kernel<kTpu><<<blocks, 256, 0, st>>>(a);
        break;
      default:
        conv_int8_reduce_kernel<kHalo><<<blocks, 256, 0, st>>>(a);
    }
  } else {
    conv_bf16_reduce_kernel<<<blocks, 256, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace conv
}  // namespace d3r
