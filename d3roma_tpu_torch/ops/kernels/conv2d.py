"""Implicit-GEMM convolutions: the int8 and the bf16 CUDA kernels, their
plain PyTorch versions, their gates, the host-side plan of a call and the
launch counters, and the JAX package's three 3x3 convolution entry points on
top of them.

- `conv2d_int8` (`csrc/conv2d_int8.cu`) computes the int8 convolution of
  every static int8 mode in one of three epilogues, each the order of
  arithmetic of one reference: "xla", (acc * act_scale) * ws, the XLA int8
  convolution of quant="static" (`d3roma_tpu/ops/quant.py::
  int8_conv_general_dilated_static`), at 3x3 stride 1 and 2 and 1x1, and
  the int8 dense layers as 1x1 convolutions over their rows; "tpu",
  acc * (act_scale * ws), the Pallas kernels `conv3x3_flat`
  (`_kernel_int8`) and `conv3x3_rowtap` (`_kernel_rowtap_int8`); "halo",
  the same with the sum taken as `conv2d_halo.py::_kernel` takes it, one
  int32 partial per row of taps added in fp32.
- `conv2d_int8_dynamic` (the same source's second entry point) is the int8
  convolution and dense layer of the dynamic modes (quant=True / "all" /
  "dense"; `d3roma_tpu/ops/quant.py::int8_conv_general_dilated` and
  `int8_dot_general`, XLA ops there): the activation scale of each batch
  item (each row, for a dense) computed on the device, the "xla" order with
  that scale; `dynamic_plan` picks each call's route (one launch for the
  small dense layers, a fused row quantize for the others, the quantize in
  the convolution's loader or in a pass of its own).
- `conv2d_bf16` (`csrc/conv2d_bf16.cu`) is the bf16 convolution of
  `conv3x3_flat`'s `_kernel_bf16` and of `conv3x3_halo`'s bf16 body:
  bf16 products, fp32 sums, one rounding.
- Both are one TMA + wgmma implicit GEMM, `csrc/sm90_conv.cuh`, in two
  operand types; `conv_plan` cuts a call into its tiles (a box of output
  pixels by bn output channels) and splits K where the tiles are too few
  for the SMs.
- `conv3x3_flat`, `conv3x3_rowtap` and `conv3x3_halo` take the JAX
  functions' arguments (NHWC x, HWIO w, the weight quantized per output
  channel inside the call) and launch those two kernels; their gates
  (`conv3x3_supported`, `conv3x3_rowtap_supported`, `halo_conv_supported`)
  are the JAX package's, copied unchanged, since they decide which sites of
  the "mxu" and "halo" modes take the kernel and so the scale tables' order.

Each kernel's source note says what bounds it on the H100 and how it is
built around that.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from d3roma_tpu_torch.ops.kernels import _build
from d3roma_tpu_torch.ops.kernels.geglu import (
    H100_SMS,
    SPLIT_BYTES_PER_UNIT,
    SPLIT_LAUNCH_UNITS,
    TILE_STAGES,
)
from d3roma_tpu_torch.ops.kernels.quantize import (
    act_workspace,
    dynamic_scale_plain,
    fp32,
    quantize_int8_plain,
    quantize_int8_scalar,
    quantize_weight,
)

# the uncalibrated activation scale (ops/quant.py's STATIC_ACT_SCALE), the
# default of the JAX entry points
_STATIC_ACT_SCALE = 8.0 / 127.0
EPILOGUES = ("xla", "tpu", "halo")


def conv_out_hw(h: int, w: int, k: int, stride: int, padding: int):
    return (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1


# ---------------------------------------------------------------------------
# The plan of a CUDA call (csrc/sm90_conv.cuh)

# rows of an A tile (two wgmma warpgroups of 64), bytes of K a k step, and
# the kernels' tile widths: wgmma N of their instantiations ("halo" keeps a
# second accumulator, so not 160)
BLOCK_ROWS = 128
K_STEP_BYTES = 128
TILE_COLS = (64, 128, 160)
HALO_TILE_COLS = (64, 128)
SPLITS = (1, 2, 3, 4, 6, 8)


@dataclass(frozen=True)
class ConvPlan:
    """How the CUDA kernel cuts one call. box: (width, height, batch) of the
    output pixels of a tile (at most BLOCK_ROWS); bn: output channels of a
    tile; splits: blocks that share K, `per` k steps each (the last one may
    have fewer), each k step 128 bytes of Cin of one tap, taps in (ky, kx)
    order; k_steps: all of them; workspace_bytes: the partial sums
    [splits, pixels, Cout] (int32 or fp32) when split, else 0; cost: its
    modelled time (conv_plan's units)."""
    box: Tuple[int, int, int]
    bn: int
    splits: int
    per: int
    k_steps: int
    workspace_bytes: int
    cost: float = 0.0


def flat_view(b: int, h: int, w: int, kh: int, kw: int, stride: int, padding: int):
    """The (B, H, W) the kernel sees: a 1x1 stride-1 convolution without
    padding (and so every dense layer) is one row of B*H*W pixels, which
    TMA boxes of 128 pixels cover without ragged rows."""
    if kh == kw == 1 and stride == 1 and padding == 0:
        return 1, 1, b * h * w
    return b, h, w


@functools.lru_cache(maxsize=256)
def conv_box(b: int, oh: int, ow: int, stride: int) -> Tuple[int, int, int]:
    """The output box of a tile, (bw, bh, bb) with bw * bh * bb <= 128 and
    bw * stride, bh * stride <= 256 (TMA's box limit): the one with the
    fewest tiles over [b, oh, ow] (so the fewest wasted rows), then the
    fewest pixels a box (TMA's bytes), then the widest (contiguous
    pixels)."""
    best = None
    for bw in range(1, min(ow, BLOCK_ROWS, 256 // stride) + 1):
        for bh in range(1, min(oh, BLOCK_ROWS // bw, 256 // stride) + 1):
            bb = min(b, BLOCK_ROWS // (bw * bh))
            tiles = -(-ow // bw) * -(-oh // bh) * -(-b // bb)
            key = (tiles, bw * bh * bb, -bw)
            if best is None or key < best[0]:
                best = (key, (bw, bh, bb))
    return best[1]


def plan_cost(b: int, oh: int, ow: int, cout: int, box: Tuple[int, int, int], bn: int,
              splits: int, per: int, launch_units: float = SPLIT_LAUNCH_UNITS,
              convert_units: int = 0, sms: int = H100_SMS) -> float:
    """conv_plan's modelled time of one plan, in its units (see there)."""
    bw, bh, bb = box
    tiles = -(-ow // bw) * -(-oh // bh) * -(-b // bb) * -(-cout // bn) * splits
    split = (splits + 1) * 4 * b * oh * ow * cout / SPLIT_BYTES_PER_UNIT + launch_units \
        if splits > 1 else 0
    step = BLOCK_ROWS + bn
    k_step = max(2 * BLOCK_ROWS + bn, convert_units) if convert_units else step
    return -(-tiles // sms) * (per * k_step + TILE_STAGES * step) + split


@functools.lru_cache(maxsize=1024)
def conv_plan(b: int, oh: int, ow: int, cin: int, cout: int, kh: int, kw: int, stride: int,
              itemsize: int, epilogue: str, sms: int = H100_SMS,
              launch_units: float = SPLIT_LAUNCH_UNITS, convert_units: int = 0) -> ConvPlan:
    """The tiles of one call on a card with `sms` SMs, over the output
    [b, oh, ow, cout] of the view the kernel sees (flat_view): the box
    (conv_box), and the tile width and split of K with the least modelled
    time. The model is geglu_plan's, whose GEMMs share the mainloop: a tile
    costs its k steps, plus TILE_STAGES for the fill and the epilogue, times
    the rows it loads a step (BLOCK_ROWS of A and bn of B, 128 bytes each),
    by waves of tiles over the SMs; a split adds its partial sums' round
    trip and a launch (`launch_units`: the device's cost of one by default;
    the dynamic calls, whose small sites the host bounds, pass the host's,
    DYNAMIC_LAUNCH_UNITS). With `convert_units` (the dynamic loader quantize,
    CONVERT_STEP_UNITS) A is loaded in bf16, twice the rows' bytes, and a k
    step (not the fill or the epilogue) costs at least its conversions.
    epilogue: "xla", "tpu", "halo"
    (int8, itemsize 1) or "bf16" (itemsize 2). "halo" splits only at rows of
    taps (ky), so that each split's fp32 partial is its rows' sum and the
    splits add up in ky order."""
    box = conv_box(b, oh, ow, stride)
    kc = -(-cin * itemsize // K_STEP_BYTES)
    row_steps = kw * kc
    k_steps = kh * row_steps
    pixels = b * oh * ow
    halo = epilogue == "halo"

    options = []
    for s in SPLITS:
        per = row_steps * -(-kh // s) if halo else -(-k_steps // s)
        if (s - 1) * per >= k_steps:
            continue  # a split would be empty
        for bn in (HALO_TILE_COLS if halo else TILE_COLS):
            cost = plan_cost(b, oh, ow, cout, box, bn, s, per, launch_units, convert_units, sms)
            options.append(((cost, s, -bn), (bn, s, per)))
    (cost, _, _), (bn, splits, per) = min(options)
    return ConvPlan(box, bn, splits, per, k_steps,
                    4 * splits * pixels * cout if splits > 1 else 0, cost)


@functools.lru_cache(maxsize=1024)
def launch_ints(b, h, w, cin, cout, kh, kw, stride, padding, itemsize, epilogue, out_f32,
                device):
    """A call's plan and the int array the C launchers take
    (csrc/sm90_conv.cuh::call_of): the geometry of the view the kernel sees
    (flat_view), the plan and the epilogue ("xla", "tpu", "halo" or
    "bf16"), built once per call signature: one ctypes argument instead of
    twenty, whose conversions cost more host time than the rest of a
    call's Python."""
    vb, vh, vw = flat_view(b, h, w, kh, kw, stride, padding)
    oh, ow = conv_out_hw(vh, vw, kh, stride, padding)
    plan = conv_plan(vb, oh, ow, cin, cout, kh, kw, stride, itemsize, epilogue,
                     _build.sm_count(device.index))
    values = (vb, vh, vw, cin, oh, ow, cout, kh, kw, stride, padding, padding, *plan.box,
              plan.bn, plan.splits, plan.per, (*EPILOGUES, "bf16").index(epilogue),
              int(out_f32))
    return plan, (ctypes.c_int * len(values))(*values)


# ---------------------------------------------------------------------------
# The plan of a dynamic call (csrc/conv2d_int8.cu's second entry point)

ROUTES = ("small", "rows", "loader", "separate")
# csrc/act_quantize.cuh: absmax slots a group, groups a convolution's table,
# threads of the row quantize's block, its 16-byte vectors a thread
MAX_CHUNKS = 64
MAX_GROUPS = 128
ROW_THREADS = 256
ROW_MAX_VECS = 8
ABSMAX_THREADS = 256
# csrc/conv2d_int8.cu: the small dense's rows (one wgmma M), columns a
# block and K (a row in a warp's registers, eight 16-byte vectors a lane);
# csrc/sm90_conv.cuh: the stages of the int8 and the loader quantize's rings
SMALL_ROWS = 64
SMALL_BN = 32
SMALL_MAX_K = 2048
STAGES = 4
LOADQ_STAGES = 3
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100
# What a launch costs the host, in conv_plan's units (one per
# SPLIT_BYTES_PER_UNIT bytes at the card's memory rate, about 2 ns): ~4 us,
# against the device's ~1 us (SPLIT_LAUNCH_UNITS). At the dynamic calls'
# small sites the host issues the launches slower than the device runs them
# (PERF.md section 6: 0.046-0.061 host ms a call against 0.010-0.026 device
# ms), so a split's sum launch or a quantize pass of its own costs that.
DYNAMIC_LAUNCH_UNITS = 2000
# The loader quantize's k step in conv_plan's units: it loads A in bf16 and
# converts the block's 128 x 128 values into wgmma register fragments.
# Measured on the H100 (PERF.md section 6), the loader's conv against
# the int8 conv over the same tiles: 0.236 against 0.139 ms at the VAE's B4
# 361x641 128 stride 2 (nine k steps a tile), 0.234 against 0.165 at its B2
# 1x1 256 -> 128 (two), 0.909 against 0.433 at its B4 360x640 128 3x3
# (nine): 550-700 units a k step against 256. The quantize pass moves 3
# bytes an element (2 read, 1 written).
CONVERT_STEP_UNITS = 600
QUANTIZE_BYTES = 3
# The loader quantize serves only sites whose input elements the taps load
# at most this often (1x1: 1, 3x3 stride 2: 2.25; 3x3 stride 1: 9)
LOADER_MAX_TAP_LOADS = 2.25


@dataclass(frozen=True)
class DynamicPlan:
    """How one dynamic int8 call runs. route: "small" (a dense layer of at
    most SMALL_ROWS rows: one launch that quantizes its rows in shared memory
    and runs the GEMM), "rows" (a dense layer: the row quantize, then the
    GEMM), "loader" (a convolution: the absmax slots, then the convolution
    quantizing bf16 x in its loader) or "separate" (a convolution: the
    absmax slots, the quantize at the items' scales, the convolution). conv:
    the GEMM's tiles (None for "small"). groups, group_elems, group_pixels:
    the scale groups (rows or batch items), their elements of x and their
    output pixels. chunk, chunks: a convolution's absmax slots (chunks a
    group, chunk elements each). team, vecs: the row quantize's threads a
    row and 16-byte vectors a thread. smem_bytes: the shared memory of the
    call's largest block. workspace_bytes: the int8 workspace (x's int8
    copy and the absmax slots). device_ops: launches a call."""
    route: str
    conv: Optional[ConvPlan]
    groups: int
    group_elems: int
    group_pixels: int
    chunk: int
    chunks: int
    team: int
    vecs: int
    smem_bytes: int
    workspace_bytes: int
    device_ops: int


def small_smem_bytes(k: int) -> int:
    """csrc/conv2d_int8.cu::dense::small_smem_bytes: the A and B tiles of
    every k step, the rows' scales, the mbarrier."""
    k_steps = -(-k // K_STEP_BYTES)
    return 1024 + k_steps * (SMALL_ROWS + SMALL_BN) * K_STEP_BYTES + SMALL_ROWS * 4 + 8


def conv_smem_bytes(bn: int, loadq: bool) -> int:
    """csrc/sm90_conv.cuh::Smem<bn, loadq>::kBytes: the ring (A and B tiles
    a stage, 1024-aligned; the loader quantize's A is two bf16 boxes, in a
    stage fewer), the barriers, the two warpgroups' output staging, the
    table of scales."""
    a_bytes = (2 if loadq else 1) * BLOCK_ROWS * K_STEP_BYTES
    stages = LOADQ_STAGES if loadq else STAGES
    ring = 1024 + stages * (a_bytes + bn * K_STEP_BYTES) + 2 * stages * 8
    return ring + 2 * (64 * (2 * bn + 16) + 64 * 8) + 4 * MAX_GROUPS


def row_team(k: int) -> Tuple[int, int]:
    """The row quantize's threads a row (a warp, or 2-8 warps where the row
    has more 16-byte vectors than a warp holds at ROW_MAX_VECS a thread) and
    vectors a thread."""
    nv = k // 8
    team = 32
    while -(-nv // team) > ROW_MAX_VECS:
        team *= 2
    if team > ROW_THREADS:
        raise ValueError(f"a dense row of {k} elements is more than the row quantize takes")
    return team, -(-nv // team)


def absmax_chunks(groups: int, group_elems: int, sms: int) -> Tuple[int, int]:
    """(chunk, chunks): a convolution's absmax as about 2 blocks an SM, at
    most MAX_CHUNKS a group, a chunk a multiple of the block's 2048-element
    sweep (256 threads x 8)."""
    want = max(1, min(MAX_CHUNKS, -(-2 * sms // groups)))
    sweep = ABSMAX_THREADS * 8
    chunk = -(-(-(-group_elems // want)) // sweep) * sweep
    return chunk, -(-group_elems // chunk)


def route_costs(vb: int, oh: int, ow: int, cin: int, cout: int, kh: int, kw: int,
                stride: int, n: int, sms: int = H100_SMS):
    """A convolution's two routes, each its GEMM plan and modelled time in
    conv_plan's units: "loader", the tiles planned with the conversions
    (CONVERT_STEP_UNITS a k step) and bf16 A; "separate", the int8 tiles plus
    the quantize pass's bytes (QUANTIZE_BYTES an element of x) and its launch
    at the host's cost."""
    loader = conv_plan(vb, oh, ow, cin, cout, kh, kw, stride, 1, "xla", sms,
                       DYNAMIC_LAUNCH_UNITS, CONVERT_STEP_UNITS)
    separate = conv_plan(vb, oh, ow, cin, cout, kh, kw, stride, 1, "xla", sms,
                         DYNAMIC_LAUNCH_UNITS)
    return {"loader": (loader, loader.cost),
            "separate": (separate, separate.cost + QUANTIZE_BYTES * n / SPLIT_BYTES_PER_UNIT
                         + DYNAMIC_LAUNCH_UNITS)}


def route_plan(route: str, b: int, h: int, w: int, cin: int, cout: int, kh: int, kw: int,
               stride: int, padding: int, sms: int = H100_SMS) -> DynamicPlan:
    """The DynamicPlan of one launch on `route` (one of ROUTES; "small" and
    "rows" take a dense layer, x [1, 1, rows, K] as a 1x1 convolution, the
    others a convolution of at most MAX_GROUPS batch items). dynamic_plan
    picks the route; chip_smoke.py and scripts/time_dynamic.py build the
    others too, to check and time every route at one shape."""
    vb, vh, vw = flat_view(b, h, w, kh, kw, stride, padding)
    oh, ow = conv_out_hw(vh, vw, kh, stride, padding)
    n = b * h * w * cin
    if route in ("small", "rows"):
        rows = b * h * w
        if route == "small":
            if rows > SMALL_ROWS or cin > SMALL_MAX_K:
                raise ValueError(f"the small route takes at most {SMALL_ROWS} rows of at most "
                                 f"{SMALL_MAX_K}, got {rows} of {cin}")
            return DynamicPlan("small", None, rows, cin, 1, 0, 0, 0, 0, small_smem_bytes(cin),
                               0, 1)
        team, vecs = row_team(cin)
        plan = conv_plan(vb, oh, ow, cin, cout, kh, kw, stride, 1, "xla", sms,
                         DYNAMIC_LAUNCH_UNITS)
        return DynamicPlan("rows", plan, rows, cin, 1, 0, 0, team, vecs,
                           conv_smem_bytes(plan.bn, False), -(-n // 128) * 128 + 4 * rows,
                           2 + (plan.splits > 1))
    if route not in ("loader", "separate"):
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if b > MAX_GROUPS:
        raise ValueError(f"one launch of a dynamic convolution takes at most {MAX_GROUPS} batch "
                         f"items, got {b} (dynamic_chunks cuts a call)")
    plan = route_costs(vb, oh, ow, cin, cout, kh, kw, stride, n, sms)[route][0]
    chunk, chunks = absmax_chunks(b, h * w * cin, sms)
    oh_, ow_ = conv_out_hw(h, w, kh, stride, padding)
    slots = 4 * b * chunks
    if route == "loader":
        return DynamicPlan("loader", plan, b, h * w * cin, oh_ * ow_, chunk, chunks, 0, 0,
                           conv_smem_bytes(plan.bn, True), slots, 2 + (plan.splits > 1))
    return DynamicPlan("separate", plan, b, h * w * cin, oh_ * ow_, chunk, chunks, 0, 0,
                       conv_smem_bytes(plan.bn, False), -(-n // 128) * 128 + slots,
                       3 + (plan.splits > 1))


@functools.lru_cache(maxsize=1024)
def dynamic_plan(b: int, h: int, w: int, cin: int, cout: int, kh: int, kw: int, stride: int,
                 padding: int, per_row: bool, sms: int = H100_SMS) -> DynamicPlan:
    """The route of one launch of a dynamic call over x [b, h, w, cin] (a
    dense layer: per_row, x [1, 1, rows, K]; a convolution: at most
    MAX_GROUPS items, see dynamic_chunks) and its parameters (route_plan).

    Dense layers: at most SMALL_ROWS rows (the cross-attention's key and
    value projections: 4 rows at batch 2, 32 at 16; the time embeddings)
    take "small" while their K fits shared memory (K <= 2048), the others
    "rows". Convolutions: the 3x3 stride-1 ones take "separate" (each input
    element is loaded nine times a tile of output channels); the 1x1 and
    stride-2 ones take the route route_costs models faster. With the costs
    measured on the H100 that is "loader" at the flagship's 1x1 shortcuts
    (the UNet's 640 -> 320, the VAE's 256 -> 128 and 512 -> 256) and at the
    VAE's 128-channel stride 2, at batch 2 and 16, and at the UNet's
    640-channel stride 2 at batch 2 (its loader plan has one launch fewer);
    "separate" at the UNet's other stride-2 convs and the VAE's 256- and
    512-channel ones (an element loaded 2.25 times by each of two or more
    tiles of output channels: the conversions cost more than the pass). The
    GEMM's tiles come from conv_plan with a launch at the host's cost, so a
    split must save more than its sum launch costs the host."""
    if per_row:
        route = "small" if b * h * w <= SMALL_ROWS and cin <= SMALL_MAX_K else "rows"
    else:
        vb, vh, vw = flat_view(b, h, w, kh, kw, stride, padding)
        oh, ow = conv_out_hw(vh, vw, kh, stride, padding)
        costs = route_costs(vb, oh, ow, cin, cout, kh, kw, stride, b * h * w * cin, sms)
        route = "loader" if kh * kw / stride ** 2 <= LOADER_MAX_TAP_LOADS and \
            costs["loader"][1] < costs["separate"][1] else "separate"
    return route_plan(route, b, h, w, cin, cout, kh, kw, stride, padding, sms)


@functools.lru_cache(maxsize=256)
def dynamic_chunks(b: int, per_row: bool) -> Tuple[Tuple[int, int], ...]:
    """The batch items [start, stop) of each launch of a dynamic call. A
    convolution's launch keeps its items' scales in a table of MAX_GROUPS in
    shared memory (csrc/sm90_conv.cuh, csrc/act_quantize.cuh), and its items
    are independent scale groups, so a larger batch runs as consecutive
    launches of at most MAX_GROUPS items; a dense layer's rows keep their
    scales in global memory and go in one."""
    step = b if per_row else MAX_GROUPS
    return tuple((i, min(i + step, b)) for i in range(0, b, step))


def _dynamic_ints(plan: DynamicPlan, b, h, w, cin, cout, kh, kw, stride, padding):
    """The two int arrays the C entry point takes: the GEMM's (launch_ints'
    layout; for "small", its geometry) and the route's [route, group_elems,
    group_pixels, chunk, chunks, team, vecs, groups]."""
    vb, vh, vw = flat_view(b, h, w, kh, kw, stride, padding)
    oh, ow = conv_out_hw(vh, vw, kh, stride, padding)
    tiles = plan.conv or ConvPlan((1, 1, 1), SMALL_BN, 1, 1, 1, 0)
    values = (vb, vh, vw, cin, oh, ow, cout, kh, kw, stride, padding, padding, *tiles.box,
              tiles.bn, tiles.splits, tiles.per, 0, 0)
    dyn = (ROUTES.index(plan.route), plan.group_elems, plan.group_pixels, plan.chunk,
           plan.chunks, plan.team, plan.vecs, plan.groups)
    return (ctypes.c_int * len(values))(*values), (ctypes.c_int * len(dyn))(*dyn)


@functools.lru_cache(maxsize=1024)
def dynamic_launch_ints(b, h, w, cin, cout, kh, kw, stride, padding, per_row, device):
    """A launch's plan (dynamic_plan) and its two int arrays (_dynamic_ints),
    built once per call signature."""
    plan = dynamic_plan(b, h, w, cin, cout, kh, kw, stride, padding, per_row,
                        _build.sm_count(device.index))
    return (plan, *_dynamic_ints(plan, b, h, w, cin, cout, kh, kw, stride, padding))


def conv2d_int8_acc_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                          padding: int) -> torch.Tensor:
    """The exact int32 sums: NHWC int8 xq [B, H, W, Cin], wq [Cout, KH, KW,
    Cin] -> [B, OH, OW, Cout], through a float64 convolution (exact below
    2^53; an fp32 one stops being exact past 2^24)."""
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(),
                   stride=stride, padding=padding)
    return acc.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def conv2d_int8_halo_sum_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                               padding: int) -> torch.Tensor:
    """The "halo" epilogue's fp32 sum: per row of taps (ky) the exact int32
    partial (the convolution with the other rows' weights zeroed), converted
    to fp32 and added in ky order to an fp32 sum that starts at 0."""
    total = torch.zeros((), dtype=torch.float32)
    for ky in range(wq.shape[1]):
        w_row = torch.zeros_like(wq)
        w_row[:, ky] = wq[:, ky]
        total = total + conv2d_int8_acc_plain(xq, w_row, stride, padding).float()
    return total


def conv2d_int8_plain(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, act_scale: float,
                      bias: Optional[torch.Tensor], stride: int, padding: int,
                      epilogue: str = "xla",
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: quantize x at `act_scale`, exact
    int32 sums, dequantize in fp32 in the order of `epilogue`, cast to
    `out_dtype` (default x's type), bias added in that type."""
    xq = quantize_int8_plain(x, act_scale)
    act = torch.tensor(fp32(act_scale), dtype=torch.float32, device=x.device)
    if epilogue == "halo":
        out = conv2d_int8_halo_sum_plain(xq, wq, stride, padding) * (act * ws)
    else:
        acc = conv2d_int8_acc_plain(xq, wq, stride, padding).float()
        out = acc * act * ws if epilogue == "xla" else acc * (act * ws)
    out = out.to(out_dtype or x.dtype)
    return out if bias is None else out + bias.to(out.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load("conv2d_int8")
    fn = lib.d3r_conv2d_int8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(x, wq, ws, bias, epilogue) -> None:
    if x.ndim != 4 or wq.ndim != 4 or wq.shape[3] != x.shape[3]:
        raise ValueError(f"conv2d_int8 takes NHWC x and wq [Cout, KH, KW, Cin], got "
                         f"{tuple(x.shape)} and {tuple(wq.shape)}")
    if wq.dtype != torch.int8 or ws.dtype != torch.float32 or ws.shape != (wq.shape[0],):
        raise TypeError("conv2d_int8 takes int8 wq and fp32 ws [Cout]")
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    for name, t in (("wq", wq), ("ws", ws), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _check_cuda(x, wq, ws, bias, out_dtype=None) -> None:
    cin, cout = x.shape[3], wq.shape[0]
    out_dtype = out_dtype or x.dtype
    if x.dtype != torch.bfloat16 or out_dtype not in (torch.bfloat16, torch.float32) \
            or (out_dtype == torch.float32 and bias is not None):
        raise TypeError(f"the CUDA int8 conv kernel takes bf16 x and writes bf16 (or fp32 "
                        f"without bias), got {x.dtype} -> {out_dtype}, bias {bias is not None}")
    if cin % 32 or cout % 2:
        raise ValueError(f"the CUDA int8 conv kernel takes Cin % 32 == 0 and Cout % 2 == 0, "
                         f"got Cin={cin}, Cout={cout}")
    if bias is not None and (bias.dtype != torch.bfloat16 or bias.shape != (cout,)):
        raise TypeError("the CUDA int8 conv kernel takes a bf16 bias [Cout]")
    for name, t in (("wq", wq), ("ws", ws), ("bias", bias)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if x.numel() > 2**31 - 1:
        raise ValueError("x is too large for the kernel's 32-bit pixel index")


def conv2d_int8(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, act_scale: float,
                bias: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 0,
                epilogue: str = "xla", out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Static int8 convolution, NHWC x [B, H, W, Cin] -> [B, OH, OW, Cout] in
    `out_dtype` (default x's type), with symmetric zero `padding`, in the
    order of arithmetic of `epilogue` (one of EPILOGUES).

    CUDA tensors go to the Hopper kernel (bf16 x and bias, a bf16 output or
    an fp32 one without bias, Cin % 32 == 0, Cout % 2 == 0), whose C entry
    point quantizes x into the stream's int8 workspace (act_workspace) and
    then runs the convolution, in one call; or raise. CPU tensors take the
    plain version.
    `conv2d_int8.launches` counts the calls that went through this wrapper,
    `conv2d_int8.epilogue_launches[epilogue]` those of each epilogue, and
    `quantize_int8_scalar.launches` their quantizations."""
    _check(x, wq, ws, bias, epilogue)
    if x.device.type == "cpu":
        _count(epilogue)
        return conv2d_int8_plain(x, wq, ws, act_scale, bias, stride, padding, epilogue,
                                 out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_int8 runs on CUDA or the CPU, got {x.device}")
    _check_cuda(x, wq, ws, bias, out_dtype)
    x = x.contiguous()
    b, h, w, cin = x.shape
    cout, kh, kw, _ = wq.shape
    oh, ow = conv_out_hw(h, w, kh, stride, padding)
    out_dtype = out_dtype or x.dtype
    plan, ints = launch_ints(b, h, w, cin, cout, kh, kw, stride, padding, 1, epilogue,
                             out_dtype == torch.float32, x.device)
    out = torch.empty((b, oh, ow, cout), dtype=out_dtype, device=x.device)
    work = plan_workspace(plan, x.device)
    stream = _build.current_stream(x.device)
    with torch.cuda.device(x.device):
        err = _library().d3r_conv2d_int8(
            x.data_ptr(), act_workspace(x.device, stream, x.numel()), wq.data_ptr(),
            ws.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), ints, act_scale, stream)
    _build.check(err, "conv2d_int8")
    _count(epilogue)
    return out


def conv2d_int8_dynamic_plain(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                              bias: Optional[torch.Tensor], stride: int, padding: int,
                              per_row: bool = False) -> torch.Tensor:
    """The dynamic kernel's arithmetic in PyTorch: the scale s of each batch
    item of x (of each pixel, with per_row) from dynamic_scale_plain, x
    quantized at it (IEEE division), exact int32 sums, (acc * s) * ws in
    fp32, one cast to x's type, the bias added in that type."""
    s = dynamic_scale_plain(x, (3,) if per_row else (1, 2, 3))
    acc = conv2d_int8_acc_plain(quantize_int8_plain(x, s), wq, stride, padding).float()
    out = (acc * s * ws).to(x.dtype)
    return out if bias is None else out + bias.to(out.dtype)


def _library_dynamic() -> ctypes.CDLL:
    lib = _library()
    fn = lib.d3r_conv2d_int8_dynamic
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int)] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def conv2d_int8_dynamic(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 0,
                        per_row: bool = False) -> torch.Tensor:
    """Dynamic int8 convolution, NHWC x [B, H, W, Cin] -> [B, OH, OW, Cout]
    in x's type: each batch item of x (each pixel, with per_row: a dense
    layer's rows, as a 1x1 convolution without padding) quantized at its
    own scale max(absmax * fp32(1/127), 1e-8), the output dequantized as
    (acc * s) * ws[co] (the "xla" order), the bias added after the cast.

    CUDA tensors go to the kernels (bf16 x and bias, Cin % 32 == 0, Cout % 2
    == 0) with no host synchronization, by the route dynamic_plan picks: one
    launch for the small dense layers; the row quantize and the GEMM for
    the others; the absmax and the convolution quantizing in its loader, or
    the absmax, a quantize pass and the convolution, for a convolution (one
    host call of the C entry point for each chunk of at most MAX_GROUPS
    batch items, dynamic_chunks). The scales and x's int8 copy go to the
    stream's int8 workspace; or raise. CPU tensors take the plain version.
    `conv2d_int8_dynamic.launches` counts the calls."""
    if per_row and (wq.shape[1:3] != (1, 1) or stride != 1 or padding != 0):
        raise ValueError("per_row takes a 1x1 convolution of stride 1 without padding")
    _check(x, wq, ws, bias, "xla")
    if x.device.type == "cpu":
        conv2d_int8_dynamic.launches += 1
        return conv2d_int8_dynamic_plain(x, wq, ws, bias, stride, padding, per_row)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_int8_dynamic runs on CUDA or the CPU, got {x.device}")
    _check_cuda(x, wq, ws, bias)
    x = x.contiguous()
    if x.data_ptr() % 16:  # every route reads x 16 bytes at a time (TMA, vector loads)
        x = x.clone()
    b, h, w, cin = x.shape
    cout, kh, kw, _ = wq.shape
    oh, ow = conv_out_hw(h, w, kh, stride, padding)
    out = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    for i, j in dynamic_chunks(b, per_row):
        xi, oi = (x, out) if j - i == b else (x[i:j], out[i:j])
        _dynamic_launch(xi, wq, ws, bias, oi, *dynamic_launch_ints(
            j - i, h, w, cin, cout, kh, kw, stride, padding, per_row, x.device))
    conv2d_int8_dynamic.launches += 1
    return out


def _dynamic_launch(x, wq, ws, bias, out, plan: DynamicPlan, ints, dyn) -> None:
    """One host call of the C entry point over contiguous, 16-byte aligned x
    and out (a convolution's at most MAX_GROUPS items)."""
    work = None if plan.conv is None else plan_workspace(plan.conv, x.device)
    stream = _build.current_stream(x.device)
    base = act_workspace(x.device, stream, max(plan.workspace_bytes, 16))
    with torch.cuda.device(x.device):
        err = _library_dynamic().d3r_conv2d_int8_dynamic(
            x.data_ptr(), base, wq.data_ptr(), ws.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), ints, dyn, stream)
    _build.check(err, "conv2d_int8_dynamic")


def _dynamic_on_route(route: str, x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, stride: int = 1,
                      padding: int = 0) -> torch.Tensor:
    """conv2d_int8_dynamic's CUDA call on `route` (route_plan) instead of
    the one dynamic_plan picks, so that chip_smoke.py checks and
    scripts/time_dynamic.py times each route at one shape ("small" and
    "rows": x [1, 1, rows, K]; the others at most MAX_GROUPS items). No model
    path calls it, and it counts no launch."""
    _check(x, wq, ws, bias, "xla")
    if x.device.type != "cuda":
        raise ValueError(f"_dynamic_on_route runs on CUDA, got {x.device}")
    _check_cuda(x, wq, ws, bias)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    b, h, w, cin = x.shape
    cout, kh, kw, _ = wq.shape
    if route in ("small", "rows") and (b, h, kh, kw, stride, padding) != (1, 1, 1, 1, 1, 0):
        raise ValueError("a dense route takes x [1, 1, rows, K] and a 1x1 wq")
    plan = route_plan(route, b, h, w, cin, cout, kh, kw, stride, padding,
                      _build.sm_count(x.device.index))
    oh, ow = conv_out_hw(h, w, kh, stride, padding)
    out = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    _dynamic_launch(x, wq, ws, bias, out, plan,
                    *_dynamic_ints(plan, b, h, w, cin, cout, kh, kw, stride, padding))
    return out


conv2d_int8_dynamic.launches = 0


def plan_workspace(plan: ConvPlan, device) -> Optional[torch.Tensor]:
    """The partial sums of a split call (None when unsplit)."""
    if not plan.workspace_bytes:
        return None
    return torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=device)


def _count(epilogue: str) -> None:
    conv2d_int8.launches += 1
    conv2d_int8.epilogue_launches[epilogue] += 1
    quantize_int8_scalar.launches += 1


def reset_conv2d_int8_launches() -> None:
    conv2d_int8.launches = 0
    conv2d_int8.epilogue_launches = dict.fromkeys(EPILOGUES, 0)


reset_conv2d_int8_launches()


# ---------------------------------------------------------------------------
# bf16


def conv2d_bf16_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 1,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: x [B, H, W, Cin] and w [Cout, KH,
    KW, Cin] in their own type (bf16 products are exact in fp32), the sums in
    fp32 (or wider, for wider inputs), one cast to `out_dtype` (default x's
    type)."""
    dt = torch.promote_types(torch.promote_types(x.dtype, w.dtype), torch.float32)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # cuDNN's default on CUDA rounds fp32 to TF32
    try:
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), w.permute(0, 3, 1, 2).to(dt),
                     stride=stride, padding=padding)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return y.permute(0, 2, 3, 1).to(out_dtype or x.dtype)


def _library_bf16() -> ctypes.CDLL:
    lib = _build.load("conv2d_bf16")
    fn = lib.d3r_conv2d_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_bf16(x, w, out_dtype) -> None:
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 \
            or (out_dtype or x.dtype) != torch.bfloat16:
        raise TypeError(f"the CUDA bf16 conv kernel takes bf16 x and w and writes bf16, got "
                        f"{x.dtype}, {w.dtype} -> {out_dtype or x.dtype}")
    if x.shape[3] % 32 or w.shape[0] % 2:
        raise ValueError(f"the CUDA bf16 conv kernel takes Cin % 32 == 0 and Cout % 2 == 0, "
                         f"got Cin={x.shape[3]}, Cout={w.shape[0]}")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError("w must be contiguous and 16-byte aligned")
    if x.is_contiguous() and x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (TMA reads it)")
    if x.numel() > 2**31 - 1:
        raise ValueError("x is too large for the kernel's 32-bit pixel index")


def conv2d_bf16(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 1,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """bf16 convolution without bias, NHWC x [B, H, W, Cin] and w [Cout, KH,
    KW, Cin] -> [B, OH, OW, Cout] in `out_dtype` (default x's type): fp32
    sums of the products, one rounding.

    CUDA tensors go to the Hopper kernel (bf16 in and out, Cin % 32 == 0,
    Cout % 2 == 0) or raise; CPU tensors take the plain version.
    `conv2d_bf16.launches` counts the calls."""
    if x.ndim != 4 or w.ndim != 4 or w.shape[3] != x.shape[3]:
        raise ValueError(f"conv2d_bf16 takes NHWC x and w [Cout, KH, KW, Cin], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.device.type == "cpu":
        conv2d_bf16.launches += 1
        return conv2d_bf16_plain(x, w, stride, padding, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_bf16 runs on CUDA or the CPU, got {x.device}")
    x = x.contiguous()
    _check_cuda_bf16(x, w, out_dtype)
    b, h, wd, cin = x.shape
    cout, kh, kw, _ = w.shape
    oh, ow = conv_out_hw(h, wd, kh, stride, padding)
    plan, ints = launch_ints(b, h, wd, cin, cout, kh, kw, stride, padding, 2, "bf16", False,
                             x.device)
    out = torch.empty((b, oh, ow, cout), dtype=torch.bfloat16, device=x.device)
    work = plan_workspace(plan, x.device)
    with torch.cuda.device(x.device):
        err = _library_bf16().d3r_conv2d_bf16(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(),
            ints, _build.current_stream(x.device))
    _build.check(err, "conv2d_bf16")
    conv2d_bf16.launches += 1
    return out


conv2d_bf16.launches = 0


# ---------------------------------------------------------------------------
# The JAX package's entry points and gates (d3roma_tpu/ops/pallas/conv2d.py,
# conv2d_halo.py). Layouts as there: NHWC x, HWIO w.

# One batch item's flattened frame must fit VMEM next to the weight block,
# the int32 accumulator and the output block (~16 MB/core total).
_MAX_X_BLOCK_BYTES = 4 * 1024 * 1024
_MAX_XCAT_BYTES = 5 * 1024 * 1024
_LANES = 128


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _same_3x3(x_shape, w_shape, strides, padding) -> bool:
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    if tuple(w_shape[:2]) != (3, 3) or tuple(strides) != (1, 1):
        return False
    if not isinstance(padding, str):
        pad = tuple(tuple(p) for p in padding)
        if pad != ((1, 1), (1, 1)):
            return False
    elif padding != "SAME":
        return False
    return True


def conv3x3_supported(x_shape, w_shape, strides, padding, dtype) -> bool:
    """Gate: stride-1 SAME 3x3, one frame small enough to hold in VMEM (the
    TPU kernel's arithmetic; w in HWIO order, `dtype` a torch dtype)."""
    if not _same_3x3(x_shape, w_shape, strides, padding):
        return False
    _, h, w, cin = x_shape
    m_pad = (h + 2) * (w + 2)
    return m_pad * cin * _itemsize(dtype) <= _MAX_X_BLOCK_BYTES


def conv3x3_rowtap_supported(x_shape, w_shape, strides, padding) -> bool:
    """Gate for conv3x3_rowtap: stride-1 SAME 3x3 with the dx-concat frame
    small enough to hold in VMEM (int8)."""
    if not _same_3x3(x_shape, w_shape, strides, padding):
        return False
    _, h, w, cin = x_shape
    w_eff = -(-w // 32) * 32
    return (h + 2) * w_eff * 3 * cin <= _MAX_XCAT_BYTES


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _row_align(itemsize: int) -> int:
    # Mosaic sublane tile: (8,128) for 16/32-bit, (32,128) for int8.
    return 32 if itemsize == 1 else 8


def halo_conv_supported(x_shape, w_shape, strides, padding, itemsize: int = 1,
                        block_m: int = 512) -> bool:
    """Stride-1 SAME 3x3 with the per-block working set inside VMEM (the TPU
    kernel's arithmetic, channels padded to 128)."""
    if not _same_3x3(x_shape, w_shape, strides, padding):
        return False
    cin, cout = w_shape[2], w_shape[3]
    if cin % 8 or cout % 8:
        return False
    if block_m % _row_align(itemsize):
        return False
    cin_p, cout_p = _round_up(cin, _LANES), _round_up(cout, _LANES)
    bufs = 3 * block_m * 3 * cin_p * itemsize    # dy tap windows
    wts = 3 * 3 * cin_p * cout_p * itemsize      # resident weights
    acc = block_m * cout_p * 4                   # f32 accumulator
    out = block_m * cout_p * 2
    return bufs + wts + acc + out <= 11 * 1024 * 1024


def _int8_3x3(x, w, act_scale, out_dtype, epilogue):
    """HWIO w quantized as every int8 layer of the port quantizes its
    weights (absmax over every tap and input channel)."""
    wq, ws = quantize_weight(w.permute(3, 0, 1, 2))
    return conv2d_int8(x, wq, ws, fp32(act_scale), None, 1, 1, epilogue,
                       out_dtype or x.dtype)


def conv3x3_flat(x: torch.Tensor, w: torch.Tensor, quant: Optional[str] = None,
                 act_scale: float = _STATIC_ACT_SCALE,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv, NHWC x and HWIO w -> NHWC in `out_dtype`
    (default x's type). quant=None: the products in x's type, fp32 sums (the
    bf16 kernel). quant="static": int8 with the static activation scale and
    per-output-channel weight scales, dequantized as acc * (act_scale * ws)
    (the int8 kernel's "tpu" epilogue). The kernel wrappers count the
    launches."""
    if quant not in (None, "static"):
        raise ValueError(f"quant must be None or 'static', got {quant!r}")
    if quant == "static":
        return _int8_3x3(x, w, act_scale, out_dtype, "tpu")
    return conv2d_bf16(x, w.permute(3, 0, 1, 2).to(x.dtype).contiguous(), 1, 1, out_dtype)


def conv3x3_rowtap(x: torch.Tensor, w: torch.Tensor, act_scale: float = _STATIC_ACT_SCALE,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stride-1 SAME 3x3 int8 conv, NHWC x and HWIO w: the TPU row-tap
    kernel's integers (dx folded into channels, one exact int32 sum over the
    three dy GEMMs) and its dequantization acc * (act_scale * ws), which are
    conv3x3_flat's: the int8 kernel's "tpu" epilogue. No path of the port
    calls it."""
    return _int8_3x3(x, w, act_scale, out_dtype, "tpu")


def conv3x3_halo(x: torch.Tensor, w: torch.Tensor, quant: Optional[str] = "static",
                 act_scale: float = _STATIC_ACT_SCALE,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[B, H, W, Cin] x [3, 3, Cin, Cout] -> [B, H, W, Cout], stride-1 SAME,
    in `out_dtype` (default x's type). quant="static": int8, one int32
    partial per row of taps added in fp32, times act_scale * ws (the int8
    kernel's "halo" epilogue). quant=None: x and w rounded to bf16, fp32
    sums (the bf16 kernel). The kernel wrappers count the launches."""
    if quant not in (None, "static"):
        raise ValueError(f"quant must be None or 'static', got {quant!r}")
    if quant == "static":
        return _int8_3x3(x, w, act_scale, out_dtype, "halo")
    wb = w.permute(3, 0, 1, 2).to(torch.bfloat16).contiguous()
    return conv2d_bf16(x.to(torch.bfloat16), wb, 1, 1, out_dtype or x.dtype)
