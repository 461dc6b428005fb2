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
  that scale.
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
    [splits, pixels, Cout] (int32 or fp32) when split, else 0."""
    box: Tuple[int, int, int]
    bn: int
    splits: int
    per: int
    k_steps: int
    workspace_bytes: int


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


@functools.lru_cache(maxsize=1024)
def conv_plan(b: int, oh: int, ow: int, cin: int, cout: int, kh: int, kw: int, stride: int,
              itemsize: int, epilogue: str, sms: int = H100_SMS) -> ConvPlan:
    """The tiles of one call on a card with `sms` SMs, over the output
    [b, oh, ow, cout] of the view the kernel sees (flat_view): the box
    (conv_box), and the tile width and split of K with the least modelled
    time. The model is geglu_plan's, whose GEMMs share the mainloop: a tile
    costs its k steps, plus TILE_STAGES for the fill and the epilogue, times
    the rows it loads a step (BLOCK_ROWS of A and bn of B, 128 bytes each),
    by waves of tiles over the SMs; a split adds its partial sums' round
    trip and a launch. epilogue: "xla", "tpu", "halo" (int8, itemsize 1) or
    "bf16" (itemsize 2). "halo" splits only at rows of taps (ky), so that
    each split's fp32 partial is its rows' sum and the splits add up in ky
    order."""
    bw, bh, bb = conv_box(b, oh, ow, stride)
    m_tiles = -(-ow // bw) * -(-oh // bh) * -(-b // bb)
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
            tiles = m_tiles * -(-cout // bn) * s
            waves = -(-tiles // sms)
            split = ((s + 1) * 4 * pixels * cout / SPLIT_BYTES_PER_UNIT + SPLIT_LAUNCH_UNITS
                     if s > 1 else 0)
            cost = waves * (per + TILE_STAGES) * (BLOCK_ROWS + bn) + split
            options.append(((cost, s, -bn), (bn, s, per)))
    bn, splits, per = min(options)[1]
    return ConvPlan((bw, bh, bb), bn, splits, per, k_steps,
                    4 * splits * pixels * cout if splits > 1 else 0)


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
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
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

    CUDA tensors go to the kernel (bf16 x and bias, Cin % 32 == 0, Cout % 2
    == 0): its C entry point computes the scales on the device (memset,
    absmax), quantizes x into the stream's int8 workspace, and runs the
    convolution, in one call with no host synchronization; or raise. CPU
    tensors take the plain version. `conv2d_int8_dynamic.launches` counts
    the calls."""
    _check(x, wq, ws, bias, "xla")
    if per_row and (wq.shape[1:3] != (1, 1) or stride != 1 or padding != 0):
        raise ValueError("per_row takes a 1x1 convolution of stride 1 without padding")
    if x.device.type == "cpu":
        conv2d_int8_dynamic.launches += 1
        return conv2d_int8_dynamic_plain(x, wq, ws, bias, stride, padding, per_row)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_int8_dynamic runs on CUDA or the CPU, got {x.device}")
    _check_cuda(x, wq, ws, bias)
    x = x.contiguous()
    b, h, w, cin = x.shape
    cout, kh, kw, _ = wq.shape
    oh, ow = conv_out_hw(h, w, kh, stride, padding)
    plan, ints = launch_ints(b, h, w, cin, cout, kh, kw, stride, padding, 1, "xla", False,
                             x.device)
    out = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    work = plan_workspace(plan, x.device)
    stream = _build.current_stream(x.device)
    group_elems, group_pixels = (cin, 1) if per_row else (h * w * cin, oh * ow)
    # the workspace: x's int8 copy, then the groups' absmax (fp32 bits)
    amax_at = -(-x.numel() // 128) * 128
    base = act_workspace(x.device, stream, amax_at + 4 * (x.numel() // group_elems))
    with torch.cuda.device(x.device):
        err = _library_dynamic().d3r_conv2d_int8_dynamic(
            x.data_ptr(), base, base + amax_at, wq.data_ptr(), ws.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), ints, group_elems, group_pixels, stream)
    _build.check(err, "conv2d_int8_dynamic")
    conv2d_int8_dynamic.launches += 1
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
