"""Implicit-GEMM convolutions: the int8 and the bf16 CUDA kernels, their
plain PyTorch versions, their gates and their launch counters, and the JAX
package's three 3x3 convolution entry points on top of them.

- `conv2d_int8` (`csrc/conv2d_int8.cu`) computes the int8 convolution of
  every static int8 mode in one of three epilogues, each the order of
  arithmetic of one reference: "xla", (acc * act_scale) * ws, the XLA int8
  convolution of quant="static" (`d3roma_tpu/ops/quant.py::
  int8_conv_general_dilated_static`), at 3x3 stride 1 and 2 and 1x1;
  "tpu", acc * (act_scale * ws), the Pallas kernels `conv3x3_flat`
  (`_kernel_int8`) and `conv3x3_rowtap` (`_kernel_rowtap_int8`); "halo",
  the same with the sum taken as `conv2d_halo.py::_kernel` takes it, one
  int32 partial per row of taps added in fp32.
- `conv2d_bf16` (`csrc/conv2d_bf16.cu`) is the bf16 convolution of
  `conv3x3_flat`'s `_kernel_bf16` and of `conv3x3_halo`'s bf16 body:
  bf16 products, fp32 sums, one rounding.
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
from typing import Optional

import torch
import torch.nn.functional as F

from d3roma_tpu_torch.ops.kernels import _build
from d3roma_tpu_torch.ops.kernels.quantize import (
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
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
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
    an fp32 one without bias, Cin % 32 == 0, Cout % 2 == 0) or raise; CPU
    tensors take the plain version.
    `conv2d_int8.launches` counts the calls that went through this wrapper,
    `conv2d_int8.epilogue_launches[epilogue]` those of each epilogue."""
    _check(x, wq, ws, bias, epilogue)
    if x.device.type == "cpu":
        _count(epilogue)
        return conv2d_int8_plain(x, wq, ws, act_scale, bias, stride, padding, epilogue,
                                 out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_int8 runs on CUDA or the CPU, got {x.device}")
    _check_cuda(x, wq, ws, bias, out_dtype)
    b, h, w, cin = x.shape
    cout, kh, kw, _ = wq.shape
    oh, ow = conv_out_hw(h, w, kh, stride, padding)
    xq = quantize_int8_scalar(x, act_scale)
    out = torch.empty((b, oh, ow, cout), dtype=out_dtype or x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().d3r_conv2d_int8(
            xq.data_ptr(), wq.data_ptr(), ws.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, h, w, cin, oh, ow, cout, kh, kw, stride, padding, padding,
            act_scale, EPILOGUES.index(epilogue), int(out.dtype == torch.float32),
            _build.current_stream(x.device))
    _build.check(err, "conv2d_int8")
    _count(epilogue)
    return out


def _count(epilogue: str) -> None:
    conv2d_int8.launches += 1
    conv2d_int8.epilogue_launches[epilogue] += 1


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
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
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
    _check_cuda_bf16(x, w, out_dtype)
    x = x.contiguous()
    b, h, wd, cin = x.shape
    cout, kh, kw, _ = w.shape
    oh, ow = conv_out_hw(h, wd, kh, stride, padding)
    out = torch.empty((b, oh, ow, cout), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = _library_bf16().d3r_conv2d_bf16(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, cin, oh, ow, cout, kh, kw,
            stride, padding, padding, _build.current_stream(x.device))
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
