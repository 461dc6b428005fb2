"""int8 implicit-GEMM convolution: the CUDA kernel, its plain PyTorch
version, its gate and its launch counter.

Port of `d3roma_tpu/ops/pallas/conv2d.py::conv3x3_flat` (int8 path, kernel
body `_kernel_int8`), extended to every convolution the JAX package's static
int8 mode quantizes (`ops/quant.py::int8_conv_general_dilated_static`): 3x3
at stride 1 and 2, and 1x1. Both compute the same integers, so the kernel
serves them all. The kernel is `csrc/conv2d_int8.cu`; its source note says
what bounds it on the H100 and how it is built around that.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from d3roma_tpu_torch.ops.kernels import _build
from d3roma_tpu_torch.ops.kernels.quantize import quantize_int8_plain, quantize_int8_scalar


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


def conv2d_int8_plain(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, act_scale: float,
                      bias: Optional[torch.Tensor], stride: int, padding: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: quantize x at `act_scale`, exact
    int32 sums, (acc * act_scale) * ws in fp32, cast to x's type, bias added
    in that type."""
    acc = conv2d_int8_acc_plain(quantize_int8_plain(x, act_scale), wq, stride, padding)
    out = (acc.float() * act_scale * ws).to(x.dtype)
    return out if bias is None else out + bias.to(x.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load("conv2d_int8")
    fn = lib.d3r_conv2d_int8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(x, wq, ws, bias) -> None:
    if x.ndim != 4 or wq.ndim != 4 or wq.shape[3] != x.shape[3]:
        raise ValueError(f"conv2d_int8 takes NHWC x and wq [Cout, KH, KW, Cin], got "
                         f"{tuple(x.shape)} and {tuple(wq.shape)}")
    if wq.dtype != torch.int8 or ws.dtype != torch.float32 or ws.shape != (wq.shape[0],):
        raise TypeError("conv2d_int8 takes int8 wq and fp32 ws [Cout]")
    for name, t in (("wq", wq), ("ws", ws), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _check_cuda(x, wq, ws, bias) -> None:
    cin, cout = x.shape[3], wq.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA int8 conv kernel takes bf16 x, got {x.dtype}")
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
                bias: Optional[torch.Tensor] = None, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """Static int8 convolution, NHWC x [B, H, W, Cin] -> [B, OH, OW, Cout] in
    x's type, with symmetric zero `padding`.

    CUDA tensors go to the Hopper kernel (bf16 x and bias, Cin % 32 == 0,
    Cout % 2 == 0) or raise; CPU tensors take the plain version.
    `conv2d_int8.launches` counts the calls that went through this wrapper."""
    _check(x, wq, ws, bias)
    if x.device.type == "cpu":
        conv2d_int8.launches += 1
        return conv2d_int8_plain(x, wq, ws, act_scale, bias, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_int8 runs on CUDA or the CPU, got {x.device}")
    _check_cuda(x, wq, ws, bias)
    b, h, w, cin = x.shape
    cout, kh, kw, _ = wq.shape
    oh, ow = conv_out_hw(h, w, kh, stride, padding)
    xq = quantize_int8_scalar(x, act_scale)
    out = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().d3r_conv2d_int8(
            xq.data_ptr(), wq.data_ptr(), ws.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, h, w, cin, oh, ow, cout, kh, kw, stride, padding, padding,
            act_scale, _build.current_stream(x.device))
    _build.check(err, "conv2d_int8")
    conv2d_int8.launches += 1
    return out


conv2d_int8.launches = 0
