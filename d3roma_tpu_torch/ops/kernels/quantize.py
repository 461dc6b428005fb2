"""Static int8 quantization of an activation: the CUDA kernel, its plain
PyTorch version, its launch counter and the int8 workspace the consumers
quantize into; and the per-output-channel weight quantization every int8 op
of the port shares.

The JAX package leaves this elementwise step to XLA
(`d3roma_tpu/ops/quant.py::quantize_int8`), which fuses it into the op that
produces the activation. The kernel is `csrc/act_quantize.cuh`. It runs in
front of every static int8 dense, convolution, fused GEGLU and fused
self-attention of the port, launched by those ops' own C entry points
(their first kernel a dependent launch on it), so a consumer makes one host
call; `quantize_int8_scalar` is its standalone entry (`csrc/quantize.cu`).
Every int8 op counts its quantize on `quantize_int8_scalar.launches`, on the
card and on the CPU alike.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from d3roma_tpu_torch.ops.kernels import _build


def fp32(value: float) -> float:
    """`value` rounded to fp32 (as jnp.float32(scale) does), as a python float."""
    return float(np.float32(value))


def ieee_div(x: torch.Tensor, value: float) -> torch.Tensor:
    """x / fp32(value), an IEEE division on every device: the divisor is a
    0-d tensor, since PyTorch on CUDA multiplies by the reciprocal of a
    python scalar divisor, which moves quantization ties."""
    return torch.div(x, torch.tensor(fp32(value), dtype=torch.float32, device=x.device))


def quantize_int8_plain(x: torch.Tensor, scale) -> torch.Tensor:
    """clip(round_half_even(x / scale), -127, 127) as int8, with an IEEE
    division. `scale` is a tensor that broadcasts against x or a python
    float (taken as fp32)."""
    xf = x.float()
    q = torch.round(torch.div(xf, scale) if isinstance(scale, torch.Tensor)
                    else ieee_div(xf, scale))
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


# fp32(1/127): the jitted JAX form of absmax / 127 multiplies by it
INV127 = fp32(1.0 / 127.0)


def dynamic_scale_plain(x: torch.Tensor, dims) -> torch.Tensor:
    """The dynamic int8 modes' activation scale of each group of x (the
    elements sharing every index outside `dims`), kept-dims fp32:
    max(absmax * fp32(1/127), 1e-8), as the JAX package's jitted
    `absmax_scale` computes it (XLA turns its division by 127 into this
    product)."""
    m = x.detach().float().abs().amax(dim=tuple(dims), keepdim=True)
    return torch.clamp_min(m * INV127, 1e-8)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel (dim 0) int8 weights and their fp32 scales [Cout],
    both contiguous: the scale is the absmax over every other axis times
    fp32(1/127), >= 1e-8. The JAX package divides the absmax by 127 (over
    all but the last axis of its [..., Cout] kernels); inside its jitted
    forward, the form its bench runs, XLA turns that division by a constant
    into this product with the fp32 reciprocal (an eager JAX call divides,
    and can differ in the last place)."""
    w = w.detach()
    m = w.float().abs().amax(dim=tuple(range(1, w.ndim)))
    s = torch.clamp_min(m * INV127, 1e-8)
    wq = quantize_int8_plain(w, s.reshape((-1,) + (1,) * (w.ndim - 1)))
    return wq.contiguous(), s.contiguous()


def _library() -> ctypes.CDLL:
    lib = _build.load("quantize")
    fn = lib.d3r_quantize_int8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def quantize_int8_scalar(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x (bf16 or fp32) -> int8 of the same shape, with one scale for the
    whole tensor. CUDA tensors go to the kernel or raise; CPU tensors take
    the plain version. `quantize_int8_scalar.launches` counts the calls."""
    if x.device.type == "cpu":
        quantize_int8_scalar.launches += 1
        return quantize_int8_plain(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8_scalar runs on CUDA or the CPU, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA quantize kernel takes bf16 or fp32, got {x.dtype}")
    x = x.contiguous()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return q
    with torch.cuda.device(x.device):
        err = _library().d3r_quantize_int8(
            x.data_ptr(), q.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16),
            fp32(scale), _build.current_stream(x.device))
    _build.check(err, "quantize_int8")
    quantize_int8_scalar.launches += 1
    return q


quantize_int8_scalar.launches = 0

# (device index, stream) -> (buffer, its bytes, its address)
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, int, int]] = {}


def act_workspace(device: torch.device, stream: int, nbytes: int) -> int:
    """The address of an int8 buffer of at least `nbytes` bytes on `device`
    for the int8 ops on `stream` (the raw handle) to quantize their
    activation into: one buffer a stream, reused by every call (in stream
    order, a call's quantize runs after the kernels of the call before have
    read it), grown to the next power of two (at least 1 MiB) when a call
    needs more. The old buffer goes back to PyTorch's caching allocator,
    which hands it out again only in that stream's order."""
    entry = _workspaces.get((device.index, stream))
    if entry is None or entry[1] < nbytes:
        size = 1 << max(20, (nbytes - 1).bit_length())
        buf = torch.empty(size, dtype=torch.int8, device=device)
        entry = (buf, size, buf.data_ptr())
        _workspaces[(device.index, stream)] = entry
    return entry[2]
