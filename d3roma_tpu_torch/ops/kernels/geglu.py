"""Fused GEGLU feed-forward: the CUDA kernel, its plain PyTorch version, its
gate and its launch counter.

Port of `d3roma_tpu/ops/pallas/geglu.py::geglu_ff` (bf16 path, kernel body
`_kernel_bf16`). The kernel is `csrc/geglu.cu`; its source note says what
bounds it on the H100 and how it is built around that. The int8 path
(`_kernel_int8`) is not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from d3roma_tpu_torch.ops.kernels import _build

# widest output-column chunk one block accumulates in shared memory
_MAX_COLS = 640


def geglu_supported(c: int, f: int) -> bool:
    """The JAX package's gate, unchanged: F % 128 == 0, C <= 2048, F <= 8192."""
    return f % 128 == 0 and c <= 2048 and f <= 8192


def geglu_ff_plain(x, w1h, w1g, w2, b1h=None, b1g=None, b2=None) -> torch.Tensor:
    """The TPU kernel's arithmetic in PyTorch: h and gate in fp32 from the
    input-typed operands, fp32 biases, tanh gelu, the gated product cast to
    the input type, the second product accumulated in fp32 with b2, one cast
    at the end. x [B, N, C], w1h/w1g [C, F], w2 [F, C] -> [B, N, C]."""
    b, n, c = x.shape
    f = w1h.shape[1]
    dt = x.dtype
    zeros = x.new_zeros
    b1h = zeros(f, dtype=torch.float32) if b1h is None else b1h.float()
    b1g = zeros(f, dtype=torch.float32) if b1g is None else b1g.float()
    b2 = zeros(c, dtype=torch.float32) if b2 is None else b2.float()
    xf = x.reshape(b * n, c).float()
    h = torch.matmul(xf, w1h.to(dt).float()) + b1h
    g = torch.matmul(xf, w1g.to(dt).float()) + b1g
    y = (h * F.gelu(g, approximate="tanh")).to(dt)
    out = torch.matmul(y.float(), w2.to(dt).float()) + b2
    return out.to(dt).reshape(b, n, c)


def _output_chunk(c: int) -> int:
    """Output columns per block: all of C up to 640, else the widest
    multiple of 16 that divides C and is at most 640."""
    for cb in range(min(c, _MAX_COLS) // 16 * 16, 0, -16):
        if c % cb == 0:
            return cb
    raise ValueError(f"no output chunk for C={c}")


def _library() -> ctypes.CDLL:
    lib = _build.load("geglu")
    if lib.d3r_geglu_ff_bf16.argtypes is None:
        lib.d3r_geglu_ff_bf16.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                                          + [ctypes.c_void_p])
        lib.d3r_geglu_ff_bf16.restype = ctypes.c_int
        lib.d3r_geglu_ff_splits.argtypes = [ctypes.c_int] * 4
        lib.d3r_geglu_ff_splits.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _hidden_splits(rows: int, c: int, f: int, cb: int, device_index: int) -> int:
    """How many blocks share the hidden axis F at this shape on this card
    (csrc/geglu.cu: d3r_geglu_ff_splits, from the SM count and the kernel's
    occupancy)."""
    with torch.cuda.device(device_index):
        splits = _library().d3r_geglu_ff_splits(rows, c, f, cb)
    if splits < 1:
        raise RuntimeError(f"geglu_ff: CUDA error {-splits} choosing the F split")
    return splits


def _check_cuda(x, w1h, w1g, w2, biases) -> None:
    c = x.shape[-1]
    f = w1h.shape[1]
    if c % 16 or f % 64:
        raise ValueError(f"the CUDA GEGLU kernel takes C % 16 == 0 and F % 64 == 0, "
                         f"got C={c}, F={f}")
    for name, t in (("x", x), ("w1h", w1h), ("w1g", w1g), ("w2", w2)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA GEGLU kernel takes bfloat16 {name}, got {t.dtype}")
    for name, t in (("x", x), ("w1h", w1h), ("w1g", w1g), ("w2", w2),
                    ("b1h", biases[0]), ("b1g", biases[1]), ("b2", biases[2])):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if t.numel() > 2**31 - 1:
            raise ValueError(f"{name} is too large for the kernel's 32-bit indices")
    for name, t in (("b1h", biases[0]), ("b1g", biases[1]), ("b2", biases[2])):
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA GEGLU kernel takes float32 {name}, got {t.dtype}")


def geglu_ff(x: torch.Tensor, w1h: torch.Tensor, w1g: torch.Tensor,
             w2: torch.Tensor, b1h: Optional[torch.Tensor] = None,
             b1g: Optional[torch.Tensor] = None,
             b2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, N, C]; w1h/w1g [C, F]; w2 [F, C]; biases [F]/[F]/[C] -> [B, N, C].

    CUDA tensors go to the Hopper kernel (bf16 x and weights, fp32 biases,
    C % 16 == 0, F % 64 == 0, all contiguous) or raise; CPU tensors take the
    plain version. `geglu_ff.launches` counts the calls that went through
    this wrapper."""
    if x.ndim != 3 or w1h.ndim != 2 or w1g.shape != w1h.shape or w2.ndim != 2:
        raise ValueError("geglu_ff takes x [B, N, C], w1h/w1g [C, F], w2 [F, C]")
    b, n, c = x.shape
    f = w1h.shape[1]
    if w1h.shape[0] != c or tuple(w2.shape) != (f, c):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w1h {tuple(w1h.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    if x.device.type == "cpu":
        geglu_ff.launches += 1
        return geglu_ff_plain(x, w1h, w1g, w2, b1h, b1g, b2)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_ff runs on CUDA or the CPU, got {x.device}")
    zeros = x.new_zeros
    biases = (zeros(f, dtype=torch.float32) if b1h is None else b1h,
              zeros(f, dtype=torch.float32) if b1g is None else b1g,
              zeros(c, dtype=torch.float32) if b2 is None else b2)
    _check_cuda(x, w1h, w1g, w2, biases)
    rows = b * n
    cb = _output_chunk(c)
    splits = _hidden_splits(rows, c, f, cb, x.device.index)
    out = torch.empty((b, n, c), dtype=x.dtype, device=x.device)
    workspace = (torch.empty((splits, rows, c), dtype=torch.float32, device=x.device)
                 if splits > 1 else None)
    with torch.cuda.device(x.device):
        err = _library().d3r_geglu_ff_bf16(
            x.data_ptr(), w1h.data_ptr(), w1g.data_ptr(), w2.data_ptr(),
            *(t.data_ptr() for t in biases), out.data_ptr(),
            None if workspace is None else workspace.data_ptr(),
            rows, c, f, cb, splits, _build.current_stream(x.device))
    _build.check(err, "geglu_ff")
    geglu_ff.launches += 1
    return out


geglu_ff.launches = 0
