"""Fused GEGLU feed-forward: the CUDA kernel, its plain PyTorch version, its
gate and its launch counter.

Port of `d3roma_tpu/ops/pallas/geglu.py::geglu_ff`: the bf16 path (kernel
body `_kernel_bf16`) is `geglu_ff` over `csrc/geglu.cu`; the static int8
path (`_kernel_int8`, with the wrapper's quantization of x and of the
weights) is `geglu_ff_int8` over `csrc/geglu_int8.cu`. Each source note says
what bounds the kernel on the H100 and how it is built around that.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from d3roma_tpu_torch.ops.kernels import _build
from d3roma_tpu_torch.ops.kernels.quantize import (
    fp32,
    ieee_div,
    quantize_int8_plain,
    quantize_int8_scalar,
)

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


def pick_cols(f: int) -> int:
    """The TPU kernel's F chunk (`_pick_cols`), which is also the width of
    its scale grid: the largest multiple of 128 up to 1024 dividing F."""
    for d in range(min(1024, f), 0, -128):
        if f % d == 0:
            return d
    return min(1024, f)


def pick_rows(c: int):
    """The TPU kernel's (row block, row sub-chunk) (`_pick_rows`); the
    sub-chunk is the height of its scale grid."""
    return (2048, 512) if c <= 640 else (512, 256)


def gelu_tanh_jax(g: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True) in its own order of fp32 operations."""
    cdf = 0.5 * (1.0 + torch.tanh(0.7978845608028654 * (g + 0.044715 * (g * g * g))))
    return g * cdf


def _exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact product of integer-valued a [m, k] and b [k, n] through float64,
    as fp32 (exact while the sums stay below 2^24, as they do here)."""
    return torch.matmul(a.double(), b.double()).float()


def geglu_ff_int8_plain(x, w1hq, w1gq, w2q, s1h, s1g, s2, b1h, b1g, b2,
                        act_scale: float) -> torch.Tensor:
    """The TPU int8 kernel's arithmetic in PyTorch, its scale grid included.
    x [B, N, C] (compute type), w1hq/w1gq [F, C] and w2q [C, F] int8, s1h/s1g
    [F] and s2 [C] fp32 weight scales, fp32 biases -> [B, N, C] in x's type:
      h = (xq . W1h) * (act_scale * s1h) + b1h, g likewise, y = h * gelu(g);
      per tile of sub_rows x blk_cols: sy = max(max|y|, 1e-6) / 127 over the
      rows padded with zeros to the tile, yq = round(y / sy);
      out = b2 + sum over chunks of (yq . W2) * (sy * s2), cast once."""
    b, n, c = x.shape
    f = w1hq.shape[0]
    rows = b * n
    _, sub_rows = pick_rows(c)
    blk_cols = pick_cols(f)
    cover = -(-rows // sub_rows) * sub_rows
    xq = F.pad(quantize_int8_plain(x.reshape(rows, c), act_scale), (0, 0, 0, cover - rows))
    h = _exact_matmul(xq, w1hq.t()) * (s1h * act_scale) + b1h
    g = _exact_matmul(xq, w1gq.t()) * (s1g * act_scale) + b1g
    y = h * gelu_tanh_jax(g)
    tiles = y.abs().reshape(cover // sub_rows, sub_rows, f // blk_cols, blk_cols)
    sy = ieee_div(torch.clamp_min(tiles.amax(dim=(1, 3)), 1e-6), 127.0)
    sy_rows = sy.repeat_interleave(sub_rows, dim=0)  # [cover, F / blk_cols]
    yq = torch.round(y / sy_rows.repeat_interleave(blk_cols, dim=1))
    acc = b2.float().expand(cover, c)
    for j in range(f // blk_cols):
        cols = slice(j * blk_cols, (j + 1) * blk_cols)
        part = _exact_matmul(yq[:, cols], w2q[:, cols].t())
        acc = acc + part * (sy_rows[:, j:j + 1] * s2)
    return acc[:rows].to(x.dtype).reshape(b, n, c)


def int8_output_chunk(c: int) -> int:
    """Output columns per block of the int8 kernel's second pass: the
    widest multiple of 64 up to 320 that divides C."""
    for cb in range(min(c, 320) // 64 * 64, 0, -64):
        if c % cb == 0:
            return cb
    raise ValueError(f"no int8 output chunk for C={c}")


def _library_int8() -> ctypes.CDLL:
    lib = _build.load("geglu_int8")
    fn = lib.d3r_geglu_ff_int8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_int8(x, w1hq, w1gq, w2q, scales, biases) -> None:
    if x.ndim != 3 or w1hq.ndim != 2 or w1gq.shape != w1hq.shape or w2q.ndim != 2:
        raise ValueError("geglu_ff_int8 takes x [B, N, C], w1hq/w1gq [F, C], w2q [C, F]")
    c = x.shape[-1]
    f = w1hq.shape[0]
    if w1hq.shape[1] != c or tuple(w2q.shape) != (c, f):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w1hq {tuple(w1hq.shape)}, "
                         f"w2q {tuple(w2q.shape)}")
    for name, t in (("w1hq", w1hq), ("w1gq", w1gq), ("w2q", w2q)):
        if t.dtype != torch.int8:
            raise TypeError(f"geglu_ff_int8 takes int8 {name}, got {t.dtype}")
    for t in (*scales, *biases):
        if t.dtype != torch.float32 or t.device != x.device:
            raise TypeError("geglu_ff_int8 takes fp32 scales and biases on x's device")


def _check_cuda_int8(x, tensors) -> None:
    c, f = x.shape[-1], tensors[0].shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA int8 GEGLU kernel takes bf16 x, got {x.dtype}")
    if c % 64 or f % 128:
        raise ValueError(f"the CUDA int8 GEGLU kernel takes C % 64 == 0 and F % 128 == 0, "
                         f"got C={c}, F={f}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the int8 GEGLU operands must be contiguous and 16-byte aligned")


def geglu_ff_int8(x: torch.Tensor, w1hq: torch.Tensor, w1gq: torch.Tensor,
                  w2q: torch.Tensor, s1h: torch.Tensor, s1g: torch.Tensor,
                  s2: torch.Tensor, b1h: torch.Tensor, b1g: torch.Tensor,
                  b2: torch.Tensor, act_scale: float) -> torch.Tensor:
    """The fused GEGLU with both products in int8 (the TPU kernel's
    quant="static"): x [B, N, C] is quantized at `act_scale`; see
    geglu_ff_int8_plain for the operands and the arithmetic.

    CUDA tensors go to the Hopper kernel (bf16 x, C % 64 == 0, F % 128 == 0)
    or raise; CPU tensors take the plain version.
    `geglu_ff_int8.launches` counts the calls that went through this
    wrapper."""
    act_scale = fp32(act_scale)
    _check_int8(x, w1hq, w1gq, w2q, (s1h, s1g, s2), (b1h, b1g, b2))
    if x.device.type == "cpu":
        geglu_ff_int8.launches += 1
        return geglu_ff_int8_plain(x, w1hq, w1gq, w2q, s1h, s1g, s2, b1h, b1g, b2, act_scale)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_ff_int8 runs on CUDA or the CPU, got {x.device}")
    b, n, c = x.shape
    f = w1hq.shape[0]
    rows = b * n
    _, sub_rows = pick_rows(c)
    blk_cols = pick_cols(f)
    d1h, d1g = (s1h * act_scale).contiguous(), (s1g * act_scale).contiguous()
    operands = (w1hq, w1gq, w2q, d1h, d1g, b1h, b1g, s2, b2)
    _check_cuda_int8(x, operands)
    xq = quantize_int8_scalar(x.reshape(rows, c), act_scale)
    table = torch.empty(-(-rows // sub_rows) * (f // blk_cols), dtype=torch.int32,
                        device=x.device)
    out = torch.empty((b, n, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _library_int8().d3r_geglu_ff_int8(
            xq.data_ptr(), *(t.data_ptr() for t in operands), table.data_ptr(),
            out.data_ptr(), rows, c, f, sub_rows, blk_cols, int8_output_chunk(c),
            _build.current_stream(x.device))
    _build.check(err, "geglu_ff_int8")
    geglu_ff_int8.launches += 1
    return out


geglu_ff_int8.launches = 0
