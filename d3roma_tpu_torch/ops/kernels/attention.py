"""Whole-row multi-head attention: the CUDA kernel, its plain PyTorch
version, its gate and its launch counter.

Port of `d3roma_tpu/ops/pallas/attention.py::mha_attention` (bf16/fp32
path, kernel body `_kernel_f32`). The kernel is `csrc/attention.cu`; its
source note says what bounds it on the H100 and how it is built around that.
The int8 path (`_kernel_int8`) is not ported yet.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from d3roma_tpu_torch.ops.kernels import _build

_LANES = 128
# the TPU kernel's VMEM limit; the gate keeps it so the same sites take the
# kernel in both packages
_MAX_NK = 6144
_INT32_MAX = 2**31 - 1


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def mha_supported(n_kv: int, head_dim: int, itemsize: int = 2) -> bool:
    """The JAX package's gate, unchanged: keys padded to 128 must not exceed
    6144, and head_dim must be <= 128 (<= 512 only for int8, itemsize=1)."""
    nk = _round_up(n_kv, _LANES)
    if nk > _MAX_NK:
        return False
    if head_dim <= 128:
        return True
    return itemsize == 1 and head_dim <= 512 and nk * head_dim <= 2**21


def mha_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """The TPU kernel's arithmetic in PyTorch: fp32 scores, one max-then-exp
    softmax over the whole key row, the unnormalized P cast to the input
    type, PV with fp32 accumulation, divided by the fp32 denominator.
    q [B, N, H, D], k/v [B, M, H, D] -> [B, N, H, D]."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(q.dtype).float(), vh)
    return (pv / denom).to(q.dtype).transpose(1, 2)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("mha_attention takes q [B, N, H, D] and k/v [B, M, H, D]")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v differ in dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    d = q.shape[-1]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA attention kernel takes bfloat16, got {q.dtype}")
    if d % 16 != 0 or d > 128:
        raise ValueError(f"the CUDA attention kernel takes head_dim % 16 == 0 and "
                         f"<= 128, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name} needs unit stride along D and strides that "
                             f"are multiples of 8, got {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if max(t.stride()[:3]) > _INT32_MAX or t.numel() > _INT32_MAX:
            raise ValueError(f"{name} is too large for the kernel's 32-bit strides")


def _library() -> ctypes.CDLL:
    lib = _build.load("attention")
    fn = lib.d3r_mha_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention, q [B, N, H, D], k/v [B, M, H, D] -> [B, N, H, D].

    CUDA tensors go to the Hopper kernel (bf16, D % 16 == 0, D <= 128) or
    raise; CPU tensors take the plain version. `mha_attention.launches`
    counts the calls that went through this wrapper."""
    _check(q, k, v)
    if q.device.type == "cpu":
        mha_attention.launches += 1
        return mha_attention_plain(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha_attention runs on CUDA or the CPU, got {q.device}")
    _check_cuda(q, k, v)
    b, n, h, d = q.shape
    m = k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().d3r_mha_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, n, m, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            scale, _build.current_stream(q.device))
    _build.check(err, "mha_attention")
    mha_attention.launches += 1
    return out


mha_attention.launches = 0
