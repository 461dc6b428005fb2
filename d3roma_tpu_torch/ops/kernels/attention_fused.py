"""Fused self-attention (QKV projection, whole-row attention, output
projection): the CUDA kernels of both bodies, their plain PyTorch versions,
the gate and the launch counters.

Port of `d3roma_tpu/ops/pallas/attention_fused.py::fused_self_attention`.
The int8 body (`quant="static"`, kernel body `_kernel_int8`) is
`fused_self_attention_int8` over `csrc/attention_fused_int8.cu`: x quantized
at the static activation scale; int8 weights with per-(head, column) scales;
k and v re-quantized per (batch, head) over all rows, q per (256-row block,
head); P quantized at 127 against the true row max; the output projection in
bf16 with fp32 sums over the heads, starting from the bias. The bf16 body
(`quant=None`, `_kernel_bf16`) is `fused_self_attention_bf16` over
`csrc/attention_fused_bf16.cu`: q, k, v rounded to x's type from fp32 sums,
the whole-row softmax of `mha_attention`, the same output projection. Each
source note says what bounds the kernel on the H100 and how it is built
around that.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from d3roma_tpu_torch.ops.kernels import _build, conv2d
from d3roma_tpu_torch.ops.kernels.attention import mha_attention_plain, rows_plan
from d3roma_tpu_torch.ops.kernels.quantize import (
    act_workspace,
    fp32,
    ieee_div,
    quantize_int8_plain,
    quantize_int8_scalar,
)

_BLK_Q = 256
_MAX_N = 6144
_HEAD_DIM = 64
_KEY_TILE = 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def fused_attention_supported(n: int, c: int, head_dim: int, itemsize: int = 1) -> bool:
    """The JAX package's gate, unchanged (its TPU VMEM arithmetic): head_dim
    64 dividing C, tokens padded to 256 at most 6144, and the kernel's
    blocks at `itemsize` (1 for int8, 2 for bf16) within 11 MiB."""
    if head_dim != 64 or c % head_dim != 0:
        return False
    n_pad = _round_up(n, _BLK_Q)
    h = c // head_dim
    e = itemsize
    kv = 2 * h * n_pad * head_dim * e
    x_full = n_pad * c * e
    x_blk = _BLK_Q * c * e
    slab = _BLK_Q * n_pad * 4
    w_qkv = 3 * h * c * head_dim * e
    w_o = c * c * 2
    acc = _BLK_Q * c * 4
    total = kv + x_full + x_blk + slab + w_qkv + w_o + acc
    return n_pad <= _MAX_N and total <= 11 * 1024 * 1024


def _exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer-valued a @ b, exact (float64 sums), as fp32."""
    return torch.matmul(a.double(), b.double()).float()


def _head_scale(amax: torch.Tensor) -> torch.Tensor:
    return ieee_div(torch.clamp_min(amax, 1e-6), 127.0)


def fused_self_attention_int8_plain(x: torch.Tensor, wqkv: torch.Tensor, ws: torch.Tensor,
                                    wo: torch.Tensor, bo: torch.Tensor, heads: int,
                                    act_scale: float,
                                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """The TPU int8 kernel's arithmetic in PyTorch. x [B, N, C]; wqkv [3C, C]
    int8 (the rows of Wq, Wk, Wv, one per output column) with fp32 scales ws
    [3C]; wo [C, C] (output column, then input) and bo [C] -> [B, N, C] in
    x's type."""
    b, n, c = x.shape
    d = c // heads
    scale = fp32(sm_scale if sm_scale is not None else 1.0 / math.sqrt(d))
    act = torch.tensor(fp32(act_scale), dtype=torch.float32, device=x.device)
    f = _exact_matmul(quantize_int8_plain(x, act_scale), wqkv.t()) * (act * ws)
    qf, kf, vf = (t.reshape(b, n, heads, d) for t in f.split(c, dim=-1))
    sk, sv = (_head_scale(t.abs().amax(dim=(1, 3))) for t in (kf, vf))  # [B, H]
    n_pad = _round_up(n, _BLK_Q)
    qpad = torch.nn.functional.pad(qf, (0, 0, 0, 0, 0, n_pad - n))
    sq = _head_scale(qpad.reshape(b, n_pad // _BLK_Q, _BLK_Q, heads, d).abs().amax(dim=(2, 4)))
    sq = sq.repeat_interleave(_BLK_Q, dim=1)[:, :n]  # [B, N, H]: each row's block scale
    qq = torch.round(torch.div(qf, sq[..., None]))
    kq = torch.round(torch.div(kf, sk[:, None, :, None]))
    vq = torch.round(torch.div(vf, sv[:, None, :, None]))
    s = _exact_matmul(qq.transpose(1, 2), kq.permute(0, 2, 3, 1))  # [B, H, N, N]
    s = s * ((sq * scale) * sk[:, None, :]).transpose(1, 2)[..., None]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    pv = _exact_matmul(torch.round(p * 127.0), vq.transpose(1, 2))
    o = (pv * ieee_div(sv, 127.0)[..., None, None] / denom).to(torch.bfloat16)
    return _out_projection(o.transpose(1, 2), wo, bo, heads).to(x.dtype)


def _out_projection(o: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """The TPU kernel's output projection, fp32: bo plus, in head order, each
    head's o_h [B, N, d] times its slice of Wo [C, C] (output column, then
    input)."""
    b, n, c = o.shape[0], o.shape[1], wo.shape[0]
    d = c // heads
    out = bo.float().expand(b, n, c)
    for h in range(heads):
        out = out + torch.matmul(o[:, :, h].float(), wo[:, h * d:(h + 1) * d].float().t())
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load("attention_fused_int8")
    fn = lib.d3r_fused_self_attention_int8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(x, wqkv, ws, wo, bo, heads) -> None:
    if x.ndim != 3:
        raise ValueError(f"fused_self_attention_int8 takes x [B, N, C], got {tuple(x.shape)}")
    c = x.shape[2]
    if c % heads or wqkv.shape != (3 * c, c) or ws.shape != (3 * c,) or wo.shape != (c, c) \
            or bo.shape != (c,):
        raise ValueError(f"operand shapes do not fit x {tuple(x.shape)} and {heads} heads")
    if wqkv.dtype != torch.int8 or ws.dtype != torch.float32:
        raise TypeError("fused_self_attention_int8 takes int8 wqkv and fp32 ws")
    for name, t in (("wqkv", wqkv), ("ws", ws), ("wo", wo), ("bo", bo)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def fused_self_attention_int8(x: torch.Tensor, wqkv: torch.Tensor, ws: torch.Tensor,
                              wo: torch.Tensor, bo: torch.Tensor, heads: int,
                              act_scale: float,
                              sm_scale: Optional[float] = None) -> torch.Tensor:
    """softmax((x Wq)(x Wk)^T / sqrt(d)) (x Wv) Wo + bo per head, with the
    TPU kernel's int8 arithmetic; see fused_self_attention_int8_plain for
    the operands.

    CUDA tensors go to the Hopper kernels (bf16 x and wo, head_dim 64): the
    quantization of x into the stream's int8 workspace (act_workspace) and
    the fused kernel's four launches, in one call; or raise. CPU tensors take
    the plain version. `fused_self_attention_int8.launches` counts the calls,
    `quantize_int8_scalar.launches` their quantizations of x."""
    _check(x, wqkv, ws, wo, bo, heads)
    if x.device.type == "cpu":
        fused_self_attention_int8.launches += 1
        quantize_int8_scalar.launches += 1
        return fused_self_attention_int8_plain(x, wqkv, ws, wo, bo, heads, act_scale, sm_scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_self_attention_int8 runs on CUDA or the CPU, got {x.device}")
    b, n, c = x.shape
    if c != _HEAD_DIM * heads:
        raise ValueError(f"the CUDA fused attention kernel takes head_dim 64, got {c // heads}")
    if x.dtype != torch.bfloat16 or wo.dtype != torch.bfloat16:
        raise TypeError("the CUDA fused attention kernel takes bf16 x and wo")
    for name, t in (("wqkv", wqkv), ("ws", ws), ("wo", wo)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if b * n * 3 * c > 2**31 - 1:
        raise ValueError("x is too large for the kernel's 32-bit indices")
    scale = fp32(sm_scale if sm_scale is not None else 1.0 / math.sqrt(_HEAD_DIM))
    dev = x.device
    m_pad = _round_up(n, _KEY_TILE)
    rows_plan(b, n, n, heads, _HEAD_DIM, _BLK_Q, m_pad)  # 256-row q scale blocks
    x = x.contiguous()
    n_amax = b * (-(-n // _BLK_Q)) * heads + 2 * b * heads
    f = torch.empty((b, n, 3 * c), dtype=torch.float32, device=dev)
    amax = torch.empty((n_amax,), dtype=torch.int32, device=dev)
    qk = torch.empty((2, b, n, c), dtype=torch.int8, device=dev)
    vt = torch.empty((b, heads, _HEAD_DIM, m_pad), dtype=torch.int8, device=dev)
    o = torch.empty((b, n, c), dtype=torch.bfloat16, device=dev)
    out = torch.empty((b, n, c), dtype=torch.bfloat16, device=dev)
    bo32 = bo.float().contiguous()
    stream = _build.current_stream(dev)
    with torch.cuda.device(dev):
        err = _library().d3r_fused_self_attention_int8(
            x.data_ptr(), act_workspace(dev, stream, x.numel()), wqkv.data_ptr(), ws.data_ptr(),
            wo.data_ptr(), bo32.data_ptr(), f.data_ptr(), amax.data_ptr(), qk[0].data_ptr(),
            qk[1].data_ptr(), vt.data_ptr(), o.data_ptr(), out.data_ptr(), b, n, c, heads, m_pad,
            fp32(act_scale), scale, stream)
    _build.check(err, "fused_self_attention_int8")
    fused_self_attention_int8.launches += 1
    quantize_int8_scalar.launches += 1
    return out


fused_self_attention_int8.launches = 0


# ---------------------------------------------------------------------------
# bf16 body


def fused_self_attention_bf16_plain(x: torch.Tensor, wqkv: torch.Tensor, wo: torch.Tensor,
                                    bo: torch.Tensor, heads: int,
                                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """The TPU bf16 kernel's arithmetic in PyTorch. x [B, N, C]; wqkv [3C, C]
    (the rows of Wq, Wk, Wv, one per output column) and wo [C, C] in x's
    type; bo [C] -> [B, N, C] in x's type. q, k, v: fp32 sums rounded to x's
    type; the whole-row attention of mha_attention_plain (P rounded to x's
    type for the PV product, o_h rounded to it); the output projection in
    fp32 from the bias, in head order."""
    b, n, c = x.shape
    qkv = torch.matmul(x.float(), wqkv.float().t()).to(x.dtype)
    q, k, v = (t.reshape(b, n, heads, c // heads) for t in qkv.split(c, dim=-1))
    o = mha_attention_plain(q, k, v, sm_scale)
    return _out_projection(o, wo, bo, heads).to(x.dtype)


def _library_bf16() -> ctypes.CDLL:
    lib = _build.load("attention_fused_bf16")
    fn = lib.d3r_fused_self_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def fused_self_attention_bf16(x: torch.Tensor, wqkv: torch.Tensor, wo: torch.Tensor,
                              bo: torch.Tensor, heads: int,
                              sm_scale: Optional[float] = None) -> torch.Tensor:
    """softmax((x Wq)(x Wk)^T / sqrt(d)) (x Wv) Wo + bo per head, with the
    TPU kernel's bf16 arithmetic; see fused_self_attention_bf16_plain for
    the operands.

    CUDA tensors go to the Hopper kernels (bf16 x, wqkv and wo, head_dim 64):
    three launches in one call; or raise. CPU tensors take the plain
    version. `fused_self_attention_bf16.launches` counts the calls."""
    if x.ndim != 3:
        raise ValueError(f"fused_self_attention_bf16 takes x [B, N, C], got {tuple(x.shape)}")
    b, n, c = x.shape
    if c % heads or wqkv.shape != (3 * c, c) or wo.shape != (c, c) or bo.shape != (c,):
        raise ValueError(f"operand shapes do not fit x {tuple(x.shape)} and {heads} heads")
    for name, t in (("wqkv", wqkv), ("wo", wo), ("bo", bo)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.device.type == "cpu":
        fused_self_attention_bf16.launches += 1
        return fused_self_attention_bf16_plain(x, wqkv, wo, bo, heads, sm_scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_self_attention_bf16 runs on CUDA or the CPU, got {x.device}")
    if c != _HEAD_DIM * heads:
        raise ValueError(f"the CUDA fused attention kernel takes head_dim 64, got {c // heads}")
    if not (x.dtype == wqkv.dtype == wo.dtype == torch.bfloat16):
        raise TypeError("the CUDA bf16 fused attention kernel takes bf16 x, wqkv and wo")
    for name, t in (("wqkv", wqkv), ("wo", wo)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if b * n * 3 * c > 2**31 - 1:
        raise ValueError("x is too large for the kernel's 32-bit indices")
    scale = fp32(sm_scale if sm_scale is not None else 1.0 / math.sqrt(_HEAD_DIM))
    dev = x.device
    x = x.contiguous()
    qkv = torch.empty((b, n, 3 * c), dtype=torch.bfloat16, device=dev)
    o = torch.empty((b, n, c), dtype=torch.bfloat16, device=dev)
    out = torch.empty((b, n, c), dtype=torch.bfloat16, device=dev)
    bo32 = bo.float().contiguous()
    # the QKV projection: a 1x1 convolution over the B N rows
    plan, proj = conv2d.launch_ints(1, 1, b * n, c, 3 * c, 1, 1, 1, 0, 2, "bf16", False, dev)
    work = conv2d.plan_workspace(plan, dev)
    with torch.cuda.device(dev):
        err = _library_bf16().d3r_fused_self_attention_bf16(
            x.data_ptr(), wqkv.data_ptr(), wo.data_ptr(), bo32.data_ptr(), qkv.data_ptr(),
            o.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(), proj, b,
            n, c, heads, scale, _build.current_stream(dev))
    _build.check(err, "fused_self_attention_bf16")
    fused_self_attention_bf16.launches += 1
    return out


fused_self_attention_bf16.launches = 0
