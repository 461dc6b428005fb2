"""Winograd F(2x2, 3x3) convolution: the CUDA kernel, its plain PyTorch
version, the routing math that decides which convolutions take it, and its
launch counter.

Port of `d3roma_tpu/ops/pallas/winograd_fused.py::conv3x3_wino_fused`
(kernel body `_kernel`): x cast to bf16; the input transform B^T d B in
fp32, V rounded to bf16; U = G g G^T from the fp32 weight, rounded to bf16;
16 bf16 tap GEMMs with fp32 accumulation; the output transform A^T M A in
fp32; the output in the promoted type of x and w. The kernel is
`csrc/winograd_fused.cu`: an input transform into V [16, Mt, C], then the
16 tap GEMMs on the TMA + wgmma mainloop with the output transform in their
epilogue; `wino_plan` is the host's plan of a call. Its source note says
what bounds it on the H100 and how it is built around that.

`_round_up`, `_block_budget`, `pick_block_tr`, `pick_config` and
`wino_fused_supported` are the TPU kernel's VMEM arithmetic, copied
unchanged. They do not tile the Hopper kernel; they decide which
convolutions the JAX package's "wino_static" mode sends to Winograd (bf16,
no activation scale) and which to the static int8 conv (one scale each), so
they fix the calibrated scale tables' call order, which both packages must
share.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from d3roma_tpu_torch.ops.kernels import _build
from d3roma_tpu_torch.ops.kernels.geglu import (
    H100_SMS,
    SPLIT_BYTES_PER_UNIT,
    SPLIT_LAUNCH_UNITS,
    TILE_STAGES,
)

_LANES = 128
_SUBL = 8  # bf16 sublane tile
_VMEM_CAP = 13 * 1024 * 1024

# G (4x3) of the weight transform; B^T (4x4) and A^T (2x4) are applied as
# adds and subtractions
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _block_budget(x_shape, block_tr: int, o_block: int) -> int:
    """The TPU kernel's peak VMEM bytes of one grid step (weights and output
    block counted twice: Mosaic double-buffers them)."""
    _, _, W, C = x_shape
    cp = _round_up(C, _LANES)
    twp = _round_up((W + 1) // 2, _SUBL)
    tr = block_tr
    taps = 4 * (2 * tr + 2) * twp * cp * 2
    u = 16 * cp * o_block * 2 * 2
    v16 = 16 * tr * twp * cp * 2
    m = 16 * tr * twp * o_block * 4
    y = 2 * tr * twp * 2 * o_block * 4 * 2
    return taps + u + v16 + m + y


def pick_block_tr(x_shape, o_block: int = 128):
    """The TPU kernel's tile-row block: the largest of (8, 4) within the
    VMEM budget, with at least 96 GEMM rows per block and at most 25% row
    padding, preferring the larger within 10% of the least padding; None if
    none qualifies."""
    th = (x_shape[1] + 1) // 2
    twp = _round_up((x_shape[2] + 1) // 2, _SUBL)
    fitting = [tr for tr in (8, 4)
               if _block_budget(x_shape, tr, o_block) <= _VMEM_CAP
               and tr * twp >= 96
               and _round_up(th, tr) / th <= 1.25]
    if not fitting:
        return None
    best_ratio = min(_round_up(th, tr) / th for tr in fitting)
    for tr in fitting:
        if _round_up(th, tr) / th <= best_ratio * 1.10:
            return tr
    return fitting[-1]


def pick_config(x_shape):
    """(block_tr, o_block) of the TPU kernel, or None where it does not fit."""
    tr = pick_block_tr(x_shape, 128)
    return None if tr is None else (tr, 128)


def wino_fused_supported(x_shape, w_shape, strides, padding) -> bool:
    """Stride-1 SAME 3x3, NHWC x and HWIO w, where pick_config admits x."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    if tuple(w_shape[:2]) != (3, 3) or tuple(strides) != (1, 1):
        return False
    if isinstance(padding, str):
        if padding.upper() != "SAME":
            return False
    elif tuple(map(tuple, padding)) != ((1, 1), (1, 1)):
        return False
    return pick_config(x_shape) is not None


def winograd_weight(w: torch.Tensor) -> torch.Tensor:
    """U = G g G^T of a [O, C, 3, 3] weight: fp32 products, rounded to bf16,
    as [16, O, C] (tap 4 x + y; C contiguous: each tap is the K-major B
    operand of the kernel's wgmma)."""
    g = torch.tensor(_G, dtype=torch.float32, device=w.device)
    u = torch.einsum("xi,ocij,yj->xyoc", g, w.float(), g)
    return u.reshape(16, w.shape[0], w.shape[1]).to(torch.bfloat16).contiguous()


def _bt(a):
    return [a[0] - a[2], a[1] + a[2], a[2] - a[1], a[1] - a[3]]


def _at(a):
    return [a[0] + a[1] + a[2], a[1] - a[2] - a[3]]


def conv3x3_winograd_plain(x: torch.Tensor, u: torch.Tensor, out_dtype: torch.dtype,
                           bias: Optional[torch.Tensor] = None,
                           round_x: bool = True) -> torch.Tensor:
    """The TPU kernel's arithmetic in PyTorch (the `ops/winograd.py::
    winograd_conv3x3` formulation): x [B, H, W, C] cast to bf16 (as it is
    with round_x=False, the XLA formulation's fp32 input), the SAME halo and
    the tile grid's tail zero-padded; V = B^T d B per 4x4 tile in fp32,
    rounded to bf16; M = V U per tap with fp32 sums (one batched matmul);
    Y = A^T M A in fp32, cast to `out_dtype`; then `bias` added in that
    type. u: winograd_weight(w)."""
    b, h, w, c = x.shape
    o = u.shape[1]
    th, tw = (h + 1) // 2, (w + 1) // 2
    xp = torch.nn.functional.pad(x.to(torch.bfloat16).float() if round_x else x.float(),
                                 (0, 0, 1, 2 * tw + 1 - w, 1, 2 * th + 1 - h))
    d = [[xp[:, i:i + 2 * th - 1:2, j:j + 2 * tw - 1:2, :] for j in range(4)]
         for i in range(4)]
    cols = [_bt([d[i][j] for i in range(4)]) for j in range(4)]
    v = [_bt([cols[j][xx] for j in range(4)]) for xx in range(4)]
    vs = torch.stack([v[i][j] for i in range(4) for j in range(4)])
    vs = vs.reshape(16, b * th * tw, c).to(torch.bfloat16).float()
    m = torch.matmul(vs, u.float().transpose(1, 2)).reshape(4, 4, b, th, tw, o)
    f = _at([m[i] for i in range(4)])
    y = [_at([f[uu][j] for j in range(4)]) for uu in range(2)]
    y = torch.stack([torch.stack(y[uu], dim=3) for uu in range(2)], dim=2)
    y = y.reshape(b, 2 * th, 2 * tw, o)[:, :h, :w, :].to(out_dtype)
    return y if bias is None else y + bias.to(out_dtype)


# The CUDA kernel's tiles (csrc/winograd_fused.cu): 128 Winograd tiles (two
# wgmma warpgroups of 64 GEMM rows) by 64 output channels (the tap's fp32
# sums and the four output accumulators take 5 x 32 registers a thread at
# 64), 64 channels of C a k step (128 bytes of bf16), and the groups the 16
# taps may be split into.
TILE_ROWS = 128
TILE_COLS = 64
K_STEP = 64
TAPS = 16
TAP_SPLITS = (1, 2, 4)


@dataclass(frozen=True)
class WinoPlan:
    """How the CUDA kernel cuts one call. th, tw: Winograd tiles down and
    across an image; tiles: Mt = B th tw, the GEMM rows, and the rows of
    V [16, Mt, C]; m_tiles, n_tiles: block tiles over Mt (TILE_ROWS) and O
    (TILE_COLS); splits: groups of TAPS / splits taps, one block tile each;
    kc: k steps a tap; grid: the persistent blocks; v_map, u_map: the 3D
    TMA maps of V and U, (dims, box), innermost first; workspace_bytes: the
    fp32 partial outputs [splits, B H W, O] when split, else 0."""
    th: int
    tw: int
    tiles: int
    m_tiles: int
    n_tiles: int
    splits: int
    kc: int
    grid: int
    v_map: Tuple[Tuple[int, int, int], Tuple[int, int, int]]
    u_map: Tuple[Tuple[int, int, int], Tuple[int, int, int]]
    workspace_bytes: int


@functools.lru_cache(maxsize=256)
def wino_plan(b: int, h: int, w: int, c: int, o: int, sms: int = H100_SMS) -> WinoPlan:
    """The tiles of one call on a card with `sms` SMs: the split of the taps
    with the least modelled time (geglu_plan's model, whose GEMMs share the
    mainloop: a tile costs its k steps plus TILE_STAGES, times the rows it
    loads a step, by waves of tiles over the SMs; a split adds its partial
    sums' round trip and a launch), the fewest splits on a tie."""
    th, tw = (h + 1) // 2, (w + 1) // 2
    tiles = b * th * tw
    m_tiles, n_tiles = -(-tiles // TILE_ROWS), -(-o // TILE_COLS)
    kc = -(-c // K_STEP)

    def cost(s):
        waves = -(-(m_tiles * n_tiles * s) // sms)
        split = ((s + 1) * 4 * b * h * w * o / SPLIT_BYTES_PER_UNIT + SPLIT_LAUNCH_UNITS
                 if s > 1 else 0)
        return waves * (TAPS // s * kc + TILE_STAGES) * (TILE_ROWS + TILE_COLS) + split

    splits = min(TAP_SPLITS, key=lambda s: (cost(s), s))
    return WinoPlan(th, tw, tiles, m_tiles, n_tiles, splits, kc,
                    min(m_tiles * n_tiles * splits, sms),
                    ((c, tiles, TAPS), (K_STEP, TILE_ROWS, 1)),
                    ((c, o, TAPS), (K_STEP, TILE_COLS, 1)),
                    4 * splits * b * h * w * o if splits > 1 else 0)


def _library() -> ctypes.CDLL:
    lib = _build.load("winograd_fused")
    fn = lib.d3r_conv3x3_winograd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def conv3x3_winograd(x: torch.Tensor, u: torch.Tensor, out_dtype: torch.dtype,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 SAME 3x3 convolution by Winograd F(2x2, 3x3), NHWC x
    [B, H, W, C] -> [B, H, W, O] in `out_dtype`, with U = winograd_weight(w)
    [16, O, C] and an optional bias added after the output's rounding.

    CUDA tensors go to the Hopper kernels (bf16 U and output, C % 32 == 0,
    O % 8 == 0: the input transform, the tap GEMMs and, where wino_plan
    splits the taps, their sum, in one call) or raise; CPU tensors take the
    plain version.
    `conv3x3_winograd.launches` counts the calls."""
    if x.ndim != 4 or u.ndim != 3 or u.shape[0] != 16 or u.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3_winograd takes NHWC x and U [16, O, C], got "
                         f"{tuple(x.shape)} and {tuple(u.shape)}")
    if x.device.type == "cpu":
        conv3x3_winograd.launches += 1
        return conv3x3_winograd_plain(x, u, out_dtype, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_winograd runs on CUDA or the CPU, got {x.device}")
    b, h, w, c = x.shape
    o = u.shape[1]
    if u.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise TypeError("the CUDA Winograd kernel takes bf16 U and writes bf16")
    if c % 32 or o % 8:
        raise ValueError(f"the CUDA Winograd kernel takes C % 32 == 0 and O % 8 == 0, "
                         f"got C={c}, O={o}")
    if bias is not None:
        bias = bias.to(torch.bfloat16).contiguous()
        if bias.shape != (o,) or bias.device != x.device:
            raise ValueError("bias must be [O] on x's device")
    if not u.is_contiguous() or u.device != x.device:
        raise ValueError("U must be contiguous and on x's device")
    xb = x.to(torch.bfloat16).contiguous()
    plan = wino_plan(b, h, w, c, o, _build.sm_count(x.device.index))
    if plan.tiles > 2**31 - 1 or b * h * w * o > 2**31 - 1:
        raise ValueError("x is too large for the kernel's 32-bit indices")
    out = torch.empty((b, h, w, o), dtype=torch.bfloat16, device=x.device)
    v = torch.empty((TAPS, plan.tiles, c), dtype=torch.bfloat16, device=x.device)
    partial = (torch.empty((plan.workspace_bytes // 4,), dtype=torch.float32, device=x.device)
               if plan.splits > 1 else None)
    with torch.cuda.device(x.device):
        err = _library().d3r_conv3x3_winograd(
            xb.data_ptr(), u.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), v.data_ptr(), None if partial is None else partial.data_ptr(),
            b, h, w, c, o, plan.splits, _build.current_stream(x.device))
    _build.check(err, "conv3x3_winograd")
    conv3x3_winograd.launches += 1
    return out


conv3x3_winograd.launches = 0
