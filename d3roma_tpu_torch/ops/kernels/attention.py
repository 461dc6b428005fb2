"""Whole-row multi-head attention: the CUDA kernel, its plain PyTorch
version, its gate and its launch counter.

Port of `d3roma_tpu/ops/pallas/attention.py::mha_attention`: the bf16/fp32
path (kernel body `_kernel_f32`) is `mha_attention` over
`csrc/attention.cu`; the int8 path (`_kernel_int8`, with the wrapper's
per-(batch, head) quantization) is `mha_attention_int8` over
`csrc/attention_int8.cu`. Each source note says what bounds the kernel on
the H100 and how it is built around that. `mha_attention_tp` is the
tensor-parallel composition of both (`mha_attention_tp` of the JAX
package), with its gate `tp_attention_ok`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from d3roma_tpu_torch.ops.kernels import _build
from d3roma_tpu_torch.ops.kernels.quantize import fp32, ieee_div
from d3roma_tpu_torch.parallel.mesh import DATA_AXIS, all_gather_cat
from d3roma_tpu_torch.parallel.tensor import MODEL_AXIS

_LANES = 128
# the TPU kernel's VMEM limit; the gate keeps it so the same sites take the
# kernel in both packages
_MAX_NK = 6144


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


def _library() -> ctypes.CDLL:
    lib = _build.load("attention")
    fn = lib.d3r_mha_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


# the bf16 kernel's tiles (csrc/attention_bf16_rows.cuh): 64 query rows a
# block (one wgmma warpgroup), 128 keys a tile, TMA boxes of 64 head columns
# (128 bytes) of the 4-D maps (D, H, L, B)
BF16_ROWS = 64
BF16_KEYS = 128
BF16_BOX = 64


def tma_head_strides(shape, strides) -> Optional[Tuple[int, int, int]]:
    """The (batch, token, head) element strides of a [B, L, H, D] tensor as
    the bf16 kernel's 4-D TMA map (D, H, L, B) takes them, or None where it
    cannot: unit stride along D, strides that are multiples of 8 (16 bytes),
    and nested ones (head >= D, token >= H head, batch >= L token), as the
    map's dimensions are; a dimension of size 1 takes the nested value."""
    b, l, h, d = shape
    sb, sl, sh, sd = strides
    if sd != 1:
        return None
    sh = sh if h > 1 else d
    sl = sl if l > 1 else h * sh
    sb = sb if b > 1 else l * sl
    if any(x % 8 for x in (sh, sl, sb)) or sh < d or sl < h * sh or sb < l * sl:
        return None
    return sb, sl, sh


@dataclass(frozen=True)
class Bf16Plan:
    """How the bf16 kernel cuts one call. width: the products' head width,
    D rounded up to the 64-column box (the columns past D are TMA's zero
    fill, never written); stages: the K and V tiles of the ring; grid:
    (query blocks of BF16_ROWS, H, B); key_tiles of BF16_KEYS keys,
    last_keys the valid keys of the last (the only one masked); q_map,
    k_map, v_map: the 4-D TMA maps as (dims, byte strides, box), innermost
    first; smem_bytes: a block's dynamic shared memory (three blocks share
    an SM at width 64)."""
    width: int
    stages: int
    grid: Tuple[int, int, int]
    key_tiles: int
    last_keys: int
    q_map: Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]
    k_map: Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]
    v_map: Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def bf16_plan(b: int, n: int, m: int, h: int, d: int,
              q_strides: Optional[Tuple[int, int, int]] = None,
              k_strides: Optional[Tuple[int, int, int]] = None,
              v_strides: Optional[Tuple[int, int, int]] = None) -> Bf16Plan:
    """The bf16 kernel's plan of one call, with the checks its launcher
    (launch_mha_bf16) makes: D a multiple of 16 up to 128, strides (batch,
    token, head; contiguous when None) as tma_head_strides returns them."""
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"the bf16 attention kernel takes head_dim % 16 == 0 and <= 128, "
                         f"got {d}")
    if min(b, n, m, h) <= 0:
        raise ValueError(f"bad attention call: B={b}, N={n}, M={m}, H={h}")
    maps = []
    for name, st, length, rows in (("q", q_strides, n, BF16_ROWS), ("k", k_strides, m, BF16_KEYS),
                                   ("v", v_strides, m, BF16_KEYS)):
        st = (length * h * d, h * d, d) if st is None else tuple(st)
        if tma_head_strides((b, length, h, d), st + (1,)) != st:
            raise ValueError(f"{name} strides {st} are not nested (a TMA map's dimensions)")
        maps.append(((d, h, length, b), (2 * st[2], 2 * st[1], 2 * st[0]), (BF16_BOX, 1, rows, 1)))
    width = 64 if d <= 64 else 128
    stages = 2
    smem = 1024 + BF16_ROWS * width * 2 + stages * 2 * BF16_KEYS * width * 2 + (stages + 1) * 8
    key_tiles = -(-m // BF16_KEYS)
    return Bf16Plan(width, stages, (-(-n // BF16_ROWS), h, b), key_tiles,
                    m - (key_tiles - 1) * BF16_KEYS, *maps, smem)


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention, q [B, N, H, D], k/v [B, M, H, D] -> [B, N, H, D].

    CUDA tensors go to the Hopper kernel (bf16, D % 16 == 0, D <= 128; cut
    by bf16_plan) or raise; CPU tensors take the plain version.
    `mha_attention.launches` counts the calls that went through this
    wrapper."""
    _check(q, k, v)
    if q.device.type == "cpu":
        mha_attention.launches += 1
        return mha_attention_plain(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha_attention runs on CUDA or the CPU, got {q.device}")
    _check_cuda(q, k, v)
    b, n, h, d = q.shape
    m = k.shape[1]
    qkv, st = [], []
    for t in (q, k, v):
        s = tma_head_strides(t.shape, t.stride())
        if s is None:  # strides a TMA map cannot take: a contiguous copy
            t = t.contiguous()
            s = tma_head_strides(t.shape, t.stride())
        qkv.append(t)
        st.append(s)
    q, k, v = qkv
    bf16_plan(b, n, m, h, d, *st)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().d3r_mha_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, n, m, h, d, *st[0], *st[1], *st[2], scale, _build.current_stream(q.device))
    _build.check(err, "mha_attention")
    mha_attention.launches += 1
    return out


mha_attention.launches = 0

# head widths the int8 kernels are built for: the rows kernel
# (csrc/attention_int8_rows.cuh) up to 128, the wide kernel
# (csrc/attention_int8.cu) above
INT8_HEAD_DIMS = (32, 64, 96, 128, 256, 512)
ROWS_HEAD_DIMS = (32, 64, 96, 128)
WIDE_HEAD_DIMS = (256, 512)
# keys of vt's padding
_INT8_KEY_TILE = 64
# the rows kernel's tiles: 128 query rows a block (two wgmma warpgroups of
# 64), 128 keys a tile, TMA boxes of 128 bytes (a head of D < 128 bytes
# reads TMA's zero fill past D)
ROWS_BLOCK = 128
ROWS_KEYS = 128
ROWS_BOX_BYTES = 128


@dataclass(frozen=True)
class RowsPlan:
    """How the int8 rows kernel cuts one call. grid: (query blocks, H, B);
    key_tiles: tiles of ROWS_KEYS keys each pass walks; last_keys: the
    valid keys of the last tile (the only one masked); q_map, k_map: the
    TMA maps of q [B, N, H, D] and k [B, M, H, D] as (D, H, B L), and v_map
    of vt [B H D, Mp], each (dims, box), innermost first; q_scales: the q
    scales of a (batch, head), one per q_rows query rows."""
    grid: Tuple[int, int, int]
    key_tiles: int
    last_keys: int
    q_map: Tuple[Tuple[int, ...], Tuple[int, ...]]
    k_map: Tuple[Tuple[int, ...], Tuple[int, ...]]
    v_map: Tuple[Tuple[int, ...], Tuple[int, ...]]
    q_scales: int


@functools.lru_cache(maxsize=256)
def rows_plan(b: int, n: int, m: int, h: int, d: int, q_rows: int, m_pad: int) -> RowsPlan:
    """The rows kernel's plan of one call, with the checks its launcher
    (launch_rows) makes: D in ROWS_HEAD_DIMS, vt's padded key count m_pad
    at least M and a multiple of 16 (TMA's row pitch), and q_rows (the query
    rows that share one q scale) a multiple of ROWS_BLOCK or at least N, so
    that no block straddles two q scales."""
    if d not in ROWS_HEAD_DIMS:
        raise ValueError(f"the int8 rows kernel takes head_dim in {ROWS_HEAD_DIMS}, got {d}")
    if min(b, n, m, h) <= 0 or m_pad < m or m_pad % 16:
        raise ValueError(f"bad int8 attention call: B={b}, N={n}, M={m}, H={h}, Mp={m_pad}")
    if q_rows <= 0 or (q_rows < n and q_rows % ROWS_BLOCK):
        raise ValueError(f"q_rows={q_rows}: a block of {ROWS_BLOCK} query rows would straddle "
                         f"two q scales (N={n})")
    key_tiles = -(-m // ROWS_KEYS)
    box = (ROWS_BOX_BYTES, 1, ROWS_BLOCK)
    return RowsPlan((-(-n // ROWS_BLOCK), h, b), key_tiles, m - (key_tiles - 1) * ROWS_KEYS,
                    ((d, h, b * n), box), ((d, h, b * m), box),
                    ((m_pad, b * h * d), (ROWS_KEYS, d)), -(-n // q_rows))


# the wide kernel's tiles: 64 query rows a block, D / 128 consumer
# warpgroups (one per 128-wide slice of O, each also taking the scores of
# 128 / (D / 128) keys of a tile), 128 keys a tile, a ring of units of
# 64 D bytes (a K half: 64 keys x D; a V half: D / 2 rows of V^T x 128 keys)
WIDE_ROWS = 64
WIDE_KEYS = 128
_WIDE_SLOTS = {256: 8, 512: 5}


@dataclass(frozen=True)
class WidePlan:
    """How the int8 wide kernel cuts one call. grid: (query blocks of
    WIDE_ROWS, H, B); groups: its consumer warpgroups (warpgroup g owns
    columns 128 g .. 128 g + 127 of O and the scores of keys group_keys g ..
    group_keys (g + 1) - 1 of every tile); threads: theirs (no producer
    warp); key_tiles of WIDE_KEYS keys, last_keys the valid keys of the
    last; units: the ring units a block walks (per tile, pass 1: the two K
    halves; pass 2: the two K halves and the two V halves), unit_bytes each,
    through a ring of `slots` (unit u + slots is loaded by the last of unit
    u's groups / 2 readers to hand it back); q_map, k_map (of q [B, N, H, D]
    and k [B, M, H, D] as (D, H, B L)) and v_map (of vt [B H D, Mp]), each
    (dims, box), innermost first; smem_bytes: a block's dynamic shared
    memory."""
    grid: Tuple[int, int, int]
    groups: int
    threads: int
    group_keys: int
    key_tiles: int
    last_keys: int
    units: int
    unit_bytes: int
    slots: int
    q_map: Tuple[Tuple[int, ...], Tuple[int, ...]]
    k_map: Tuple[Tuple[int, ...], Tuple[int, ...]]
    v_map: Tuple[Tuple[int, ...], Tuple[int, ...]]
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def wide_plan(b: int, n: int, m: int, h: int, d: int, m_pad: int) -> WidePlan:
    """The wide kernel's plan of one call (one q scale per (batch, head)),
    with the checks its launcher (launch_wide) makes: D in WIDE_HEAD_DIMS,
    vt's padded key count m_pad at least M and a multiple of 16."""
    if d not in WIDE_HEAD_DIMS:
        raise ValueError(f"the int8 wide kernel takes head_dim in {WIDE_HEAD_DIMS}, got {d}")
    if min(b, n, m, h) <= 0 or m_pad < m or m_pad % 16:
        raise ValueError(f"bad int8 attention call: B={b}, N={n}, M={m}, H={h}, Mp={m_pad}")
    groups = d // 128
    key_tiles = -(-m // WIDE_KEYS)
    unit = 64 * d
    slots = _WIDE_SLOTS[d]
    smem = (1024 + WIDE_ROWS * d + 2 * WIDE_ROWS * WIDE_KEYS + slots * unit
            + 2 * 4 * groups * WIDE_ROWS + 4 * 8 + (slots + 1) * 8)
    box = (ROWS_BOX_BYTES, 1, WIDE_ROWS)
    return WidePlan((-(-n // WIDE_ROWS), h, b), groups, 128 * groups, WIDE_KEYS // groups,
                    key_tiles, m - (key_tiles - 1) * WIDE_KEYS, 6 * key_tiles, unit, slots,
                    ((d, h, b * n), box), ((d, h, b * m), box),
                    ((m_pad, b * h * d), (WIDE_KEYS, d // 2)), smem)


def quantize_per_head(x: torch.Tensor):
    """The TPU wrapper's int8 quantization of q, k or v [B, L, H, D]: one
    scale per (batch, head), max(absmax, 1e-6) / 127, and round(x / scale)
    with no clip. Returns (int8 [B, L, H, D], fp32 scales [B, H])."""
    s = ieee_div(torch.clamp_min(x.float().abs().amax(dim=(1, 3)), 1e-6), 127.0)
    return torch.round(torch.div(x.float(), s[:, None, :, None])).to(torch.int8), s


def mha_attention_int8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             sm_scale: Optional[float] = None) -> torch.Tensor:
    """The TPU int8 kernel's arithmetic in PyTorch: q, k, v quantized per
    (batch, head); exact int32 scores (through float64) times
    scale * sq * sk; the max-then-exp softmax over the whole key row;
    round(127 p) times vq, exact; times sv / 127, divided by the fp32
    denominator. q [B, N, H, D], k/v [B, M, H, D] -> [B, N, H, D]."""
    d = q.shape[-1]
    scale = fp32(sm_scale if sm_scale is not None else 1.0 / math.sqrt(d))
    (qq, sq), (kq, sk), (vq, sv) = (quantize_per_head(t) for t in (q, k, v))
    s = torch.matmul(qq.transpose(1, 2).double(), kq.permute(0, 2, 3, 1).double()).float()
    s = s * ((sq * scale) * sk)[..., None, None]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    p_i8 = torch.round(p * 127.0)
    pv = torch.matmul(p_i8.double(), vq.transpose(1, 2).double()).float()
    out = pv * ieee_div(sv, 127.0)[..., None, None] / denom
    return out.to(q.dtype).transpose(1, 2)


def _library_int8() -> ctypes.CDLL:
    lib = _build.load("attention_int8")
    fn = lib.d3r_mha_attention_int8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_int8(q: torch.Tensor) -> None:
    d = q.shape[3]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA int8 attention kernel takes bfloat16, got {q.dtype}")
    if d not in INT8_HEAD_DIMS:
        raise ValueError(f"the CUDA int8 attention kernel takes head_dim in {INT8_HEAD_DIMS}, "
                         f"got {d}")


def mha_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       sm_scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention with both products in int8 (the TPU kernel's
    quant="int8"), q [B, N, H, D], k/v [B, M, H, D] -> [B, N, H, D].

    CUDA tensors go to the Hopper kernels (bf16, head_dim in
    INT8_HEAD_DIMS): the per-(batch, head) quantization of q, k and v and
    the attention (the rows kernel, planned by rows_plan, up to head_dim
    128; the wide kernel, planned by wide_plan, at 256 and 512), in one
    call; or raise. CPU tensors take the plain
    version. `mha_attention_int8.launches` counts the calls. Neither has a
    gradient: inputs that need one raise (_build.refuse_grad)."""
    _check(q, k, v)
    _build.refuse_grad("mha_attention_int8", q, k, v)
    if q.device.type == "cpu":
        mha_attention_int8.launches += 1
        return mha_attention_int8_plain(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha_attention_int8 runs on CUDA or the CPU, got {q.device}")
    _check_cuda_int8(q)
    q, k, v = (t.contiguous() for t in (q, k, v))
    b, n, h, d = q.shape
    m = k.shape[1]
    scale = fp32(sm_scale if sm_scale is not None else 1.0 / math.sqrt(d))
    m_pad = _round_up(m, _INT8_KEY_TILE)
    if d in ROWS_HEAD_DIMS:
        rows_plan(b, n, m, h, d, n, m_pad)  # one q scale per (batch, head)
    else:
        wide_plan(b, n, m, h, d, m_pad)
    dev = q.device
    qq = torch.empty(q.shape, dtype=torch.int8, device=dev)
    kq = torch.empty(k.shape, dtype=torch.int8, device=dev)
    # v quantized with keys contiguous, as int8 wgmma takes its B operand
    vt = torch.empty((b, h, d, m_pad), dtype=torch.int8, device=dev)
    amax = torch.empty((3, b, h), dtype=torch.int32, device=dev)
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        err = _library_int8().d3r_mha_attention_int8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qq.data_ptr(), kq.data_ptr(),
            vt.data_ptr(), amax.data_ptr(), out.data_ptr(), b, n, m, m_pad, h, d, scale,
            _build.current_stream(dev))
    _build.check(err, "mha_attention_int8")
    mha_attention_int8.launches += 1
    return out


mha_attention_int8.launches = 0


# ---------------------------------------------------------------------- #
# tensor-parallel composition
# ---------------------------------------------------------------------- #


def tp_attention_ok(mesh, B: int, N: int) -> bool:
    """The JAX package's gate, unchanged: the q tokens shard over the model
    axis (any head count), so N must divide tp; the batch must divide the
    data axis. B is the batch the mesh's data axis holds whole (the
    layers' batch, which `D3RoMa` replicates over every rank)."""
    axes = mesh.axis_sizes
    tp = axes.get(MODEL_AXIS, 1)
    dp = axes.get(DATA_AXIS, 1)
    return tp > 1 and N % tp == 0 and B % dp == 0


def _tp_attention(fn, q, k, v, mesh, sm_scale):
    if not tp_attention_ok(mesh, q.shape[0], q.shape[1]):
        raise ValueError(f"tp_attention_ok refuses B={q.shape[0]}, N={q.shape[1]} under "
                         f"the mesh {mesh.axis_sizes}")
    n = q.shape[1] // mesh.axis_sizes[MODEL_AXIS]
    i = mesh.coord(MODEL_AXIS)
    out = fn(q[:, i * n:(i + 1) * n], k, v, sm_scale)
    return all_gather_cat(out, mesh, MODEL_AXIS, 1)


def mha_attention_tp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                     quant: Optional[str] = None,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """`mha_attention` under a ``(data, model)`` mesh (the JAX package's
    shard_map composition): this rank's N/tp q token rows against the whole,
    replicated K/V through the row-1 kernel (`mha_attention`, bf16) or,
    with quant="int8", the row-1b kernel (`mha_attention_int8`: its q
    scales are the absmax over the local rows, K/V's over all keys), then
    the rows of every rank gathered along the tokens. q [B, N, H, D], k/v
    [B, M, H, D] -> [B, N, H, D] on every rank. `mha_attention_tp.launches`
    counts the calls."""
    fn = mha_attention_int8 if quant == "int8" else mha_attention
    out = _tp_attention(fn, q, k, v, mesh, sm_scale)
    mha_attention_tp.launches += 1
    return out


mha_attention_tp.launches = 0


def mha_attention_tp_plain(q, k, v, mesh, *, quant: Optional[str] = None,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """`mha_attention_tp` with the kernels' plain versions."""
    fn = mha_attention_int8_plain if quant == "int8" else mha_attention_plain
    return _tp_attention(fn, q, k, v, mesh, sm_scale)
