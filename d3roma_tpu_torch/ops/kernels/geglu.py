"""GEGLU feed-forward: the CUDA kernels, their plain PyTorch versions, the
gate, the host-side plan of a call and the launch counters.

Port of `d3roma_tpu/ops/pallas/geglu.py::geglu_ff`: the bf16 path (kernel
body `_kernel_bf16`) is `geglu_ff` over `csrc/geglu.cu`; the static int8
path (`_kernel_int8`, with the wrapper's quantization of x and of the
weights) is `geglu_ff_int8` over `csrc/geglu_int8.cu`. Both are GEMMs on
the TMA + wgmma building blocks of `csrc/sm90_gemm.cuh`; each source note
says what bounds the kernel on the H100 and how it is built around that.
`geglu_ff_tp` is the tensor-parallel composition of both (`geglu_ff_tp` of
the JAX package), with its gate `tp_geglu_ok`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from d3roma_tpu_torch.ops.kernels import _build
from d3roma_tpu_torch.ops.kernels.quantize import (
    act_workspace,
    fp32,
    ieee_div,
    quantize_int8_plain,
    quantize_int8_scalar,
)
from d3roma_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce
from d3roma_tpu_torch.parallel.tensor import MODEL_AXIS

# rows of a tile of the CUDA kernels (csrc/sm90_gemm.cuh: kBlockRows), and
# hidden columns of a tile of their first product (csrc/geglu*.cu:
# kGateCols; 32 was slower at every flagship shape)
BLOCK_ROWS = 128
GATE_COLS = 64
H100_SMS = 132


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


def _library() -> ctypes.CDLL:
    lib = _build.load("geglu")
    fn = lib.d3r_geglu_ff_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@dataclass(frozen=True)
class GegluPlan:
    """How the CUDA kernels cut one call. out_cols: output columns per tile
    of the second product (64 or 128); splits: blocks that share the second
    product's contraction axis F, cut at the TPU kernel's blk_cols chunks
    (1, or one per chunk); workspace_bytes: the one scratch buffer the
    wrapper allocates, laid out as `_workspace` cuts it."""
    out_cols: int
    splits: int
    workspace_bytes: int


# geglu_plan's model of the second product, fitted to the kernels' times on
# the H100 at the flagship shapes (chip_smoke.py's GEGLU cases). A tile
# costs its stages, plus TILE_STAGES for the fill and the epilogue, times
# the rows it loads a stage (128 of A and out_cols of B, 128 bytes each:
# the L2 feed bounds these GEMMs). A split adds its partial sums' round
# trip, one such unit per SPLIT_BYTES_PER_UNIT bytes, and a launch.
TILE_STAGES = 6
SPLIT_BYTES_PER_UNIT = 6800
SPLIT_LAUNCH_UNITS = 500


@functools.lru_cache(maxsize=256)
def geglu_plan(rows: int, c: int, f: int, int8: bool, sms: int = H100_SMS) -> GegluPlan:
    """The second product's tiles in one call on a card with `sms` SMs: the
    output width (128 or 64) and split of F (none, or one block per
    blk_cols chunk) with the least modelled time, waves of tiles times a
    tile's bytes, a split paying for its partial sums."""
    m_tiles = -(-rows // BLOCK_ROWS)
    blk_cols = pick_cols(f)
    chunks = f // blk_cols if f % blk_cols == 0 and blk_cols % 64 == 0 else 1
    k_stages = f // (128 if int8 else 64)

    def cost(plan):
        cols, splits = plan
        waves = -(-m_tiles * -(-c // cols) * splits // sms)
        partial = ((splits + 1) * 4 * rows * c / SPLIT_BYTES_PER_UNIT + SPLIT_LAUNCH_UNITS
                   if splits > 1 else 0)
        return waves * (k_stages // splits + TILE_STAGES) * (128 + cols) + partial, splits

    out_cols, splits = min(((cols, s) for s in sorted({1, chunks}) for cols in (128, 64)),
                           key=cost)
    partial = 4 * splits * rows * c if splits > 1 else 0
    if int8:
        table = 4 * -(-rows // pick_rows(c)[1]) * chunks
        return GegluPlan(out_cols, splits, rows * f + partial + table)
    return GegluPlan(out_cols, splits, 2 * rows * f + partial)


def _workspace(plan: GegluPlan, rows: int, c: int, f: int, int8: bool, device):
    """The plan's scratch, one allocation: y (bf16 [rows, F]; int8: yq
    [rows, F]), then the split partial sums (fp32 [splits, rows, C]), then,
    for int8, the scale table. Returns the addresses of the three parts
    (0 for one that is absent); each starts 16-byte aligned, as F % 64 == 0
    and C % 16 == 0."""
    ws = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=device)
    y = ws.data_ptr()
    partial = y + (1 if int8 else 2) * rows * f
    table = partial + (4 * plan.splits * rows * c if plan.splits > 1 else 0)
    return ws, y, partial if plan.splits > 1 else 0, table if int8 else 0


def _check_cuda(x, w1h, w1g, w2, biases) -> None:
    """What the kernels take: bf16 x and weights, fp32 biases, C % 16 == 0,
    F % 64 == 0; x and the biases contiguous, each weight the transpose of
    a contiguous tensor (the kernels read the contraction axis
    contiguously, as FeedForward's operands lay it out); all on x's
    device; x and the weights 16-byte aligned (TMA reads them)."""
    c = x.shape[-1]
    f = w1h.shape[1]
    if c % 16 or f % 64:
        raise ValueError(f"the CUDA GEGLU kernel takes C % 16 == 0 and F % 64 == 0, "
                         f"got C={c}, F={f}")
    weights = (w1h, w1g, w2)
    if x.dtype != torch.bfloat16 or any(w.dtype != torch.bfloat16 for w in weights):
        raise TypeError(f"the CUDA GEGLU kernel takes bfloat16 x and weights, got "
                        f"{[t.dtype for t in (x, *weights)]}")
    if any(t.dtype != torch.float32 for t in biases):
        raise TypeError(f"the CUDA GEGLU kernel takes float32 biases, got "
                        f"{[t.dtype for t in biases]}")
    if any(w.stride() != (1, w.shape[0]) for w in weights):
        raise ValueError(f"the CUDA GEGLU kernel takes each weight as the transpose of a "
                         f"contiguous tensor, got strides {[w.stride() for w in weights]}")
    if not (x.is_contiguous() and all(t.is_contiguous() for t in biases)):
        raise ValueError("x and the biases must be contiguous")
    if any(t.device != x.device for t in (*weights, *biases)):
        raise ValueError(f"every operand must be on x's device {x.device}")
    if any(t.data_ptr() % 16 for t in (x, *weights)):
        raise ValueError("x and the weights must be 16-byte aligned")


def geglu_ff(x: torch.Tensor, w1h: torch.Tensor, w1g: torch.Tensor,
             w2: torch.Tensor, b1h: Optional[torch.Tensor] = None,
             b1g: Optional[torch.Tensor] = None,
             b2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, N, C]; w1h/w1g [C, F]; w2 [F, C]; biases [F]/[F]/[C] -> [B, N, C].

    CUDA tensors go to the Hopper kernels (bf16 x and weights, fp32
    biases, C % 16 == 0, F % 64 == 0; x contiguous, each weight the
    transpose of a contiguous tensor, as FeedForward's operands are) or
    raise; CPU tensors take the plain version. `geglu_ff.launches` counts
    the calls that went through this wrapper."""
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
    plan = geglu_plan(rows, c, f, False, _build.sm_count(x.device.index))
    out = torch.empty((b, n, c), dtype=x.dtype, device=x.device)
    ws, y, partial, _ = _workspace(plan, rows, c, f, False, x.device)
    with torch.cuda.device(x.device):
        err = _library().d3r_geglu_ff_bf16(
            x.data_ptr(), w1h.data_ptr(), w1g.data_ptr(), w2.data_ptr(),
            *(t.data_ptr() for t in biases), y, partial, out.data_ptr(),
            rows, c, f, plan.out_cols, plan.splits, _build.current_stream(x.device))
    _build.check(err, "geglu_ff")
    geglu_ff.launches += 1
    return out


geglu_ff.launches = 0


@functools.lru_cache(maxsize=64)
def pick_cols(f: int) -> int:
    """The TPU kernel's F chunk (`_pick_cols`), which is also the width of
    its scale grid: the largest multiple of 128 up to 1024 dividing F."""
    for d in range(min(1024, f), 0, -128):
        if f % d == 0:
            return d
    return min(1024, f)


@functools.lru_cache(maxsize=64)
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


def _library_int8() -> ctypes.CDLL:
    lib = _build.load("geglu_int8")
    fn = lib.d3r_geglu_ff_int8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_float] + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
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
    if any(t.dtype != torch.int8 for t in (w1hq, w1gq, w2q)):
        raise TypeError("geglu_ff_int8 takes int8 weights")
    if any(t.dtype != torch.float32 or t.device != x.device for t in (*scales, *biases)):
        raise TypeError("geglu_ff_int8 takes fp32 scales and biases on x's device")


def _check_cuda_int8(x, weights, vectors) -> None:
    """What the kernels take beyond _check_int8: bf16 x, C % 16 == 0,
    F % 128 == 0; the weights contiguous, 16-byte aligned (TMA reads them)
    and on x's device; the scales and biases contiguous."""
    c, f = x.shape[-1], weights[0].shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA int8 GEGLU kernel takes bf16 x, got {x.dtype}")
    if c % 16 or f % 128:
        raise ValueError(f"the CUDA int8 GEGLU kernel takes C % 16 == 0 and F % 128 == 0, "
                         f"got C={c}, F={f}")
    if any(t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16
           for t in weights):
        raise ValueError("the int8 GEGLU weights must be contiguous, 16-byte aligned and on "
                         "x's device")
    if not all(t.is_contiguous() for t in vectors):
        raise ValueError("the int8 GEGLU scales and biases must be contiguous")


def geglu_ff_int8(x: torch.Tensor, w1hq: torch.Tensor, w1gq: torch.Tensor,
                  w2q: torch.Tensor, s1h: torch.Tensor, s1g: torch.Tensor,
                  s2: torch.Tensor, b1h: torch.Tensor, b1g: torch.Tensor,
                  b2: torch.Tensor, act_scale: float) -> torch.Tensor:
    """The fused GEGLU with both products in int8 (the TPU kernel's
    quant="static"): x [B, N, C] is quantized at `act_scale`; see
    geglu_ff_int8_plain for the operands and the arithmetic.

    CUDA tensors go to the Hopper kernels (bf16 x, C % 16 == 0,
    F % 128 == 0), whose C entry point quantizes x into the stream's int8
    workspace (act_workspace) and runs the passes, in one call; or raise.
    CPU tensors take the plain version. `geglu_ff_int8.launches` counts the
    calls that went through this wrapper, `quantize_int8_scalar.launches`
    their quantizations."""
    act_scale = fp32(act_scale)
    _check_int8(x, w1hq, w1gq, w2q, (s1h, s1g, s2), (b1h, b1g, b2))
    if x.device.type == "cpu":
        geglu_ff_int8.launches += 1
        quantize_int8_scalar.launches += 1
        return geglu_ff_int8_plain(x, w1hq, w1gq, w2q, s1h, s1g, s2, b1h, b1g, b2, act_scale)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_ff_int8 runs on CUDA or the CPU, got {x.device}")
    b, n, c = x.shape
    f = w1hq.shape[0]
    rows = b * n
    _, sub_rows = pick_rows(c)
    blk_cols = pick_cols(f)
    vectors = (s1h, s1g, b1h, b1g, s2, b2)
    _check_cuda_int8(x, (w1hq, w1gq, w2q), vectors)
    x = x.contiguous()
    plan = geglu_plan(rows, c, f, True, _build.sm_count(x.device.index))
    ws, yq, partial, table = _workspace(plan, rows, c, f, True, x.device)
    out = torch.empty((b, n, c), dtype=x.dtype, device=x.device)
    stream = _build.current_stream(x.device)
    with torch.cuda.device(x.device):
        err = _library_int8().d3r_geglu_ff_int8(
            x.data_ptr(), act_workspace(x.device, stream, rows * c), w1hq.data_ptr(),
            w1gq.data_ptr(), w2q.data_ptr(), *(t.data_ptr() for t in vectors), table, yq,
            partial, out.data_ptr(), act_scale, rows, c, f, sub_rows, blk_cols, plan.out_cols,
            plan.splits, stream)
    _build.check(err, "geglu_ff_int8")
    geglu_ff_int8.launches += 1
    quantize_int8_scalar.launches += 1
    return out


geglu_ff_int8.launches = 0


# ---------------------------------------------------------------------- #
# tensor-parallel composition
# ---------------------------------------------------------------------- #


def tp_geglu_ok(mesh, c: int, f: int, batch: int) -> bool:
    """The JAX package's gate, unchanged: F splits over the model axis into
    chunks that geglu_supported admits themselves (at tp=4 the C=320
    level's F=1280 chunks to 320 and fails), and the batch divides the data
    axis (the layers' batch, replicated over every rank by `D3RoMa`)."""
    axes = mesh.axis_sizes
    tp = axes.get(MODEL_AXIS, 1)
    dp = axes.get(DATA_AXIS, 1)
    return tp > 1 and f % tp == 0 and geglu_supported(c, f // tp) and batch % dp == 0


def _tp_geglu(fn, x, chunk, b2, mesh, act_scale):
    c = x.shape[-1]
    f = chunk[0].shape[1 if act_scale is None else 0] * mesh.axis_sizes.get(MODEL_AXIS, 1)
    if not tp_geglu_ok(mesh, c, f, x.shape[0]):
        raise ValueError(f"tp_geglu_ok refuses C={c}, F={f}, batch {x.shape[0]} under the "
                         f"mesh {mesh.axis_sizes}")
    if act_scale is None:
        part = fn(x, *chunk)
    else:
        part = fn(x, *chunk, x.new_zeros(c, dtype=torch.float32), act_scale)
    y = all_reduce(part, mesh, MODEL_AXIS)
    return y + b2.to(y.dtype)


def geglu_ff_tp(x: torch.Tensor, chunk, b2: torch.Tensor, mesh,
                act_scale: Optional[float] = None) -> torch.Tensor:
    """`geglu_ff` under a ``(data, model)`` mesh (the JAX package's
    shard_map composition): W1 split by columns and W2 by rows over the
    hidden F axis, Megatron-style. Each rank runs the fused kernel on its F
    chunk without b2, one all-reduce sums the partial [B, N, C] outputs (in
    fp32, rounded once to x's type), and b2 is added once.

    `chunk`: this rank's chunk of the operands, (w1h, w1g, w2, b1h, b1g)
    as `geglu_ff` takes them ([C, F/tp], [C, F/tp], [F/tp, C], [F/tp],
    [F/tp]), or, with `act_scale` (static int8), (w1hq, w1gq, w2q, s1h,
    s1g, s2, b1h, b1g) as `geglu_ff_int8` takes them, quantized from the
    chunk: W1's column scales are the whole weight's, W2's scales the
    absmax over the chunk's F, and the gated intermediate is requantized
    per (row block, chunk) tile of the chunk. b2 [C] is whole.
    `geglu_ff_tp.launches` counts the calls."""
    fn = geglu_ff if act_scale is None else geglu_ff_int8
    out = _tp_geglu(fn, x, chunk, b2, mesh, act_scale)
    geglu_ff_tp.launches += 1
    return out


geglu_ff_tp.launches = 0


def geglu_ff_tp_plain(x, chunk, b2, mesh, act_scale: Optional[float] = None) -> torch.Tensor:
    """`geglu_ff_tp` with the kernels' plain versions."""
    fn = geglu_ff_plain if act_scale is None else geglu_ff_int8_plain
    return _tp_geglu(fn, x, chunk, b2, mesh, act_scale)
