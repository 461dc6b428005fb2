"""int8: per-call activation scales (capture, with optional |x| quantiles,
and replay), weight quantization, and the int8 dense layers and
convolutions of the static and the dynamic modes (all served on CUDA by the
int8 conv kernel, the dense as a 1x1 conv).

Port of `d3roma_tpu/ops/quant.py` (`absmax_scale`, of a weight as
`quantize_weight`, `quantize_int8`, `STATIC_ACT_SCALE`, the act-scale
context with its quantile taps, `consume_act_scale`,
`int8_dot_general_static`, `int8_conv_general_dilated_static`,
`int8_conv_mxu`, `int8_conv_halo`, and the dynamic `int8_dot_general` and
`int8_conv_general_dilated`).

The modes (QUANT_MODES), as the JAX package's `_dense_q` / `_conv_q` and
attention gates read them: False (float); True and "all" (dynamic int8 at
the dense layers and convolutions: each row's or batch item's own absmax
scale, computed on the device; the whole-row attention in int8); "dense"
(dynamic int8 at the dense layers only, float convolutions, the bf16
whole-row attention); "wino" (bf16 Winograd at the stride-1 3x3 convs
ops/winograd.py admits, float elsewhere, float dense layers); and the
static modes below. The dynamic modes take no scale from the tables, so a
capture or replay context leaves them as they are.

The static modes differ only at the convolutions: "static" runs each in the
XLA conv's order of arithmetic; "mxu" and "halo" send the stride-1 SAME 3x3
convs that their TPU kernel's gate admits (`conv3x3_supported` at int8,
`halo_conv_supported`) to the int8 conv kernel in that TPU kernel's order
("tpu", "halo" epilogue) and the rest to the static conv; "wino_static"
sends some 3x3 convs to Winograd (ops/winograd.py). Every int8 conv takes
one "conv" tap whichever route it takes, so all four replay one table.

The static int8 ops take their activation scale in call order: each
quantized dense or convolution calls `consume_act_scale` once per forward.
Under `capture_act_scales` every call records absmax(x)/127 (a tensor on x's
device) and the op runs in float; under `replay_act_scales` every call takes
the next scale of a flat table (pinned indices run in float but still take
their index); outside both contexts every call uses STATIC_ACT_SCALE. A
replay context wraps one forward and must consume its whole table: a short
or a long table raises. Tables are lists of python floats, the JAX package's
JSON form, so a table captured by either package replays in the other.

Arithmetic, as in the JAX package: clip(round_half_even(x / scale), -127,
127) with an IEEE division by an fp32 scale; per-output-channel weight
scales absmax * fp32(1/127) (>= 1e-8), the JAX division as its jitted
forward computes it (ops/kernels/quantize.py::quantize_weight); exact
int32 sums; the dequantization acc * act_scale * weight_scale in fp32, in
that order, then one cast to the input type, and the bias added in that
type.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from d3roma_tpu_torch.ops.kernels import (
    conv2d_int8,
    conv2d_int8_dynamic,
    conv3x3_supported,
    halo_conv_supported,
)
from d3roma_tpu_torch.ops.kernels.conv2d import conv2d_int8_acc_plain
from d3roma_tpu_torch.ops.kernels.quantize import (
    INV127,
    fp32,
    ieee_div,
    quantize_int8_scalar,
    quantize_weight,
)
from d3roma_tpu_torch.ops.kernels.quantize import quantize_int8_plain as quantize_int8

# the uncalibrated activation scale: normalized activations rarely exceed ~8
STATIC_ACT_SCALE = 8.0 / 127.0
QUANT_MODES = (False, True, "all", "dense", "static", "mxu", "halo", "wino", "wino_static")
# the modes whose int8 sites take static (calibrated) activation scales
STATIC_MODES = ("static", "mxu", "halo", "wino_static")
# the modes with dynamic int8 convolutions, and with dynamic int8 dense layers
DYNAMIC_CONV_MODES = (True, "all")
DYNAMIC_DENSE_MODES = (True, "all", "dense")
# the modes whose whole-row attention sites take the int8 kernel
INT8_ATTENTION_MODES = DYNAMIC_CONV_MODES + STATIC_MODES



class _ActScaleCtx(threading.local):
    """The per-thread act-scale context: mode None | "capture" | "replay"."""

    def __init__(self):
        self.mode = None
        self.taps = None
        self.quantiles = None
        self.shape_log = None
        self.scales = None
        self.idx = 0
        self.pins = frozenset()


_ACTX = _ActScaleCtx()


class _ScaleCtxManager:
    def __init__(self, mode: str, payload, pins=(), shape_log=None, quantiles=None):
        self.mode, self.payload = mode, payload
        self.pins, self.shape_log = pins, shape_log
        self.quantiles = tuple(float(q) for q in quantiles) if quantiles else None

    def __enter__(self):
        if _ACTX.mode is not None:
            raise RuntimeError("nested act-scale contexts")
        _ACTX.mode = self.mode
        if self.mode == "capture":
            _ACTX.taps = self.payload
            _ACTX.shape_log = self.shape_log
            _ACTX.quantiles = self.quantiles
        else:
            _ACTX.scales = [float(s) for s in self.payload]
            _ACTX.idx = 0
            _ACTX.pins = frozenset(int(i) for i in (self.pins or ()))
        return self.payload

    def __exit__(self, *exc):
        idx, n = _ACTX.idx, len(_ACTX.scales or ())
        _ACTX.__init__()
        if self.mode == "replay" and exc[0] is None and idx != n:
            raise RuntimeError(
                f"calibrated-scale replay consumed {idx} of {n} scales: the quantized "
                f"call sequence no longer matches the calibration pass")
        return False


def act_ctx_mode() -> Optional[str]:
    """None, "capture" or "replay". Model code keeps the capture forward off
    the kernels that take no tap (whole-row attention) and runs the fused
    GEGLU's math inline there, as the JAX package does."""
    return _ACTX.mode


def capture_act_scales(taps: list, shape_log: Optional[list] = None, quantiles=None):
    """Context: every static int8 op appends absmax(x)/127 (a 0-d fp32
    tensor) to `taps` and computes in float; with `quantiles` (e.g.
    (0.999,)) each tap is the vector [absmax, q...]/127 of |x|'s quantiles
    (abs_quantiles); with `shape_log`, also appends (kind, shape) per call,
    kind one of "dot", "conv", "attn", "geglu"."""
    return _ScaleCtxManager("capture", taps, shape_log=shape_log, quantiles=quantiles)


def replay_act_scales(scales: Sequence[float], pins=()):
    """Context: every static int8 op takes the next of `scales`; indices in
    `pins` run in float but still take their index. The whole table must be
    consumed by the time the context exits."""
    return _ScaleCtxManager("replay", scales, pins=pins)


def consume_act_scale(x: torch.Tensor, kind: str) -> Tuple[str, Optional[float]]:
    """("float", None) under capture (after recording the tap) or for a
    pinned replay index; otherwise ("int8", scale), scale a python float."""
    if _ACTX.mode == "capture":
        if _ACTX.shape_log is not None:
            _ACTX.shape_log.append((kind, tuple(int(d) for d in x.shape)))
        ax = x.detach().float().abs()
        m = ax.amax()
        if _ACTX.quantiles:
            m = torch.cat([m[None], abs_quantiles(ax, _ACTX.quantiles)])
        _ACTX.taps.append(ieee_div(m, 127.0))
        return "float", None
    if _ACTX.mode == "replay":
        if _ACTX.idx >= len(_ACTX.scales):
            raise RuntimeError(
                f"calibrated-scale replay needs more than the {len(_ACTX.scales)} "
                f"captured scales: the quantized call sequence no longer matches "
                f"the calibration pass")
        i = _ACTX.idx
        _ACTX.idx += 1
        if i in _ACTX.pins:
            return "float", None
        return "int8", _ACTX.scales[i]
    return "int8", STATIC_ACT_SCALE


def abs_quantiles(ax: torch.Tensor, quantiles: Sequence[float]) -> torch.Tensor:
    """jnp.quantile(ax.ravel(), quantiles) (method "linear") of a tensor of
    |x| values, fp32 [len(quantiles)]: the position q * (n - 1) in fp32 (n
    converted to fp32, as JAX converts it), the order statistics at its
    floor and ceiling, a[lo] * (1 - w) + a[hi] * w with w the position's
    fraction (in the jitted form's order of arithmetic). torch.quantile refuses tensors of more than 2^24 elements
    (the VAE's sites hold ~1e9 at batch 16): the two order statistics come
    from one torch.topk from the nearer end (k = n * (1 - q) + 1 elements
    for a high quantile), the positions from the shape alone, so nothing is
    read back to the host."""
    flat = ax.reshape(-1)
    count = flat.numel()
    n = np.float32(count)
    out = []
    for q in quantiles:
        pos = np.float32(np.float32(q) * (n - np.float32(1.0)))
        lo, hi = np.floor(pos), np.ceil(pos)
        w_hi = np.float32(pos - lo)
        w_lo = np.float32(np.float32(1.0) - w_hi)
        # clamped to n - 1 in fp32 (n itself rounded past 2^24), then to the
        # last element, as JAX's gather clamps an index past the end
        lo = min(int(min(max(lo, 0.0), n - 1)), count - 1)
        hi = min(int(min(max(hi, 0.0), n - 1)), count - 1)
        if count - lo <= hi + 1:  # the largest count - lo values, descending
            top = torch.topk(flat, count - lo, largest=True, sorted=True).values
            a_lo, a_hi = top[count - 1 - lo], top[count - 1 - hi]
        else:  # the smallest hi + 1 values, ascending
            top = torch.topk(flat, hi + 1, largest=False, sorted=True).values
            a_lo, a_hi = top[lo], top[hi]
        # a_lo * w_lo + round(a_hi * w_hi) with one rounding of the sum (the
        # fused multiply-add the jitted JAX form compiles to; exact products
        # in fp64)
        out.append((a_lo.double() * float(w_lo) + (a_hi * float(w_hi)).double()).float())
    return torch.stack(out)


def _int_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [m, k] @ [k, n] -> int32, through float64 (exact below
    2^53; fp32 stops being exact past 2^24)."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def int8_linear(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, act_scale: float,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = dequant(quant(x) @ wq.T) + bias. x [..., K] in the compute type,
    wq [N, K] int8, ws [N] fp32.

    On CUDA this is the int8 conv kernel as a 1x1 convolution over the rows
    (its epilogue is the dense's dequantization and bias), which takes one
    host call and two launches (quantize, product) where XLA's int8 dot plus
    PyTorch's elementwise dequantization would take seven; on the CPU the
    same arithmetic in plain ops. Either way the quantization is counted on
    quantize_int8_scalar.launches."""
    ls = fp32(act_scale)
    lead, k, n = x.shape[:-1], x.shape[-1], wq.shape[0]
    b = None if bias is None else bias.to(x.dtype)
    if x.device.type == "cuda":
        out = conv2d_int8(x.reshape(1, 1, -1, k), wq.view(n, 1, 1, k), ws, ls, b, 1, 0)
        return out.reshape(lead + (n,))
    quantize_int8_scalar.launches += 1  # the CUDA path's quantize, counted alike
    acc = _int_matmul_plain(quantize_int8(x.reshape(-1, k), ls), wq.t())
    out = (acc.float() * ls * ws).to(x.dtype)
    if b is not None:
        out = out + b
    return out.reshape(lead + (n,))


def _dynamic_through_scale(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, stride: int,
                           padding: int, per_row: bool) -> torch.Tensor:
    """The dynamic int8 op's plain arithmetic (without the bias) with the
    scale left in the graph: the JAX package's function of x as jax.grad
    sees it, where the rounding has a zero derivative and the gradient
    reaches x through each group's absmax scale alone."""
    s = torch.clamp_min(x.float().abs().amax(dim=(3,) if per_row else (1, 2, 3), keepdim=True)
                        * INV127, 1e-8)
    acc = conv2d_int8_acc_plain(quantize_int8(x.detach(), s.detach()), wq, stride,
                                padding).float()
    return (acc * s * ws).to(x.dtype)


class _DynamicInt8(torch.autograd.Function):
    """The dynamic int8 op (the kernel on CUDA, its plain version on the
    CPU) with the JAX package's gradient: the backward differentiates the
    plain version through the absmax scales (_dynamic_through_scale)."""

    @staticmethod
    def forward(ctx, x, wq, ws, bias, stride, padding, per_row):
        ctx.save_for_backward(x, wq, ws)
        ctx.conf = (stride, padding, per_row, bias is not None)
        return conv2d_int8_dynamic(x, wq, ws, bias, stride, padding, per_row=per_row)

    @staticmethod
    def backward(ctx, grad_out):
        x, wq, ws = ctx.saved_tensors
        stride, padding, per_row, has_bias = ctx.conf
        gx = gb = None
        if ctx.needs_input_grad[0]:
            with torch.enable_grad():
                xi = x.detach().requires_grad_(True)
                (gx,) = torch.autograd.grad(
                    _dynamic_through_scale(xi, wq, ws, stride, padding, per_row), xi, grad_out)
        if has_bias and ctx.needs_input_grad[3]:
            gb = grad_out.reshape(-1, grad_out.shape[-1]).sum(0)
        return gx, None, None, gb, None, None, None


def _dynamic(x, wq, ws, bias, stride, padding, per_row=False):
    """conv2d_int8_dynamic, through _DynamicInt8 where autograd records."""
    if torch.is_grad_enabled() and (x.requires_grad or (bias is not None
                                                        and bias.requires_grad)):
        return _DynamicInt8.apply(x, wq, ws, bias, stride, padding, per_row)
    return conv2d_int8_dynamic(x, wq, ws, bias, stride, padding, per_row=per_row)


def int8_linear_dynamic(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dynamic int8 dense (`int8_dot_general`): each row of x [..., K]
    quantized at its own scale max(absmax * fp32(1/127), 1e-8), exact int32
    sums with wq [N, K], (acc * s_row) * ws in fp32, one cast to x's type,
    the bias added in that type. The dynamic int8 conv kernel as a 1x1
    convolution over the rows, each row a scale group. Under autograd,
    the gradient is the JAX package's (_DynamicInt8)."""
    lead, k, n = x.shape[:-1], x.shape[-1], wq.shape[0]
    b = bias if bias is None or bias.dtype == x.dtype else bias.to(x.dtype)
    out = _dynamic(x.reshape(1, 1, -1, k), wq.view(n, 1, 1, k), ws, b, 1, 0, per_row=True)
    return out.reshape(lead + (n,))


def int8_conv_dynamic(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                      bias: Optional[torch.Tensor], stride: int, padding: int) -> torch.Tensor:
    """The dynamic int8 convolution (`int8_conv_general_dilated`): each
    batch item of x (NHWC, the compute type) quantized at its own scale,
    exact int32 sums with wq [Cout, KH, KW, Cin], (acc * s_item) * ws, one
    cast, the bias (in x's type) added after it. Under autograd, the
    gradient is the JAX package's (_DynamicInt8)."""
    return _dynamic(x, wq, ws, bias, stride, padding)


def int8_conv_static(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                     bias: Optional[torch.Tensor], stride: int, padding: int,
                     float_conv: Callable[[], torch.Tensor],
                     epilogue: str = "xla") -> torch.Tensor:
    """One static int8 convolution site: one "conv" tap on x; under capture
    (or at a pinned index) `float_conv()`, else the int8 conv of x (NHWC, in
    the compute type) with wq [Cout, KH, KW, Cin] int8, ws [Cout] fp32 and
    the bias added after the cast, in x's type, with `epilogue`'s order of
    arithmetic."""
    mode, scale = consume_act_scale(x, "conv")
    if mode == "float":
        return float_conv()
    return conv2d_int8(x, wq, ws, fp32(scale), bias, stride, padding, epilogue)


def _conv_geometry(wq: torch.Tensor, stride: int, padding: int):
    """The HWIO weight shape, strides and padding of a port conv, in the
    form the JAX gates take them."""
    return ((wq.shape[1], wq.shape[2], wq.shape[3], wq.shape[0]), (stride, stride),
            ((padding, padding), (padding, padding)))


def int8_conv_mxu(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                  bias: Optional[torch.Tensor], stride: int, padding: int,
                  float_conv: Callable[[], torch.Tensor]) -> torch.Tensor:
    """quant="mxu": a stride-1 SAME 3x3 conv whose int8 frame the TPU
    kernel's gate admits takes the int8 kernel in `conv3x3_flat`'s order,
    acc * (act_scale * ws); any other conv the static conv. One "conv" tap
    either way."""
    hwio, strides, pad = _conv_geometry(wq, stride, padding)
    ok = conv3x3_supported(tuple(x.shape), hwio, strides, pad, torch.int8)
    return int8_conv_static(x, wq, ws, bias, stride, padding, float_conv,
                            "tpu" if ok else "xla")


def int8_conv_halo(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                   bias: Optional[torch.Tensor], stride: int, padding: int,
                   float_conv: Callable[[], torch.Tensor]) -> torch.Tensor:
    """quant="halo": a stride-1 SAME 3x3 conv the halo kernel's gate admits
    takes the int8 kernel in `conv3x3_halo`'s order (an int32 partial per
    row of taps, added in fp32, times act_scale * ws); any other conv the
    static conv. One "conv" tap either way."""
    hwio, strides, pad = _conv_geometry(wq, stride, padding)
    ok = halo_conv_supported(tuple(x.shape), hwio, strides, pad)
    return int8_conv_static(x, wq, ws, bias, stride, padding, float_conv,
                            "halo" if ok else "xla")


# the int8 conv route of each static mode (Winograd sites of "wino_static"
# are routed before it)
INT8_CONV_ROUTES = {"static": int8_conv_static, "wino_static": int8_conv_static,
                    "mxu": int8_conv_mxu, "halo": int8_conv_halo}


def stack_taps(taps: List[torch.Tensor], width: int = 1) -> np.ndarray:
    """The captured taps of one pass as fp32 numpy: a vector of scalar taps,
    or [calls, width] rows of quantile taps."""
    if not taps:
        return np.zeros((0,) if width == 1 else (0, width), np.float32)
    return torch.stack([t.float() for t in taps]).cpu().numpy().astype(np.float32)
