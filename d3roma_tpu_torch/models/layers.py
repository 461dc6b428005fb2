"""Shared building blocks for the diffusion UNet and the VAE.

Port of `d3roma_tpu/models/layers.py`, taking the JAX package's non-TPU
(XLA) branches as the math. Modules take and return NHWC tensors, the JAX
layout; a convolution sees the NCHW view of an NHWC tensor, which is
channels_last in memory, so no layout copy is made. Parameter names follow
diffusers (`norm1`, `conv1`, `attn1.to_out.0`, `ff.net.0.proj`, ...), so a
diffusers state dict loads as it is.

A module computes in the dtype of its parameters (bf16 after
`half_precision()`), or in its `dtype` where `set_compute_dtype` set one:
bf16 compute over fp32 parameters, Flax's module `dtype` with `param_dtype`
fp32 (the JAX trainer's `mixed_precision="bf16"`). A dense layer or
convolution then casts its weight and bias at use (autograd returns fp32
gradients through the cast), a norm folds its fp32 affine with the fp32
statistics and casts the result, as Flax's norms do. The exceptions mirror
the reference: norm statistics are fp32, the UNet's and the VAE's
`conv_out` run in fp32 and the VAE's quant convs in the promoted type of
input and weight, both on the unrounded weight. The kernel routes (int8,
Winograd, the fused attention, GEGLU and GroupNorm) read the weights in
their own dtype: inference runs them after `half_precision()`.

Where the JAX package calls a Pallas kernel on this path, the module calls
the port's kernel wrapper (`ops/kernels/`): whole-row attention at
self-attention sites of >= 512 keys (`use_flash="pallas-self"`), and the
fused GEGLU feed-forward (`fused=True`). Sites the JAX package leaves to
XLA (`jax.nn.dot_product_attention`, the unfused feed-forward) are plain
torch ops here.

`quant="static"` (`set_quant`) is the JAX package's static int8 mode
(`ops/quant.py`): the dense layers and convolutions of the resnets,
transformers, attention blocks and resamplers take one activation scale each
in call order and run in int8 (on CUDA both through the int8 conv kernel,
the dense as a 1x1 conv); the attention sites that take the whole-row kernel take its int8
version, and the fused feed-forward the int8 GEGLU kernel. Under a capture
context (calibration) every such site records its tap and runs in float, and
the attention kernels are skipped, as in the JAX package.
`quant="wino_static"` is the same, except that every stride-1 3x3 conv that
`ops/winograd.py` routes to Winograd runs the bf16 Winograd kernel and takes
no scale. `quant="mxu"` and `quant="halo"` are "static" with the stride-1
3x3 convs their TPU kernel's gate admits dequantized in that kernel's order
(`ops/quant.py::int8_conv_mxu`, `int8_conv_halo`).

The dynamic modes take no scale: under `quant=True` / `"all"` every dense
layer and convolution of those sites runs the dynamic int8 kernel (each
row's or batch item's own scale, on the device) and the whole-row attention
sites take the int8 kernel; under `"dense"` only the dense layers do, and
the attention sites take the bf16 kernel. `"wino"` runs the stride-1 3x3
convs inside Winograd's liveness cap by Winograd (`ops/winograd.py::
winograd_conv`: the kernel on the card), the rest and the dense layers in
float. Under every truthy non-static mode the fused self-attention
and the fused GEGLU fall back to their unfused sites, as the JAX package's
gates do (their kernels have a static int8 and a bf16 body only).

Two further kernels of the JAX package's opt-in configuration: the fused
GroupNorm + SiLU (`GroupNormSiLU.fused`, `set_kernels(fused_norm=True)`) at
shapes its gate admits, and the fused self-attention
(`use_flash="fused"`), whose int8 body serves every self-attention site the
gate admits under static int8 and takes one scale of kind "attn", and whose
bf16 body serves the sites the gate admits at itemsize 2 without int8. A
truthy `use_flash` also sends the self-attention sites of >= FLASH_MIN_SEQ
tokens that took no other kernel to the whole-row bf16 kernel, where the
JAX package takes the TPU library's flash attention.

Tensor parallelism (`parallel/tensor.py`): a Linear or Conv2d whose weight
`shard_params_tp` cut holds its `tp_shard` and computes with it (the
output's slice gathered, or the input's slice and the partial products
summed). With `tp_mesh` set (`set_tp_mesh`), the whole-row attention sites
take `mha_attention_tp` and the fused feed-forward `geglu_ff_tp` where
their gates `tp_attention_ok` / `tp_geglu_ok` admit the shape, and the
plain path where not; the fused self-attention and the flash route are off,
as in the JAX package. The gates come before any activation scale is taken,
so a pipeline calibrated under the mesh replays in the same call order.
Under autograd the shards' collectives carry gradients (a sharded layer's
input through `TPShard.copy_input`). An unquantized feed-forward off the
fused kernel runs on each rank's chunk of the hidden width
(`FeedForward._inline`), in training and inference alike.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from d3roma_tpu_torch.ops.kernels import (
    fused_attention_supported,
    fused_self_attention_bf16,
    fused_self_attention_int8,
    geglu_ff,
    geglu_ff_int8,
    geglu_ff_tp,
    geglu_supported,
    group_norm_silu,
    group_norm_silu_supported,
    mha_attention,
    mha_attention_int8,
    mha_attention_tp,
    mha_supported,
    tp_attention_ok,
    tp_geglu_ok,
    winograd_weight,
)
from d3roma_tpu_torch.ops.quant import (
    DYNAMIC_CONV_MODES,
    DYNAMIC_DENSE_MODES,
    INT8_ATTENTION_MODES,
    INT8_CONV_ROUTES,
    QUANT_MODES,
    STATIC_MODES,
    act_ctx_mode,
    consume_act_scale,
    int8_conv_dynamic,
    int8_linear,
    int8_linear_dynamic,
    quantize_weight,
)
from d3roma_tpu_torch.ops.winograd import (
    conv_hwio_shape,
    wino_eligible,
    wino_static_route,
    winograd_conv,
)

# use_flash values ported so far: False (plain attention everywhere), True
# (the whole-row kernel at self-attention sites of >= FLASH_MIN_SEQ tokens,
# the JAX package's TPU flash route), "pallas" (the whole-row kernel at every
# site with >= 512 keys), "pallas-self" (the kernel at such self-attention
# sites only) and "fused" (the fused self-attention kernel at every
# self-attention site its gate admits; cross-attention unfused). Every truthy
# value takes the flash route at the long self-attention sites the others
# leave.
ATTENTION_ROUTES = (False, True, "pallas", "pallas-self", "fused")
# the JAX CrossAttention's default `flash_min_seq`, which its UNet keeps
FLASH_MIN_SEQ = 1024


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embeddings, fp32. t: [B] -> [B, dim]."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


def _weight_key(*params) -> tuple:
    """Identifies a set of weights and their values (PyTorch bumps a
    tensor's _version on every in-place change; views of one storage
    differ in their shapes)."""
    return tuple((p.data_ptr(), p._version, p.dtype, p.device, tuple(p.shape)) for p in params
                 if p is not None)


class _Cached:
    """Operands made once from a set of weights by `make(*weights)` and kept
    until a weight changes."""

    def __init__(self, make):
        self._make, self._cache = make, None

    def get(self, *weights):
        key = _weight_key(*weights)
        if self._cache is None or self._cache[0] != key:
            with torch.no_grad():
                self._cache = (key, self._make(*weights))
        return self._cache[1]


def module_dtype(layer: nn.Module) -> torch.dtype:
    """The dtype `layer` computes in: its `dtype`, else its weight's."""
    return layer.dtype or layer.weight.dtype


def _int8_conv_weight(w: torch.Tensor):
    """`quantize_weight` of a conv weight laid out [Cout, KH, KW, Cin]:
    K-contiguous rows, as the int8 conv kernel takes them."""
    return quantize_weight(w.permute(0, 2, 3, 1))


class Linear(nn.Linear):
    """nn.Linear that computes in its weight's dtype (Flax Dense casts its
    input to the module dtype the same way). With a static mode it takes one
    activation tap on that cast input and runs the static int8 dense; with
    True, "all" or "dense" the dynamic int8 dense."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype: Optional[torch.dtype] = None  # see set_compute_dtype
        self.quant = False
        self.tp_shard = None
        self._int8 = _Cached(self._quantize)

    def _quantize(self, w: torch.Tensor):
        """int8 weights; a row-parallel shard takes the whole weight's scale."""
        tp = self.tp_shard
        return quantize_weight(w, None if tp is None or tp.dim == 0 else tp.weight_absmax(w))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = module_dtype(self)
        x = x.to(dt)
        tp = self.tp_shard
        if tp is None:
            bias, xin = self.bias, x
        else:  # the tap stays on the whole x, as the JAX partitioner's
            bias = tp.local_bias(self.bias)
            xin = tp.input_slice(x) if tp.dim == 1 else tp.copy_input(x)
        y = None
        if self.quant in STATIC_MODES:
            mode, scale = consume_act_scale(x, "dot")
            if mode == "int8":
                wq, ws = self._int8.get(self.weight)
                y = int8_linear(xin, wq, ws, scale, bias)
        elif self.quant in DYNAMIC_DENSE_MODES:
            y = int8_linear_dynamic(xin, *self._int8.get(self.weight), bias)
        if y is None:
            y = F.linear(xin, self.weight.to(dt), None if bias is None else bias.to(dt))
        return y if tp is None else tp.combine(y, self.bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on NHWC tensors.

    `compute_dtype` None computes in the model's dtype (`dtype`, else the
    weight's: a Flax Conv with dtype=the model's dtype); a torch dtype fixes
    it (the fp32 conv_out sites); "promote" takes the promoted type of input
    and weight (a Flax Conv without a dtype, as the VAE's quant convs).

    quant="wino_static" sends the convs `wino_static_route` admits to the
    Winograd kernel (U = winograd_weight(w), made once per weight; the bias
    added after the output's rounding, as Flax adds it) and the rest to the
    static int8 conv; the other static modes take their int8 conv route
    (`INT8_CONV_ROUTES`). quant="wino" sends the convs `wino_eligible`
    admits to Winograd (`winograd_conv`) and the rest to the float conv; True
    and "all" run the dynamic int8 conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 compute_dtype: Union[None, torch.dtype, str] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding)
        self.compute_dtype = compute_dtype
        self.dtype: Optional[torch.dtype] = None  # see set_compute_dtype
        self.quant = False
        self.tp_shard = None
        self._int8 = _Cached(_int8_conv_weight)
        self._wino = _Cached(winograd_weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC in and out; a shard of the output channels computes its
        slice, then gathers the channels."""
        if self.tp_shard is None:
            return self._forward(x)
        return self.tp_shard.combine(self._forward(self.tp_shard.copy_input(x)), self.bias)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            dt = module_dtype(self)
        elif self.compute_dtype == "promote":
            dt = torch.promote_types(x.dtype, self.weight.dtype)
        else:
            dt = self.compute_dtype
        x = x.to(dt)
        bias = self.bias if self.tp_shard is None else self.tp_shard.local_bias(self.bias)
        bias = None if bias is None else bias.to(dt)
        if self.quant == "wino_static":
            pad = ((self.padding[0],) * 2, (self.padding[1],) * 2)
            chunk = wino_static_route(tuple(x.shape), conv_hwio_shape(self.weight),
                                      self.stride, pad)
            if chunk is not None:
                return winograd_conv(x, self._wino.get(self.weight.to(dt)), dt, bias, chunk)
        elif self.quant == "wino":
            pad = ((self.padding[0],) * 2, (self.padding[1],) * 2)
            chunk = wino_eligible(tuple(x.shape), conv_hwio_shape(self.weight), self.stride,
                                  pad)
            if chunk is not None:
                return winograd_conv(x, self._wino.get(self.weight.to(dt)), dt, bias, chunk)
        elif self.quant in DYNAMIC_CONV_MODES:
            wq, ws = self._int8.get(self.weight)
            return int8_conv_dynamic(x, wq, ws, bias, self.stride[0], self.padding[0])

        def float_conv():
            y = self._conv_forward(x.permute(0, 3, 1, 2), self.weight.to(dt), bias)
            return y.permute(0, 2, 3, 1)

        if self.quant in STATIC_MODES:
            wq, ws = self._int8.get(self.weight)
            return INT8_CONV_ROUTES[self.quant](x, wq, ws, bias, self.stride[0], self.padding[0],
                                                float_conv)
        return float_conv()


def _group_stats(x: torch.Tensor, groups: int):
    """fp32 per-(batch, group) mean and E[x^2] - mean^2 of NHWC x, [B, G]
    each. Both reductions read x as it is and accumulate in fp32 (no fp32
    copy of x, no materialized square)."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b, -1, groups, c // groups)
    n = xg.shape[1] * xg.shape[3]
    mean = xg.mean(dim=(1, 3), dtype=torch.float32)
    sumsq = torch.linalg.vector_norm(xg, dim=(1, 3), dtype=torch.float32).square()
    return mean, sumsq / n - mean.square()


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B, G, C/G] -> [B, 1, ..., 1, C], to broadcast against NHWC x."""
    return v.reshape((v.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],))


class GroupNormSiLU(nn.Module):
    """GroupNorm (+ optional SiLU) with the JAX package's XLA arithmetic:
    fp32 statistics with the variance as E[x^2] - E[x]^2, folded with the
    affine into a per-(batch, channel) scale and shift, then one normalize
    in the compute dtype (not F.group_norm's arithmetic).

    With `fused` (`set_kernels(fused_norm=True)`), a shape the fused
    kernel's gate admits in x's own dtype takes the fused GroupNorm + SiLU
    kernel instead: the normalize and the SiLU in fp32, the output in x's
    dtype, as the JAX package's TPU branch."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5,
                 apply_silu: bool = True):
        super().__init__()
        self.groups, self.eps, self.apply_silu = groups, eps, apply_silu
        self.fused = False
        self.dtype: Optional[torch.dtype] = None  # see set_compute_dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, g = module_dtype(self), self.groups
        if self.fused and group_norm_silu_supported(x.shape, x.dtype):
            return group_norm_silu(x, self.weight, self.bias, g, self.eps, self.apply_silu)
        mean, var = _group_stats(x, g)
        scale = torch.rsqrt(var + self.eps)[..., None] * self.weight.view(g, -1)
        shift = self.bias.view(g, -1) - mean[..., None] * scale
        y = torch.addcmul(_per_channel(shift.to(dt), x), x.to(dt),
                          _per_channel(scale.to(dt), x))
        return F.silu(y, inplace=True) if self.apply_silu else y


class GroupNorm(nn.Module):
    """Flax nn.GroupNorm's arithmetic: fp32 statistics (E[x^2] - E[x]^2,
    clipped at 0), normalize and affine in fp32, one cast to the compute
    dtype. NHWC."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.dtype: Optional[torch.dtype] = None  # see set_compute_dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.groups
        mean, var = _group_stats(x, g)
        inv = torch.rsqrt(var.clamp(min=0.0) + self.eps)
        mul = inv[..., None] * self.weight.float().view(g, -1)
        shift = self.bias.float().view(g, -1) - mean[..., None] * mul
        # x (bf16 or fp32) times an fp32 scale promotes to fp32: the
        # normalize runs in fp32 without a separate copy of x
        y = torch.addcmul(_per_channel(shift, x), x, _per_channel(mul, x))
        return y.to(module_dtype(self))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with Flax's default epsilon, 1e-6 (PyTorch's is 1e-5);
    statistics are fp32 for bf16 inputs in both."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)
        self.dtype: Optional[torch.dtype] = None  # see set_compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(self.weight.dtype), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(module_dtype(self))


class TimestepEmbedding(nn.Module):
    """2-layer MLP lifting the sinusoidal embedding."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class ResnetBlock2D(nn.Module):
    """GroupNorm -> SiLU -> conv -> (+time) -> GroupNorm -> SiLU -> conv (+skip)."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNormSiLU(in_channels, groups, eps)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (Linear(temb_channels, out_channels)
                              if temb_channels is not None else None)
        self.norm2 = GroupNormSiLU(out_channels, groups, eps)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, t_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and t_emb is not None:
            h = h + self.time_emb_proj(F.silu(t_emb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return residual.to(h.dtype) + h


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """jax.nn.dot_product_attention's XLA arithmetic: fp32 logits, fp32
    softmax, probabilities cast to v's type, PV in that type.
    q [B, N, H, D], k/v [B, M, H, D] -> [B, N, H, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, vh).transpose(1, 2)


class SelfAttention2D(nn.Module):
    """Spatial self-attention over H*W tokens with a GroupNorm pre-norm
    (the VAE's mid-block attention; diffusers AttnBlock names)."""

    def __init__(self, channels: int, head_dim: int = 8, groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.quant = False
        self.tp_mesh = None
        self.num_heads = max(1, channels // head_dim)
        self.group_norm = GroupNorm(channels, groups, eps)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        h = self.group_norm(x).reshape(B, H * W, C)
        heads = (B, H * W, self.num_heads, C // self.num_heads)
        q = self.to_q(h).reshape(heads)
        k = self.to_k(h).reshape(heads)
        v = self.to_v(h).reshape(heads)
        d = C // self.num_heads
        # the int8 whole-row kernel (the VAE's single 512-wide head) under
        # the int8 modes but "dense", outside calibration captures, at >= 512
        # tokens; under a mesh through its composition where the gate admits
        attn = None
        if (self.quant in INT8_ATTENTION_MODES and act_ctx_mode() != "capture"
                and H * W >= 512
                and d >= 64 and mha_supported(H * W, d, itemsize=1)):
            if self.tp_mesh is None:
                attn = mha_attention_int8(q, k, v)
            elif tp_attention_ok(self.tp_mesh, B, H * W):
                attn = mha_attention_tp(q, k, v, self.tp_mesh, quant="int8")
        if attn is None:
            attn = dot_product_attention(q, k, v)
        out = self.to_out[0](attn.reshape(B, H * W, C)).reshape(B, H, W, C)
        return x.to(out.dtype) + out


class CrossAttention(nn.Module):
    """Multi-head attention over [B, N, C] queries with an optional
    [B, M, D] context (self-attention when it is None). `use_flash` is one
    of ATTENTION_ROUTES; the whole-row kernel serves sites with >= 512 keys
    that `mha_supported` admits, as in the JAX package; "fused" sends the
    self-attention sites `fused_attention_supported` admits to the fused
    kernel; any truthy value sends the other self-attention sites of >=
    FLASH_MIN_SEQ tokens to the whole-row kernel."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, use_flash=False):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.use_flash = use_flash
        self.quant = False
        self.tp_mesh = None
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim)])
        self._fused_operands = _Cached(self._make_fused_operands)
        self._fused_bf16_operands = _Cached(self._make_fused_bf16_operands)

    @staticmethod
    def _make_fused_bf16_operands(wq, wk, wv, wo, bo):
        """The fused bf16 kernel's operands: Wq, Wk, Wv stacked [3C, C], Wo
        [C, C], bo in fp32."""
        return torch.cat([wq, wk, wv]).contiguous(), wo.contiguous(), bo.float().contiguous()

    @staticmethod
    def _make_fused_operands(wq, wk, wv, wo, bo):
        """The fused int8 kernel's operands: Wq, Wk, Wv quantized per output
        column (the JAX wrapper's per-(head, column) scales) and stacked
        [3C, C] with their scales [3C]; Wo [C, C] and bo in fp32."""
        (q, sq), (k, sk), (v, sv) = (quantize_weight(w) for w in (wq, wk, wv))
        return (torch.cat([q, k, v]).contiguous(), torch.cat([sq, sk, sv]).contiguous(),
                wo.contiguous(), bo.float().contiguous())

    def _fused(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The "fused" route of a self-attention site, or None where the gate
        refuses it (the site then runs unfused). Under static int8 it takes
        one scale of kind "attn" on x; a capture pass or a pinned index runs
        the float math inline (bf16 projections, dot_product_attention, the
        output projection), as the JAX package does. Without int8 it runs
        the bf16 body, gated at the weights' itemsize."""
        B, N, C = x.shape
        inner = self.heads * self.head_dim
        aq = self.quant in STATIC_MODES
        if self.quant and not aq:
            return None  # no dynamic-scale (or Winograd-mode) body: the unfused path
        itemsize = 1 if aq else self.to_q.weight.element_size()
        if not (C == inner and self.to_q.in_features == inner
                and fused_attention_supported(N, inner, self.head_dim, itemsize)):
            return None
        wq, wk, wv = self.to_q.weight, self.to_k.weight, self.to_v.weight
        wo, bo = self.to_out[0].weight, self.to_out[0].bias
        x = x.to(wq.dtype)
        if not aq:
            return fused_self_attention_bf16(
                x, *self._fused_bf16_operands.get(wq, wk, wv, wo, bo), self.heads)
        mode, scale = consume_act_scale(x, "attn")
        if mode == "float":
            heads = (B, N, self.heads, self.head_dim)
            q, k, v = (F.linear(x, w).reshape(heads) for w in (wq, wk, wv))
            return F.linear(dot_product_attention(q, k, v).reshape(B, N, inner), wo, bo)
        return fused_self_attention_int8(x, *self._fused_operands.get(wq, wk, wv, wo, bo),
                                         self.heads, scale)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        is_self = context is None
        mesh = self.tp_mesh
        if self.use_flash == "fused" and is_self and mesh is None:
            out = self._fused(x)
            if out is not None:
                return out
        context = x if is_self else context
        B, N, _ = x.shape
        M = context.shape[1]
        q = self.to_q(x).reshape(B, N, self.heads, self.head_dim)
        k = self.to_k(context).reshape(B, M, self.heads, self.head_dim)
        v = self.to_v(context).reshape(B, M, self.heads, self.head_dim)
        use_kernel = self.use_flash == "pallas" or (self.use_flash == "pallas-self"
                                                    and is_self)
        # the whole-row kernels take no tap, so a calibration capture skips
        # them; the flash route, as the JAX package's, runs under capture too
        capture = act_ctx_mode() == "capture"
        int8 = self.quant in INT8_ATTENTION_MODES
        attn = None
        if use_kernel and M >= 512 and mha_supported(M, self.head_dim) and not capture:
            if mesh is None:
                attn = (mha_attention_int8 if int8 else mha_attention)(q, k, v)
            elif tp_attention_ok(mesh, B, N):
                attn = mha_attention_tp(q, k, v, mesh, quant="int8" if int8 else None)
            # else: the plain path (a site the mesh's gate refuses skips the
            # flash route too, as in the JAX package)
        elif (self.use_flash and is_self and N >= FLASH_MIN_SEQ and mesh is None
              and mha_supported(N, self.head_dim)):
            attn = mha_attention(q, k, v)
        if attn is None:
            attn = dot_product_attention(q, k, v)
        return self.to_out[0](attn.reshape(B, N, self.heads * self.head_dim))


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU MLP with a 4x hidden width (`net.0.proj`, `net.2`). With
    fused=True and a shape
    `geglu_supported` admits, the whole proj -> gelu-gate -> out-proj runs
    in the fused GEGLU kernel; the parameters are the same either way. The
    kernel's operands (W1 split into its h and gate halves, both weights as
    transposed views, fp32 biases) are prepared once per set of weights and
    kept until a weight changes. The fused path is inference-only: the
    kernel has no backward.

    Under `tp_mesh` the fused path runs `geglu_ff_tp` where `tp_geglu_ok`
    admits the shape (the operands made from this rank's F chunk). Off it,
    an unquantized feed-forward on sharded layers runs `_inline` on this
    rank's F chunk, with no gather of the projection; an int8 one the
    unfused path on the sharded dense layers (their int8 modes)."""

    def __init__(self, dim: int, fused: bool = False):
        super().__init__()
        self.dim, self.hidden, self.fused = dim, 4 * dim, fused
        self.quant = False
        self.tp_mesh = None
        self.net = nn.ModuleList([GEGLU(dim, self.hidden), nn.Identity(),
                                  Linear(self.hidden, dim)])
        self._int8 = _Cached(self._make_int8_operands)
        self._operands = _Cached(self._make_operands)

    @staticmethod
    def _make_int8_operands(w1h, w1g, w2, b1h, b1g, b2):
        """The int8 kernel's operands: W1h, W1g [F, C] and W2 [C, F] int8
        with per-column fp32 scales (the JAX wrapper's absmax_scale over the
        contracted axis, so over the F chunk of a shard), fp32 biases."""
        (w1hq, s1h), (w1gq, s1g), (w2q, s2) = (quantize_weight(w) for w in (w1h, w1g, w2))
        return (w1hq, w1gq, w2q, s1h, s1g, s2, b1h.float().contiguous(),
                b1g.float().contiguous(), b2.float().contiguous())

    @staticmethod
    def _make_operands(w1h, w1g, w2, b1h, b1g, b2):
        """The bf16 kernel's operands, JAX-named: W1h, W1g [C, F] and W2
        [F, C] as transposed views of the weights' halves (the K-major
        layout the kernel reads, no copy of a contiguous weight), fp32
        biases."""
        return (w1h.contiguous().t(), w1g.contiguous().t(), w2.contiguous().t(),
                b1h.float().contiguous(), b1g.float().contiguous(), b2.float().contiguous())

    def _weights(self):
        """(W1h, W1g, W2, b1h, b1g, b2) as views of the parameters: this
        rank's F chunk under a mesh (the projection's bias is whole)."""
        proj, out = self.net[0].proj, self.net[2]
        w1, b1 = proj.weight, proj.bias
        f = w1.shape[0] // 2
        b1h, b1g = b1[:self.hidden], b1[self.hidden:]
        if proj.tp_shard is not None:
            b1h, b1g = (proj.tp_shard.part(b, 0) for b in (b1h, b1g))
        return w1[:f], w1[f:], out.weight, b1h, b1g, out.bias

    def _inline(self, x: torch.Tensor) -> torch.Tensor:
        """The fused branch's math in plain ops on the weights, in the
        layers' compute dtype (the JAX package's calibration capture runs it
        inline in XLA, through no quantized dense, so it takes no taps of
        its own); under a mesh on this rank's chunk of the hidden width end
        to end (no gather of the projection), the partial products summed.
        Under autograd x's gradient is the sum of the chunks' and each
        rank's weights get their chunk's: the unfused path's values and
        gradients."""
        proj, out = self.net[0].proj, self.net[2]
        dt = module_dtype(proj)
        x, b1 = x.to(dt), proj.bias
        if proj.tp_shard is not None:
            x, b1 = proj.tp_shard.copy_input(x), proj.tp_shard.local_bias(b1)
        h, gate = F.linear(x, proj.weight.to(dt), b1.to(dt)).chunk(2, dim=-1)
        y = h * F.gelu(gate, approximate="tanh")
        dt = module_dtype(out)
        if out.tp_shard is None:
            return F.linear(y.to(dt), out.weight.to(dt), out.bias.to(dt))
        return out.tp_shard.combine(F.linear(y.to(dt), out.weight.to(dt)), out.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the fused kernel has a static int8 and a bf16 body: the other int8
        # modes take the unfused path (its dense layers in their mode); the
        # mesh's gate comes before the scale is taken
        mesh = self.tp_mesh
        tp_ok = mesh is None or tp_geglu_ok(mesh, x.shape[-1], self.hidden, x.shape[0])
        if (self.fused and (self.quant in STATIC_MODES or not self.quant) and tp_ok
                and geglu_supported(self.dim, self.hidden)):
            weights = self._weights()
            dt = weights[0].dtype
            if self.quant in STATIC_MODES:
                mode, scale = consume_act_scale(x, "geglu")
                if mode == "float":
                    return self._inline(x.to(dt))
                ops = self._int8.get(*weights)
                if mesh is not None:
                    return geglu_ff_tp(x.to(dt), ops[:8], ops[8], mesh, act_scale=scale)
                return geglu_ff_int8(x.to(dt), *ops, scale)
            ops = self._operands.get(*weights)
            if mesh is not None:
                return geglu_ff_tp(x.to(dt), ops[:5], ops[5], mesh)
            return geglu_ff(x.to(dt), *ops)
        if not self.quant and self._paired_shards():
            return self._inline(x)
        return self.net[2](self.net[0](x))

    def _paired_shards(self) -> bool:
        """The projection holds chunk r of each half and the output
        projection the matching input rows (the rules' pairing)."""
        proj, out = self.net[0].proj.tp_shard, self.net[2].tp_shard
        return (proj is not None and out is not None and proj.paired and proj.dim == 0
                and out.dim == 1)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn -> LN -> cross-attn -> LN -> GEGLU FF, all residual."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int,
                 use_flash=False, fused_ff: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, head_dim, use_flash=use_flash)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, head_dim, context_dim, use_flash=use_flash)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim, fused=fused_ff)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GroupNorm -> linear in -> blocks -> linear out,
    residual (SD's use_linear_projection=True layout)."""

    def __init__(self, channels: int, heads: int, head_dim: int, context_dim: int,
                 depth: int = 1, groups: int = 32, use_flash=False,
                 fused_ff: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.norm = GroupNorm(channels, groups, eps=1e-6)
        self.proj_in = Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, head_dim, context_dim,
                                  use_flash=use_flash, fused_ff=fused_ff)
            for _ in range(depth)])
        self.proj_out = Linear(inner, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        h = self.proj_in(self.norm(x).reshape(B, H * W, C))
        for block in self.transformer_blocks:
            h = block(h, context)
        return x.to(h.dtype) + self.proj_out(h).reshape(B, H, W, C)


class Downsample2D(nn.Module):
    """Stride-2 conv. The UNet pads symmetrically by 1; the VAE encoder pads
    (0, 1) on each spatial axis and convolves without padding."""

    def __init__(self, channels: int, asymmetric_padding: bool = False):
        super().__init__()
        self.asymmetric_padding = asymmetric_padding
        self.conv = Conv2d(channels, channels, 3, stride=2,
                           padding=0 if asymmetric_padding else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.asymmetric_padding:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest upsample (2x, or to `out_hw`) + conv. jax.image.resize's
    nearest uses half-pixel centres, which is mode "nearest-exact", not
    "nearest" (they differ when the size does not double, e.g. 23 -> 45)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor, out_hw: Optional[Sequence[int]] = None) -> torch.Tensor:
        B, H, W, C = x.shape
        size = tuple(out_hw) if out_hw is not None else (H * 2, W * 2)
        x = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="nearest-exact")
        return self.conv(x.permute(0, 2, 3, 1))


def set_quant(module: nn.Module, quant) -> None:
    """Set the int8 mode (one of QUANT_MODES) of every site under `module`
    that the JAX package quantizes: the convolutions of resnets (not their
    time_emb_proj) and resamplers, the dense layers of attention blocks,
    transformer projections and feed-forwards, and the attention and
    feed-forward kernels. A model's conv_in, conv_out, time embedding and
    the VAE's quant convs are not under any of these, and stay in float."""
    if quant not in QUANT_MODES:
        raise NotImplementedError(f"quant={quant!r} is not ported; supported: {QUANT_MODES}")
    for m in module.modules():
        if isinstance(m, ResnetBlock2D):
            sites = [m.conv1, m.conv2, m.conv_shortcut]
        elif isinstance(m, (CrossAttention, SelfAttention2D)):
            sites = [m, m.to_q, m.to_k, m.to_v, m.to_out[0]]
        elif isinstance(m, Transformer2D):
            sites = [m.proj_in, m.proj_out]
        elif isinstance(m, FeedForward):
            sites = [m, m.net[0].proj, m.net[2]]
        elif isinstance(m, (Downsample2D, Upsample2D)):
            sites = [m.conv]
        else:
            continue
        for site in sites:
            if site is not None:
                site.quant = quant


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Every layer under `module` computes in `dtype` whatever its
    parameters' dtype (None: in its parameters' dtype again); the fp32
    conv_out sites and the "promote" convs keep theirs. With fp32
    parameters and bf16 this is the JAX package's bf16 compute over fp32
    params (`build_models(dtype=bfloat16)`)."""
    for m in module.modules():
        if isinstance(m, (Linear, Conv2d, GroupNormSiLU, GroupNorm, LayerNorm)):
            m.dtype = dtype


def set_tp_mesh(module: nn.Module, mesh) -> None:
    """Route the kernel sites under `module` through their tensor-parallel
    compositions on `mesh` (None: the unsharded kernels)."""
    for m in module.modules():
        if isinstance(m, (CrossAttention, SelfAttention2D, FeedForward)):
            m.tp_mesh = mesh


def set_kernels(module: nn.Module, use_flash_attention=None, fused_ff=None,
                fused_norm=None) -> None:
    """Route every CrossAttention, FeedForward and GroupNormSiLU under
    `module` (None leaves a setting as it is)."""
    if use_flash_attention is not None and use_flash_attention not in ATTENTION_ROUTES:
        raise NotImplementedError(
            f"use_flash_attention={use_flash_attention!r} is not ported; "
            f"supported: {ATTENTION_ROUTES}")
    for m in module.modules():
        if isinstance(m, CrossAttention) and use_flash_attention is not None:
            m.use_flash = use_flash_attention
        elif isinstance(m, FeedForward) and fused_ff is not None:
            m.fused = bool(fused_ff)
        elif isinstance(m, GroupNormSiLU) and fused_norm is not None:
            m.fused = bool(fused_norm)
