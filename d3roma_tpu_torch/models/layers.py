"""Shared building blocks for the diffusion UNet and the VAE.

Port of `d3roma_tpu/models/layers.py`, taking the JAX package's non-TPU
(XLA) branches as the math. Modules take and return NHWC tensors, the JAX
layout; a convolution sees the NCHW view of an NHWC tensor, which is
channels_last in memory, so no layout copy is made. Parameter names follow
diffusers (`norm1`, `conv1`, `attn1.to_out.0`, `ff.net.0.proj`, ...), so a
diffusers state dict loads as it is.

A module computes in the dtype of its parameters (bf16 after
`half_precision()`); the exceptions mirror the reference: norm statistics
are fp32, and the UNet's and the VAE's `conv_out` run in fp32.

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
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from d3roma_tpu_torch.ops.kernels import (
    conv2d_int8,
    geglu_ff,
    geglu_ff_int8,
    geglu_supported,
    mha_attention,
    mha_attention_int8,
    mha_supported,
)
from d3roma_tpu_torch.ops.quant import (
    QUANT_MODES,
    act_ctx_mode,
    consume_act_scale,
    fp32,
    int8_linear,
    quantize_weight,
)

# use_flash values ported so far: False (plain attention everywhere),
# "pallas" (the whole-row kernel at every site with >= 512 keys) and
# "pallas-self" (the kernel at such self-attention sites only)
ATTENTION_ROUTES = (False, "pallas", "pallas-self")


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
    tensor's _version on every in-place change)."""
    return tuple((p.data_ptr(), p._version, p.dtype, p.device) for p in params
                 if p is not None)


class _Int8Weight:
    """The int8 weight [Cout, ...] and fp32 scales [Cout] of a module's
    weight, made once and kept until the weight changes."""

    def __init__(self):
        self._cache = None

    def get(self, weight: torch.Tensor, layout=None):
        key = _weight_key(weight)
        if self._cache is None or self._cache[0] != key:
            with torch.no_grad():
                w = weight if layout is None else layout(weight)
                wq, ws = quantize_weight(w)
            self._cache = (key, wq.contiguous(), ws.contiguous())
        return self._cache[1], self._cache[2]


class Linear(nn.Linear):
    """nn.Linear that computes in its weight's dtype (Flax Dense casts its
    input to the module dtype the same way). With quant="static" it takes
    one activation tap on that cast input and runs the static int8 dense."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.quant = False
        self._int8 = _Int8Weight()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        if self.quant == "static":
            mode, scale = consume_act_scale(x, "dot")
            if mode == "int8":
                wq, ws = self._int8.get(self.weight)
                return int8_linear(x, wq, ws, scale, self.bias)
        return F.linear(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on NHWC tensors.

    `compute_dtype` None computes in the weight's dtype (a Flax Conv with
    dtype=the model's dtype); a torch dtype fixes it (the fp32 conv_out
    sites); "promote" takes the promoted type of input and weight (a Flax
    Conv without a dtype, as the VAE's quant convs)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 compute_dtype: Union[None, torch.dtype, str] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding)
        self.compute_dtype = compute_dtype
        self.quant = False
        self._int8 = _Int8Weight()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            dt = self.weight.dtype
        elif self.compute_dtype == "promote":
            dt = torch.promote_types(x.dtype, self.weight.dtype)
        else:
            dt = self.compute_dtype
        x = x.to(dt)
        if self.quant == "static":
            mode, scale = consume_act_scale(x, "conv")
            if mode == "int8":
                # [Cout, Cin, KH, KW] -> [Cout, KH, KW, Cin]: K-contiguous rows
                wq, ws = self._int8.get(self.weight, lambda w: w.permute(0, 2, 3, 1))
                return conv2d_int8(x, wq, ws, fp32(scale),
                                   None if self.bias is None else self.bias.to(dt),
                                   self.stride[0], self.padding[0])
        y = self._conv_forward(x.permute(0, 3, 1, 2), self.weight.to(dt),
                               None if self.bias is None else self.bias.to(dt))
        return y.permute(0, 2, 3, 1)


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
    in the compute dtype (not F.group_norm's arithmetic)."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5,
                 apply_silu: bool = True):
        super().__init__()
        self.groups, self.eps, self.apply_silu = groups, eps, apply_silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, g = self.weight.dtype, self.groups
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
        return y.to(self.weight.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with Flax's default epsilon, 1e-6 (PyTorch's is 1e-5);
    statistics are fp32 for bf16 inputs in both."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.to(self.weight.dtype), self.normalized_shape, self.weight,
                            self.bias, self.eps)


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
        # quant, outside calibration captures, at >= 512 tokens
        if (self.quant == "static" and act_ctx_mode() != "capture" and H * W >= 512
                and d >= 64 and mha_supported(H * W, d, itemsize=1)):
            attn = mha_attention_int8(q, k, v)
        else:
            attn = dot_product_attention(q, k, v)
        out = self.to_out[0](attn.reshape(B, H * W, C)).reshape(B, H, W, C)
        return x.to(out.dtype) + out


class CrossAttention(nn.Module):
    """Multi-head attention over [B, N, C] queries with an optional
    [B, M, D] context (self-attention when it is None). `use_flash` is one
    of ATTENTION_ROUTES; the kernel serves sites with >= 512 keys that
    `mha_supported` admits, as in the JAX package."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, use_flash=False):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.use_flash = use_flash
        self.quant = False
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        is_self = context is None
        context = x if is_self else context
        B, N, _ = x.shape
        M = context.shape[1]
        q = self.to_q(x).reshape(B, N, self.heads, self.head_dim)
        k = self.to_k(context).reshape(B, M, self.heads, self.head_dim)
        v = self.to_v(context).reshape(B, M, self.heads, self.head_dim)
        use_kernel = self.use_flash == "pallas" or (self.use_flash == "pallas-self"
                                                    and is_self)
        # the kernels take no tap, so a calibration capture skips them
        if (use_kernel and M >= 512 and mha_supported(M, self.head_dim)
                and act_ctx_mode() != "capture"):
            attn = (mha_attention_int8 if self.quant == "static" else mha_attention)(q, k, v)
        else:
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
    kernel's operands (W1 split into its h and gate halves and transposed,
    W2 transposed, fp32 biases) are prepared once per set of weights and
    kept until a weight changes. The fused path is inference-only: the
    kernel has no backward."""

    def __init__(self, dim: int, fused: bool = False):
        super().__init__()
        self.dim, self.hidden, self.fused = dim, 4 * dim, fused
        self.quant = False
        self.net = nn.ModuleList([GEGLU(dim, self.hidden), nn.Identity(),
                                  Linear(self.hidden, dim)])
        self._kernel_operands = None
        self._int8_operands = None

    def _int8(self):
        """The int8 kernel's operands: W1h, W1g [F, C] and W2 [C, F] int8
        with per-column fp32 scales (the JAX wrapper's absmax_scale over the
        contracted axis), fp32 biases; kept until a weight changes."""
        proj, out = self.net[0].proj, self.net[2]
        key = _weight_key(proj.weight, proj.bias, out.weight, out.bias)
        if self._int8_operands is None or self._int8_operands[0] != key:
            f = self.hidden
            with torch.no_grad():
                (w1hq, s1h), (w1gq, s1g), (w2q, s2) = (
                    quantize_weight(w) for w in (proj.weight[:f], proj.weight[f:], out.weight))
                ops = (w1hq, w1gq, w2q, s1h, s1g, s2, proj.bias[:f].float().contiguous(),
                       proj.bias[f:].float().contiguous(), out.bias.float().contiguous())
            self._int8_operands = (key, ops)
        return self._int8_operands[1]

    def _operands(self):
        proj, out = self.net[0].proj, self.net[2]
        key = _weight_key(proj.weight, proj.bias, out.weight, out.bias)
        if self._kernel_operands is None or self._kernel_operands[0] != key:
            f = self.hidden
            with torch.no_grad():
                w1 = proj.weight.t()  # [C, 2F]
                ops = (w1[:, :f].contiguous(), w1[:, f:].contiguous(),
                       out.weight.t().contiguous(), proj.bias[:f].float().contiguous(),
                       proj.bias[f:].float().contiguous(), out.bias.float().contiguous())
            self._kernel_operands = (key, ops)
        return self._kernel_operands[1]

    def _inline(self, x: torch.Tensor) -> torch.Tensor:
        """The fused branch's math in plain ops on the weights (the JAX
        package's calibration capture runs it inline in XLA, through no
        quantized dense, so it takes no taps of its own)."""
        proj, out = self.net[0].proj, self.net[2]
        h, gate = F.linear(x, proj.weight, proj.bias).chunk(2, dim=-1)
        return F.linear(h * F.gelu(gate, approximate="tanh"), out.weight, out.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and geglu_supported(self.dim, self.hidden):
            dt = self.net[0].proj.weight.dtype
            if self.quant == "static":
                mode, scale = consume_act_scale(x, "geglu")
                if mode == "float":
                    return self._inline(x.to(dt))
                return geglu_ff_int8(x.to(dt), *self._int8(), scale)
            w1h, w1g, w2, b1h, b1g, b2 = self._operands()
            return geglu_ff(x.to(w1h.dtype), w1h, w1g, w2, b1h, b1g, b2)
        return self.net[2](self.net[0](x))


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
    """Set the int8 mode (False or "static") of every site under `module`
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


def set_kernels(module: nn.Module, use_flash_attention=None, fused_ff=None) -> None:
    """Route every CrossAttention and FeedForward under `module` (None
    leaves a setting as it is)."""
    if use_flash_attention is not None and use_flash_attention not in ATTENTION_ROUTES:
        raise NotImplementedError(
            f"use_flash_attention={use_flash_attention!r} is not ported; "
            f"supported: {ATTENTION_ROUTES}")
    for m in module.modules():
        if isinstance(m, CrossAttention) and use_flash_attention is not None:
            m.use_flash = use_flash_attention
        elif isinstance(m, FeedForward) and fused_ff is not None:
            m.fused = bool(fused_ff)
