"""Latent-space cross-attention UNet (diffusers UNet2DConditionModel / SD2.1
geometry), NHWC.

Port of `d3roma_tpu/models/unet2d_condition.py`: the full pass, the
DeepCache passes (`cache_depth`, `return_trunk`, `cached_trunk`), the
static int8 modes (`quant`), the fused GroupNorm + SiLU (`fused_norm`: the
resnets' norms and conv_norm_out) and `remat` (activation checkpointing of
every resnet and transformer block while autograd records, for training).
Parameter names follow diffusers
(`down_blocks.0.attentions.0.transformer_blocks.0...`).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from d3roma_tpu_torch.device import DeviceLike, resolve_device
from d3roma_tpu_torch.models.layers import (
    Conv2d,
    Downsample2D,
    GroupNormSiLU,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    module_dtype,
    set_kernels,
    set_quant,
    timestep_embedding,
)


class _Block(nn.Module):
    """Container giving diffusers' block names (resnets / attentions /
    downsamplers / upsamplers)."""


class UNet2DCondition(nn.Module):
    """Built on `device` (CUDA unless the caller names another), in fp32.
    `use_flash_attention`, `fused_ff` and `fused_norm` route the attention,
    feed-forward and GroupNorm + SiLU sites to the kernels; `set_kernels`
    changes them after construction, and `set_quant` sets the int8 mode
    (one of ops/quant.py's QUANT_MODES; False, the default, is float).

    `cache_depth` is the DeepCache shallow pass's depth: how many trailing
    up blocks (and the matching leading down blocks) the cached pass
    refreshes, from 1 to len(up_block_types) - 1; the trunk is the feature
    entering the first refreshed up block."""

    def __init__(
        self,
        in_channels: int = 4,
        out_channels: int = 4,
        block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280),
        down_block_types: Tuple[str, ...] = (
            "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types: Tuple[str, ...] = (
            "UpBlock2D", "CrossAttnUpBlock2D",
            "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
        layers_per_block: int = 2,
        attention_head_dim: int = 64,
        cross_attention_dim: int = 1024,
        norm_groups: int = 32,
        use_flash_attention: Union[bool, str] = False,
        fused_ff: bool = False,
        fused_norm: bool = False,
        cache_depth: int = 1,
        remat: bool = False,
        flip_sin_to_cos: bool = True,
        freq_shift: float = 0.0,
        device: DeviceLike = None,
    ):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.block_out_channels = tuple(block_out_channels)
        self.down_block_types, self.up_block_types = tuple(down_block_types), tuple(up_block_types)
        self.layers_per_block = layers_per_block
        self.attention_head_dim = attention_head_dim
        self.cross_attention_dim = cross_attention_dim
        self.norm_groups = norm_groups
        self.flip_sin_to_cos, self.freq_shift = flip_sin_to_cos, freq_shift
        boc = self.block_out_channels
        c0 = boc[0]
        temb = c0 * 4
        kw = dict(groups=norm_groups, use_flash=use_flash_attention, fused_ff=fused_ff)

        def attn(ch):
            heads = max(1, ch // attention_head_dim)
            return Transformer2D(ch, heads, attention_head_dim, cross_attention_dim, **kw)

        with torch.device(resolve_device(device)):
            self.conv_in = Conv2d(in_channels, c0, 3, padding=1)
            self.time_embedding = TimestepEmbedding(c0, temb)

            self.down_blocks = nn.ModuleList()
            skip_channels = [c0]
            cin = c0
            for i, (btype, ch) in enumerate(zip(down_block_types, boc)):
                blk = _Block()
                blk.resnets = nn.ModuleList([
                    ResnetBlock2D(cin if j == 0 else ch, ch, temb, norm_groups)
                    for j in range(layers_per_block)])
                if btype == "CrossAttnDownBlock2D":
                    blk.attentions = nn.ModuleList([attn(ch) for _ in range(layers_per_block)])
                skip_channels += [ch] * layers_per_block
                if i < len(boc) - 1:
                    blk.downsamplers = nn.ModuleList([Downsample2D(ch)])
                    skip_channels.append(ch)
                self.down_blocks.append(blk)
                cin = ch

            mid = boc[-1]
            self.mid_block = _Block()
            self.mid_block.resnets = nn.ModuleList([
                ResnetBlock2D(mid, mid, temb, norm_groups) for _ in range(2)])
            self.mid_block.attentions = nn.ModuleList([attn(mid)])

            self.up_blocks = nn.ModuleList()
            rev = tuple(reversed(boc))
            for i, btype in enumerate(up_block_types):
                ch = rev[i]
                blk = _Block()
                resnets = []
                for _ in range(layers_per_block + 1):
                    resnets.append(ResnetBlock2D(cin + skip_channels.pop(), ch, temb,
                                                 norm_groups))
                    cin = ch
                blk.resnets = nn.ModuleList(resnets)
                if btype == "CrossAttnUpBlock2D":
                    blk.attentions = nn.ModuleList([attn(ch)
                                                    for _ in range(layers_per_block + 1)])
                if i < len(up_block_types) - 1:
                    blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
                self.up_blocks.append(blk)

            self.conv_norm_out = GroupNormSiLU(c0, norm_groups, 1e-5)
            self.conv_out = Conv2d(c0, out_channels, 3, padding=1,
                                   compute_dtype=torch.float32)
        self.set_kernels(use_flash_attention, fused_ff, fused_norm)
        self.quant = False
        self.tp_mesh = None
        self.cache_depth = cache_depth
        self.remat = bool(remat)

    @property
    def cache_depth(self) -> int:
        return self._cache_depth

    @cache_depth.setter
    def cache_depth(self, depth: int) -> None:
        n_up = len(self.up_blocks)
        if not 1 <= int(depth) <= n_up - 1:
            raise ValueError(f"cache_depth must be in [1, {n_up - 1}] (the mid block is "
                             f"always part of the cached trunk), got {depth}")
        self._cache_depth = int(depth)

    def set_quant(self, quant) -> None:
        """Set the int8 mode (one of ops/quant.py's QUANT_MODES) of
        every site the JAX package quantizes; conv_in, the time embedding and the fp32
        conv_out stay in float."""
        set_quant(self, quant)
        self.quant = quant

    def set_kernels(self, use_flash_attention=None, fused_ff=None, fused_norm=None) -> None:
        """Route the attention (one of layers.ATTENTION_ROUTES), the
        feed-forward and the GroupNorm + SiLU (fused or not) sites; None
        keeps a setting."""
        set_kernels(self, use_flash_attention, fused_ff, fused_norm)
        if use_flash_attention is not None:
            self.use_flash_attention = use_flash_attention
        if fused_ff is not None:
            self.fused_ff = bool(fused_ff)
        if fused_norm is not None:
            self.fused_norm = bool(fused_norm)

    def _run(self, block: nn.Module, *args) -> torch.Tensor:
        """A resnet or transformer block; under `remat` and autograd its
        activations are recomputed in the backward pass instead of kept
        (the JAX package's nn.remat of the same two block kinds)."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def _up_block(self, blk, x, skips, t_emb, context, upsample: bool):
        attns = getattr(blk, "attentions", None)
        for j, res in enumerate(blk.resnets):
            x = self._run(res, torch.cat([x, skips.pop()], dim=-1), t_emb)
            if attns is not None:
                x = self._run(attns[j], x, context)
        if upsample:
            x = blk.upsamplers[0](x, out_hw=skips[-1].shape[1:3])
        return x

    def forward(self, sample: torch.Tensor, timesteps, encoder_hidden_states: torch.Tensor,
                cached_trunk=None, return_trunk: bool = False):
        """sample [B, h, w, in_channels] (latents + condition latents),
        timesteps an int or [B] / 0-d tensor, encoder_hidden_states
        [B, T, cross_attention_dim] -> fp32 [B, h, w, out_channels].

        DeepCache: `return_trunk=True` also returns the trunk, (out, trunk);
        `cached_trunk` runs only the shallow pass (conv_in, down blocks
        [0, cache_depth), the last cache_depth up blocks, conv_out) with the
        given trunk in place of the deep levels. Exact when the trunk comes
        from a full pass over the same input; an approximation when reused
        across steps."""
        dtype = module_dtype(self.conv_in)
        B = sample.shape[0]
        if isinstance(timesteps, int):  # filled on the device: no host-to-device copy
            timesteps = torch.full((B,), timesteps, device=sample.device)
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(B)
        context = encoder_hidden_states.to(dtype)
        t_emb = timestep_embedding(timesteps, self.block_out_channels[0],
                                   self.flip_sin_to_cos, self.freq_shift).to(dtype)
        t_emb = self.time_embedding(t_emb)

        n_up = len(self.up_blocks)
        depth = self.cache_depth
        # up block i consumes the skips of down block n_up - 1 - i, so the
        # shallow pass runs down blocks [0, depth) and up blocks [n_up - depth, n_up)
        refresh_from = n_up - depth

        x = self.conv_in(sample)
        skips = [x]
        for i, blk in enumerate(self.down_blocks):
            attns = getattr(blk, "attentions", None)
            for j, res in enumerate(blk.resnets):
                x = self._run(res, x, t_emb)
                if attns is not None:
                    x = self._run(attns[j], x, context)
                skips.append(x)
            if cached_trunk is not None and i == depth - 1:
                break
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        if cached_trunk is None:
            x = self._run(self.mid_block.resnets[0], x, t_emb)
            x = self._run(self.mid_block.attentions[0], x, context)
            x = self._run(self.mid_block.resnets[1], x, t_emb)
            for blk in self.up_blocks[:refresh_from]:
                x = self._up_block(blk, x, skips, t_emb, context, upsample=True)
            trunk = x
        else:
            trunk = x = cached_trunk.to(dtype)

        for i in range(refresh_from, n_up):
            x = self._up_block(self.up_blocks[i], x, skips, t_emb, context,
                               upsample=i < n_up - 1)

        out = self.conv_out(self.conv_norm_out(x))
        return (out, trunk) if return_trunk else out


def widened_in_channels(cond_channels: str, latent_channels: int = 4) -> int:
    """4 * (1 + number of conditions)."""
    return (len(cond_channels.split("+")) + 1) * latent_channels
