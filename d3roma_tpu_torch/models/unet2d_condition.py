"""Latent-space cross-attention UNet (diffusers UNet2DConditionModel / SD2.1
geometry), NHWC.

Port of `d3roma_tpu/models/unet2d_condition.py`, full pass only: DeepCache
(`cache_depth` other than 1, `return_trunk`, `cached_trunk`) is not ported
yet and raises; the int8 and fused-GroupNorm options are not offered yet.
Parameter names
follow diffusers (`down_blocks.0.attentions.0.transformer_blocks.0...`).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from d3roma_tpu_torch.device import DeviceLike, resolve_device
from d3roma_tpu_torch.models.layers import (
    Conv2d,
    Downsample2D,
    GroupNormSiLU,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    set_kernels,
    timestep_embedding,
)


class _Block(nn.Module):
    """Container giving diffusers' block names (resnets / attentions /
    downsamplers / upsamplers)."""


class UNet2DCondition(nn.Module):
    """Built on `device` (CUDA unless the caller names another), in fp32.
    `use_flash_attention` and `fused_ff` route the attention and feed-forward
    sites to the kernels; `set_kernels` changes them after construction."""

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
        cache_depth: int = 1,
        flip_sin_to_cos: bool = True,
        freq_shift: float = 0.0,
        device: DeviceLike = None,
    ):
        super().__init__()
        if cache_depth != 1:
            raise NotImplementedError("DeepCache (cache_depth) is not ported yet")
        self.in_channels = in_channels
        self.block_out_channels = tuple(block_out_channels)
        self.cross_attention_dim = cross_attention_dim
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
        self.set_kernels(use_flash_attention, fused_ff)

    def set_kernels(self, use_flash_attention=None, fused_ff=None) -> None:
        """Route the attention (False / "pallas" / "pallas-self") and the
        feed-forward (fused or not) sites; None keeps a setting."""
        set_kernels(self, use_flash_attention, fused_ff)
        if use_flash_attention is not None:
            self.use_flash_attention = use_flash_attention
        if fused_ff is not None:
            self.fused_ff = bool(fused_ff)

    def forward(self, sample: torch.Tensor, timesteps, encoder_hidden_states: torch.Tensor,
                cached_trunk=None, return_trunk: bool = False) -> torch.Tensor:
        """sample [B, h, w, in_channels] (latents + condition latents),
        timesteps an int or [B] / 0-d tensor, encoder_hidden_states
        [B, T, cross_attention_dim] -> fp32 [B, h, w, out_channels]."""
        if cached_trunk is not None or return_trunk:
            raise NotImplementedError("DeepCache (cached_trunk / return_trunk) is not "
                                      "ported yet")
        dtype = self.conv_in.weight.dtype
        B = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(B)
        context = encoder_hidden_states.to(dtype)
        t_emb = timestep_embedding(timesteps, self.block_out_channels[0],
                                   self.flip_sin_to_cos, self.freq_shift).to(dtype)
        t_emb = self.time_embedding(t_emb)

        x = self.conv_in(sample)
        skips = [x]
        for blk in self.down_blocks:
            attns = getattr(blk, "attentions", None)
            for j, res in enumerate(blk.resnets):
                x = res(x, t_emb)
                if attns is not None:
                    x = attns[j](x, context)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        x = self.mid_block.resnets[0](x, t_emb)
        x = self.mid_block.attentions[0](x, context)
        x = self.mid_block.resnets[1](x, t_emb)

        for blk in self.up_blocks:
            attns = getattr(blk, "attentions", None)
            for j, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=-1), t_emb)
                if attns is not None:
                    x = attns[j](x, context)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x, out_hw=skips[-1].shape[1:3])

        return self.conv_out(self.conv_norm_out(x))


def widened_in_channels(cond_channels: str, latent_channels: int = 4) -> int:
    """4 * (1 + number of conditions)."""
    return (len(cond_channels.split("+")) + 1) * latent_channels
