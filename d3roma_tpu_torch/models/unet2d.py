"""Pixel-space conditional UNet (diffusers UNet2DModel layout), NHWC.

Port of `d3roma_tpu/models/unet2d.py`: configurable block widths,
(Attn)DownBlock2D / (Attn)UpBlock2D levels, a mid block with one spatial
self-attention, channel-concat conditioning at the input. Parameter names
follow diffusers (`down_blocks.4.attentions.0.to_q.weight`,
`up_blocks.0.upsamplers.0.conv.weight`, ...), so `set_quant` and
`set_kernels` reach its resnets, attentions and resamplers as they reach the
latent UNet's: under `quant` every resnet conv, resampler conv and
attention projection takes the int8 path, and `fused_norm` sends the
resnets' norms and conv_norm_out to the fused GroupNorm + SiLU where its
gate admits the shape. conv_in, the time embedding and the fp32 conv_out
are never quantized.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from d3roma_tpu_torch.device import DeviceLike, resolve_device
from d3roma_tpu_torch.models.layers import (
    Conv2d,
    Downsample2D,
    GroupNormSiLU,
    ResnetBlock2D,
    SelfAttention2D,
    TimestepEmbedding,
    Upsample2D,
    module_dtype,
    set_kernels,
    set_quant,
    timestep_embedding,
)


class _Block(nn.Module):
    """Container giving diffusers' block names (resnets / attentions /
    downsamplers / upsamplers)."""


class UNet2D(nn.Module):
    """Built on `device` (CUDA unless the caller names another), in fp32.
    in_channels = depth channels + condition channels (`pixel_in_channels`),
    out_channels = depth channels."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        block_out_channels: Tuple[int, ...] = (128, 128, 256, 256, 512, 512),
        down_block_types: Tuple[str, ...] = (
            "DownBlock2D", "DownBlock2D", "DownBlock2D",
            "DownBlock2D", "AttnDownBlock2D", "DownBlock2D"),
        up_block_types: Tuple[str, ...] = (
            "UpBlock2D", "AttnUpBlock2D", "UpBlock2D",
            "UpBlock2D", "UpBlock2D", "UpBlock2D"),
        layers_per_block: int = 2,
        attention_head_dim: int = 8,
        norm_groups: int = 32,
        fused_norm: bool = False,
        flip_sin_to_cos: bool = True,
        freq_shift: float = 0.0,
        device: DeviceLike = None,
    ):
        super().__init__()
        if len(down_block_types) != len(block_out_channels):
            raise ValueError("one down block type per entry of block_out_channels")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.block_out_channels = tuple(block_out_channels)
        self.down_block_types, self.up_block_types = tuple(down_block_types), tuple(up_block_types)
        self.layers_per_block = layers_per_block
        self.attention_head_dim, self.norm_groups = attention_head_dim, norm_groups
        self.flip_sin_to_cos, self.freq_shift = flip_sin_to_cos, freq_shift
        boc = self.block_out_channels
        c0 = boc[0]
        temb = c0 * 4

        def attn(ch):
            return SelfAttention2D(ch, attention_head_dim, norm_groups)

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
                if btype == "AttnDownBlock2D":
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
                if btype == "AttnUpBlock2D":
                    blk.attentions = nn.ModuleList([attn(ch)
                                                    for _ in range(layers_per_block + 1)])
                if i < len(up_block_types) - 1:
                    blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
                self.up_blocks.append(blk)

            self.conv_norm_out = GroupNormSiLU(c0, norm_groups, 1e-5)
            self.conv_out = Conv2d(c0, out_channels, 3, padding=1,
                                   compute_dtype=torch.float32)
        self.quant = False
        self.set_kernels(fused_norm)

    def set_quant(self, quant) -> None:
        """Set the int8 mode (one of ops/quant.py's QUANT_MODES) of every
        site the JAX package quantizes; conv_in, the time embedding and the
        fp32 conv_out stay in float."""
        set_quant(self, quant)
        self.quant = quant

    def set_kernels(self, fused_norm=None) -> None:
        """Route the GroupNorm + SiLU sites to the fused kernel (or not);
        None keeps the setting."""
        set_kernels(self, fused_norm=fused_norm)
        if fused_norm is not None:
            self.fused_norm = bool(fused_norm)

    def forward(self, sample: torch.Tensor, timesteps) -> torch.Tensor:
        """sample [B, H, W, in_channels] (noisy depth + conditions),
        timesteps an int or [B] / 0-d tensor -> fp32 [B, H, W,
        out_channels]. Each upsample resizes to its skip's size, so odd
        sizes (23 rows -> 12 -> 23) come back exactly."""
        dtype = module_dtype(self.conv_in)
        B = sample.shape[0]
        if isinstance(timesteps, int):  # filled on the device: no host-to-device copy
            timesteps = torch.full((B,), timesteps, device=sample.device)
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(B)
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
                    x = attns[j](x)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        x = self.mid_block.resnets[0](x, t_emb)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x, t_emb)

        for blk in self.up_blocks:
            attns = getattr(blk, "attentions", None)
            for j, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=-1), t_emb)
                if attns is not None:
                    x = attns[j](x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x, out_hw=skips[-1].shape[1:3])

        return self.conv_out(self.conv_norm_out(x))


def pixel_in_channels(cond_channels: str, depth_channels: int) -> int:
    """The UNet's input channels for a condition combination."""
    table = {
        "left+right+raw": 6 + 2 * depth_channels,
        "rgb+raw": 3 + 2 * depth_channels,
        "rgb+left+right": 9 + depth_channels,
        "rgb+left+right+raw": 9 + 2 * depth_channels,
        "rgb": 3 + depth_channels,
        "left+right": 6 + depth_channels,
    }
    if cond_channels not in table:
        raise ValueError(f"{cond_channels} not supported")
    return table[cond_channels]
