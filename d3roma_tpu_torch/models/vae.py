"""AutoencoderKL (the Stable Diffusion VAE), NHWC.

Port of `d3roma_tpu/models/vae.py`, with its static int8 modes (`quant`:
every resnet conv, resampler conv and mid-attention projection; conv_in,
conv_out and the quant convs stay in float) and the fused GroupNorm + SiLU
of its resnets (`fused_norm`; conv_norm_out and the attention's norm stay
unfused, as in the JAX package). Parameter names follow
diffusers' AutoencoderKL (`encoder.down_blocks.0.resnets.0.conv1.weight`,
`decoder.up_blocks.0.upsamplers.0.conv.weight`, `quant_conv.weight`, ...).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from d3roma_tpu_torch.device import DeviceLike, resolve_device
from d3roma_tpu_torch.models.layers import (
    Conv2d,
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    SelfAttention2D,
    Upsample2D,
    set_kernels,
    set_quant,
)

SD_LATENT_SCALE = 0.18215


class _Block(nn.Module):
    """Container giving diffusers' block names (resnets / downsamplers /
    upsamplers / attentions)."""


def _mid_block(ch: int, groups: int) -> _Block:
    mid = _Block()
    mid.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, groups=groups, eps=1e-6)
                                 for _ in range(2)])
    mid.attentions = nn.ModuleList([SelfAttention2D(ch, head_dim=ch, groups=groups,
                                                    eps=1e-6)])
    return mid


def _run_mid(mid: _Block, x: torch.Tensor) -> torch.Tensor:
    x = mid.resnets[0](x)
    x = mid.attentions[0](x)
    return mid.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 4,
                 block_out_channels: Tuple[int, ...] = (128, 256, 512, 512),
                 layers_per_block: int = 2, norm_groups: int = 32):
        super().__init__()
        boc = tuple(block_out_channels)
        self.conv_in = Conv2d(in_channels, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cin = boc[0]
        for i, ch in enumerate(boc):
            blk = _Block()
            blk.resnets = nn.ModuleList([
                ResnetBlock2D(cin if j == 0 else ch, ch, groups=norm_groups, eps=1e-6)
                for j in range(layers_per_block)])
            if i < len(boc) - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(ch, asymmetric_padding=True)])
            self.down_blocks.append(blk)
            cin = ch
        self.mid_block = _mid_block(boc[-1], norm_groups)
        self.conv_norm_out = GroupNorm(boc[-1], norm_groups, eps=1e-6)
        self.conv_out = Conv2d(boc[-1], 2 * out_channels, 3, padding=1,
                               compute_dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        x = _run_mid(self.mid_block, x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, in_channels: int = 4, out_channels: int = 3,
                 block_out_channels: Tuple[int, ...] = (128, 256, 512, 512),
                 layers_per_block: int = 3, norm_groups: int = 32):
        super().__init__()
        rev = tuple(reversed(block_out_channels))
        self.conv_in = Conv2d(in_channels, rev[0], 3, padding=1)
        self.mid_block = _mid_block(rev[0], norm_groups)
        self.up_blocks = nn.ModuleList()
        cin = rev[0]
        for i, ch in enumerate(rev):
            blk = _Block()
            blk.resnets = nn.ModuleList([
                ResnetBlock2D(cin if j == 0 else ch, ch, groups=norm_groups, eps=1e-6)
                for j in range(layers_per_block)])
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)
            cin = ch
        self.conv_norm_out = GroupNorm(rev[-1], norm_groups, eps=1e-6)
        self.conv_out = Conv2d(rev[-1], out_channels, 3, padding=1,
                               compute_dtype=torch.float32)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class GaussianPosterior(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKL(nn.Module):
    """Built on `device` (CUDA unless the caller names another), in fp32;
    `half_precision()` of the pipeline casts it to bf16."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 latent_channels: int = 4,
                 block_out_channels: Tuple[int, ...] = (128, 256, 512, 512),
                 norm_groups: int = 32, fused_norm: bool = False,
                 device: DeviceLike = None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.latent_channels = latent_channels
        self.block_out_channels = tuple(block_out_channels)
        self.norm_groups = norm_groups
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(in_channels, latent_channels, block_out_channels,
                                   norm_groups=norm_groups)
            self.decoder = Decoder(latent_channels, out_channels, block_out_channels,
                                   norm_groups=norm_groups)
            # the 1x1 convs around the latent compute in the promoted type of
            # their input and weights, as Flax convs without a dtype do
            self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1,
                                     compute_dtype="promote")
            self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1,
                                          compute_dtype="promote")
        self.quant = False
        self.tp_mesh = None
        self.set_kernels(fused_norm)

    def set_quant(self, quant) -> None:
        """Set the int8 mode (one of ops/quant.py's QUANT_MODES) of
        every site the JAX package quantizes."""
        set_quant(self, quant)
        self.quant = quant

    def set_kernels(self, fused_norm=None) -> None:
        """Route the resnets' GroupNorm + SiLU to the fused kernel or not;
        None keeps the setting."""
        set_kernels(self, fused_norm=fused_norm)
        if fused_norm is not None:
            self.fused_norm = bool(fused_norm)

    def encode(self, x: torch.Tensor) -> GaussianPosterior:
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return GaussianPosterior(mean, logvar)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))


def encode_image_to_latent(vae: AutoencoderKL, x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] image [B, H, W, 3] -> scaled latent [B, H/8, W/8, 4] (the
    posterior's mode, as at inference in the reference; sampling the
    posterior for training is not ported yet)."""
    return vae.encode(x).mode() * SD_LATENT_SCALE


def encode_disp_to_latent(vae: AutoencoderKL, disp: torch.Tensor) -> torch.Tensor:
    """Disparity [B, H, W, 1], tiled to 3 channels, then encoded."""
    return encode_image_to_latent(vae, disp.repeat(1, 1, 1, 3))


def decode_latent(vae: AutoencoderKL, z: torch.Tensor,
                  mean_channels: bool = True) -> torch.Tensor:
    """Scaled latent -> image; disparity decoding averages the 3 channels."""
    img = vae.decode(z / SD_LATENT_SCALE)
    return img.mean(dim=-1, keepdim=True) if mean_channels else img
