"""Reference checkpoints (diffusers / transformers torch weights) for the
port's models.

Port of `d3roma_tpu/models/torch_import.py`. The port's UNet2DCondition,
UNet2D, AutoencoderKL and CLIPTextModel already carry the diffusers /
transformers parameter names and layouts, so a checkpoint's state dict
loads with `load_state_dict(strict=True)` once the names the JAX importer
skips are dropped: `unet_state_dict`, `vae_state_dict` and
`clip_text_state_dict` drop exactly those, and a name that is neither
dropped nor a parameter of the model fails the strict load. Older UNets'
1x1-conv `proj_in` / `proj_out` become the linear layers SD2.1 has.
`widen_conv_in` is the reference's conv_in widening for extra condition
channels (reference: train.py:758-769).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping

import torch

from d3roma_tpu_torch.utils.safetensors import load_file

WEIGHT_FILES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
                "diffusion_pytorch_model.bin", "pytorch_model.bin")

# the UNet names the JAX importer maps; every other top-level name (label_emb,
# class_embedding, ...) is unused by the reference and dropped
_UNET_PREFIXES = ("conv_in.", "time_embedding.", "conv_norm_out.", "conv_out.",
                  "mid_block.resnets.", "mid_block.attentions.0.", "down_blocks.", "up_blocks.")
_VAE_PREFIXES = ("conv_in.", "conv_norm_out.", "conv_out.", "mid_block.resnets.",
                 "mid_block.attentions.0.", "down_blocks.", "up_blocks.")
_CLIP_NAMES = re.compile(r"^(embeddings\.(token|position)_embedding\.weight"
                         r"|final_layer_norm\.(weight|bias)|encoder\.layers\.\d+\..*)$")
_PROJ = re.compile(r"(^|\.)attentions\.\d+\.proj_(in|out)\.weight$")


def load_torch_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """The weights of a diffusers / transformers model directory as CPU
    tensors, from the first of WEIGHT_FILES it holds (safetensors mapped
    from disk by `utils/safetensors.py`; .bin through torch.load with
    weights_only)."""
    for name in WEIGHT_FILES:
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            if path.endswith(".safetensors"):
                return load_file(path)
            return torch.load(path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no weight file found in {model_dir}")


def unet_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A diffusers UNet2DConditionModel / UNet2DModel state dict as the
    port's UNet2DCondition / UNet2D load it: the names the reference does
    not use dropped, 1x1-conv proj_in / proj_out weights squeezed to
    linear ones."""
    out = {}
    for key, t in sd.items():
        if not key.startswith(_UNET_PREFIXES):
            continue
        if _PROJ.search(key) and t.ndim == 4:
            t = t[:, :, 0, 0]
        out[key] = t
    return out


def vae_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A diffusers AutoencoderKL state dict as the port's AutoencoderKL
    loads it. A top-level name other than the quant convs, the encoder and
    the decoder raises, as in the JAX importer; inside the encoder and the
    decoder, names it does not map are dropped."""
    out = {}
    for key, t in sd.items():
        if key.startswith(("quant_conv.", "post_quant_conv.")):
            out[key] = t
            continue
        side, rest = key.split(".", 1)
        if side not in ("encoder", "decoder"):
            raise KeyError(f"unexpected VAE parameter {key!r}")
        if rest.startswith(_VAE_PREFIXES):
            out[key] = t
    return out


def clip_text_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A transformers CLIPTextModel state dict as the port's CLIPTextModel
    loads it: `text_model.` stripped, the position_ids buffer and the
    pooler dropped."""
    out = {}
    for key, t in sd.items():
        k = key[len("text_model."):] if key.startswith("text_model.") else key
        if _CLIP_NAMES.match(k):
            out[k] = t
    return out


def widen_conv_in(state_dict: Mapping[str, torch.Tensor], dup: int) -> Dict[str, torch.Tensor]:
    """The reference's conv_in widening on a state dict: the [O, 4, kh, kw]
    kernel tiled `dup` times along its input channels, kernel and bias
    divided by `dup` (reference: train.py:758-769), in their own dtype (the
    JAX importer's jnp.tile(kernel, (1, 1, dup, 1)) / dup on HWIO)."""
    out = dict(state_dict)
    out["conv_in.weight"] = state_dict["conv_in.weight"].repeat(1, dup, 1, 1) / dup
    out["conv_in.bias"] = state_dict["conv_in.bias"] / dup
    return out
