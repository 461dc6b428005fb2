"""Weights for the port's models: the bridge from the JAX package's Flax
parameter trees, and seeded random weights.

`flax_unet_to_torch` / `flax_vae_to_torch` take a Flax param tree as nested
dicts of numpy arrays and return a state dict with diffusers names, which
`load_state_dict(strict=True)` of the port's `UNet2DCondition` /
`AutoencoderKL` accepts. The name map is the inverse of
`d3roma_tpu/models/torch_import.py::unet_torch_to_flax` /
`vae_torch_to_flax`; this module keeps its own copy of it. The transforms:
conv kernels HWIO -> OIHW, dense kernels [I, O] -> [O, I], norm `scale` ->
`weight`.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# Flax module name -> diffusers name, one path component at a time
_COMPONENT_RULES = (
    (re.compile(r"^mid_res_(\d+)$"), r"mid_block.resnets.\1"),
    (re.compile(r"^mid_attn$"), "mid_block.attentions.0"),
    (re.compile(r"^(down|up)_(\d+)_res_(\d+)$"), r"\1_blocks.\2.resnets.\3"),
    (re.compile(r"^(down|up)_(\d+)_attn_(\d+)$"), r"\1_blocks.\2.attentions.\3"),
    (re.compile(r"^down_(\d+)_downsample$"), r"down_blocks.\1.downsamplers.0"),
    (re.compile(r"^up_(\d+)_upsample$"), r"up_blocks.\1.upsamplers.0"),
    (re.compile(r"^transformer_blocks_(\d+)$"), r"transformer_blocks.\1"),
    (re.compile(r"^net_(\d+)$"), r"net.\1"),
    (re.compile(r"^to_out$"), "to_out.0"),
)


def _torch_component(name: str) -> str:
    for pattern, repl in _COMPONENT_RULES:
        if pattern.match(name):
            return pattern.sub(repl, name)
    return name


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _torch_leaf(leaf: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf == "kernel":
        if arr.ndim == 4:  # conv HWIO -> OIHW
            return "weight", np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:  # dense [I, O] -> [O, I]
            return "weight", arr.T
        raise ValueError(f"kernel of rank {arr.ndim}")
    if leaf == "scale":  # norms
        return "weight", arr
    if leaf == "bias":
        return "bias", arr
    raise KeyError(f"unknown Flax leaf {leaf!r}")


def _flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(params):
        leaf, value = _torch_leaf(path[-1], arr)
        name = ".".join([_torch_component(p) for p in path[:-1]] + [leaf])
        out[name] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def flax_unet_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax UNet2DCondition params -> the port's UNet2DCondition state dict."""
    return _flax_to_torch(params)


def flax_vae_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax AutoencoderKL params -> the port's AutoencoderKL state dict."""
    return _flax_to_torch(params)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill `module`'s parameters in place from `generator` (on the
    parameters' device): weights of rank >= 2 from N(0, 1/fan_in) (Flax's
    lecun-normal scale), norm weights 1, biases 0."""
    for name, p in module.named_parameters():
        if p.ndim >= 2:
            fan_in = p[0].numel()
            w = torch.randn(p.shape, generator=generator, device=generator.device)
            p.copy_(w * fan_in ** -0.5)
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    return module
