"""Weights for the port's models: the bridge to and from the JAX package's
Flax parameter trees, and seeded random weights.

`flax_unet_to_torch` / `flax_unet2d_to_torch` / `flax_vae_to_torch` take a
Flax param tree as nested dicts of arrays (numpy, or torch tensors as
`utils/flax_msgpack.py` reads them; numpy's bfloat16 extension type too)
and return a state dict with diffusers names, which
`load_state_dict(strict=True)` of the port's `UNet2DCondition` / `UNet2D` /
`AutoencoderKL` accepts. `torch_to_flax` is the inverse, for all three: a
Flax tree of CPU torch tensors in the state dict's dtypes (numpy has no
bfloat16), which `flax_msgpack.dump` writes as the JAX package reads it.
The name map is the inverse of
`d3roma_tpu/models/torch_import.py::unet_torch_to_flax` /
`vae_torch_to_flax`; this module keeps its own copy of it. The transforms:
conv kernels HWIO <-> OIHW, dense kernels [I, O] <-> [O, I], norm `scale`
<-> `weight`.
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


# diffusers name -> Flax module names, on the dotted name (the inverse of
# _COMPONENT_RULES; each match ends before a further component)
_INVERSE_RULES = (
    (re.compile(r"(^|\.)mid_block\.resnets\.(\d+)(?=\.)"), r"\1mid_res_\2"),
    (re.compile(r"(^|\.)mid_block\.attentions\.0(?=\.)"), r"\1mid_attn"),
    (re.compile(r"(^|\.)(down|up)_blocks\.(\d+)\.resnets\.(\d+)(?=\.)"), r"\1\2_\3_res_\4"),
    (re.compile(r"(^|\.)(down|up)_blocks\.(\d+)\.attentions\.(\d+)(?=\.)"),
     r"\1\2_\3_attn_\4"),
    (re.compile(r"(^|\.)down_blocks\.(\d+)\.downsamplers\.0(?=\.)"), r"\1down_\2_downsample"),
    (re.compile(r"(^|\.)up_blocks\.(\d+)\.upsamplers\.0(?=\.)"), r"\1up_\2_upsample"),
    (re.compile(r"(^|\.)transformer_blocks\.(\d+)(?=\.)"), r"\1transformer_blocks_\2"),
    (re.compile(r"(^|\.)net\.(\d+)(?=\.)"), r"\1net_\2"),
    (re.compile(r"(^|\.)to_out\.0(?=\.)"), r"\1to_out"),
)


def _torch_component(name: str) -> str:
    for pattern, repl in _COMPONENT_RULES:
        if pattern.match(name):
            return pattern.sub(repl, name)
    return name


def _as_tensor(value) -> torch.Tensor:
    """A CPU tensor of a leaf's values and dtype (numpy's bfloat16
    extension type through a uint16 view)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...],
                                                                            torch.Tensor]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), _as_tensor(value)


def _torch_leaf(leaf: str, t: torch.Tensor) -> Tuple[str, torch.Tensor]:
    if leaf == "kernel":
        if t.ndim == 4:  # conv HWIO -> OIHW
            return "weight", t.permute(3, 2, 0, 1)
        if t.ndim == 2:  # dense [I, O] -> [O, I]
            return "weight", t.t()
        raise ValueError(f"kernel of rank {t.ndim}")
    if leaf == "scale":  # norms
        return "weight", t
    if leaf == "bias":
        return "bias", t
    raise KeyError(f"unknown Flax leaf {leaf!r}")


def _flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, t in _leaves(params):
        leaf, value = _torch_leaf(path[-1], t)
        name = ".".join([_torch_component(p) for p in path[:-1]] + [leaf])
        out[name] = value.contiguous()
    return out


def flax_unet_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax UNet2DCondition params -> the port's UNet2DCondition state dict."""
    return _flax_to_torch(params)


def flax_unet2d_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax UNet2D (pixel) params -> the port's UNet2D state dict."""
    return _flax_to_torch(params)


def flax_vae_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax AutoencoderKL params -> the port's AutoencoderKL state dict."""
    return _flax_to_torch(params)


def torch_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """A state dict of any of the port's models -> the JAX package's Flax
    param tree (nested dicts of contiguous CPU tensors, dtypes kept)."""
    tree: Dict = {}
    for name, t in state_dict.items():
        for pattern, repl in _INVERSE_RULES:
            name = pattern.sub(repl, name)
        *modules, leaf = name.split(".")
        t = t.detach().cpu()
        if leaf == "weight":
            if t.ndim == 4:  # conv OIHW -> HWIO
                leaf, t = "kernel", t.permute(2, 3, 1, 0)
            elif t.ndim == 2:  # dense [O, I] -> [I, O]
                leaf, t = "kernel", t.t()
            elif t.ndim == 1:  # norms
                leaf = "scale"
            else:
                raise ValueError(f"{name}: weight of rank {t.ndim}")
        elif leaf != "bias":
            raise KeyError(f"unknown parameter {name!r}")
        node = tree
        for m in modules:
            node = node.setdefault(m, {})
        node[leaf] = t.contiguous()
    return tree


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
