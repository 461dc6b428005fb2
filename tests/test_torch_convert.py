"""The weight bridge: Flax param trees of the JAX package -> the port's state
dicts (strict load), and back through the JAX package's own importer
(d3roma_tpu.models.torch_import) to the original tree, leaf for leaf; and
back through the port's own inverse (`torch_to_flax`, which writes the JAX
package's directories) for all three models, bf16 included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2D as JaxUNet2D
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.models.torch_import import unet_torch_to_flax, vae_torch_to_flax
from d3roma_tpu_torch.models import (
    AutoencoderKL,
    UNet2D,
    UNet2DCondition,
    flax_unet2d_to_torch,
    flax_unet_to_torch,
    flax_vae_to_torch,
    torch_to_flax,
)
from torch_port_utils import IMAGE_HW, TINY_UNET, TINY_UNET2D, TINY_VAE, random_flax_tree


def _random_like(tree, rs):
    """The same tree with every leaf redrawn from numpy (Flax init leaves
    biases at 0 and norm scales at 1, which would hide a swapped pair)."""
    return jax.tree_util.tree_map(
        lambda a: rs.standard_normal(np.shape(a)).astype(np.float32), tree)


def _assert_same_tree(a, b, path=()):
    assert set(a) == set(b), f"{path}: {sorted(set(a) ^ set(b))}"
    for key in a:
        if isinstance(a[key], dict):
            _assert_same_tree(a[key], b[key], path + (key,))
        else:
            np.testing.assert_array_equal(np.asarray(b[key]), a[key], err_msg=str(path + (key,)))


@pytest.mark.parametrize("model", ["unet", "vae"])
def test_flax_tree_loads_strict_and_round_trips(model):
    if model == "unet":
        module = JaxUNet(**TINY_UNET)
        args = (jnp.zeros((1, 4, 8, TINY_UNET["in_channels"])), jnp.array([0]),
                jnp.zeros((1, 2, TINY_UNET["cross_attention_dim"])))
        to_torch, to_flax = flax_unet_to_torch, unet_torch_to_flax
        port = UNet2DCondition(**TINY_UNET, device="cpu")
    else:
        module = JaxVAE(**TINY_VAE)
        args = (jnp.zeros((1,) + IMAGE_HW + (3,)),)
        to_torch, to_flax = flax_vae_to_torch, vae_torch_to_flax
        port = AutoencoderKL(**TINY_VAE, device="cpu")
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    params = _random_like(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes),
                          np.random.RandomState(0))

    sd = to_torch(params)
    result = port.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    for name, tensor in port.state_dict().items():
        np.testing.assert_array_equal(tensor.numpy(), sd[name].numpy())

    back = to_flax({k: v.numpy() for k, v in sd.items()})
    _assert_same_tree(params, back)


@pytest.mark.parametrize("model", ["unet", "unet2d", "vae"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_to_flax_inverts_the_bridge(model, dtype):
    """Flax tree -> state dict (strict load) -> torch_to_flax: the same tree,
    leaf for leaf, in the same dtype (bf16 leaves read through numpy's
    bfloat16 extension type)."""
    if model == "unet":
        module, port_cls, kw, to_torch = JaxUNet, UNet2DCondition, TINY_UNET, flax_unet_to_torch
        args = (jnp.zeros((1, 4, 8, TINY_UNET["in_channels"])), jnp.array([0]),
                jnp.zeros((1, 2, TINY_UNET["cross_attention_dim"])))
    elif model == "unet2d":
        module, port_cls, kw, to_torch = JaxUNet2D, UNet2D, TINY_UNET2D, flax_unet2d_to_torch
        args = (jnp.zeros((1, 16, 16, TINY_UNET2D["in_channels"])), jnp.array([0]))
    else:
        module, port_cls, kw, to_torch = JaxVAE, AutoencoderKL, TINY_VAE, flax_vae_to_torch
        args = (jnp.zeros((1,) + IMAGE_HW + (3,)),)
    params = random_flax_tree(module(**kw), 1, *args)
    params = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, dtype)), params)
    sd = to_torch(params)
    port = port_cls(**kw, device="cpu").to(getattr(torch, dtype))
    result = port.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    back = torch_to_flax(port.state_dict())

    def same(a, b, path=()):
        assert set(a) == set(b), f"{path}: {sorted(set(a) ^ set(b))}"
        for key in a:
            if isinstance(a[key], dict):
                same(a[key], b[key], path + (key,))
            else:
                got = b[key]
                assert str(got.dtype) == f"torch.{dtype}" and got.is_contiguous()
                np.testing.assert_array_equal(got.float().numpy(), a[key].astype(np.float32),
                                              err_msg=str(path + (key,)))

    same(params, back)
