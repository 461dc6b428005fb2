"""Each layer of the port against its Flax counterpart in d3roma_tpu, with the
Flax parameters (numpy-seeded) converted by the port's weight bridge and
loaded with strict=True. fp32 unless a test says bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from d3roma_tpu.models import layers as jl
from d3roma_tpu_torch.models import layers as tl
from d3roma_tpu_torch.models.convert import flax_unet_to_torch
from d3roma_tpu_torch.ops.kernels import geglu_ff, mha_attention
from torch_port_utils import randn, to_numpy

# fp32: the same math with sums (convolutions, matmuls, norm statistics)
# taken in another order
TOL = 1e-4
# bf16: one or two bf16 roundings (2^-8 relative) of O(1) values
TOL_BF16 = 3e-2


def _randomize_tree(tree, rs):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _randomize_tree(val, rs)
            continue
        shape = val.shape
        if key == "kernel":
            arr = rs.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif key == "scale":
            arr = 1.0 + 0.1 * rs.standard_normal(shape)
        else:
            arr = 0.1 * rs.standard_normal(shape)
        out[key] = arr.astype(np.float32)
    return out


def _pair(flax_module, port_module, jax_args, seed=0, dtype=None):
    """Flax init -> numpy-random params -> the port module (strict load).
    Returns (flax apply fn, params)."""
    params = flax_module.init(jax.random.PRNGKey(0), *jax_args)["params"]
    params = _randomize_tree(jax.tree_util.tree_map(np.asarray, params),
                             np.random.RandomState(seed))
    port_module.load_state_dict(flax_unet_to_torch(params), strict=True)
    if dtype is not None:
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
        port_module.to(getattr(torch, jnp.dtype(dtype).name))

    def apply(*args):
        return flax_module.apply({"params": params}, *args)
    return apply


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dim,flip", [(32, True), (33, False)])
def test_timestep_embedding(dim, flip):
    t = np.array([0, 1, 500, 999], np.int32)
    ref = jl.timestep_embedding(jnp.asarray(t), dim, flip, 1.0)
    out = tl.timestep_embedding(torch.from_numpy(t), dim, flip, 1.0)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("silu", [True, False])
def test_group_norm_silu(silu):
    """The E[x^2] - E[x]^2 fp32 statistics folded into a per-channel scale and
    shift (layers.py GroupNormSiLU); the input has a mean offset so the
    variance formula matters."""
    x = randn(0, 2, 5, 7, 32) + 3.0
    mod = tl.GroupNormSiLU(32, 8, 1e-5, apply_silu=silu)
    apply = _pair(jl.GroupNormSiLU(8, 1e-5, apply_silu=silu), mod, (jnp.asarray(x),))
    _close(mod(torch.from_numpy(x)), apply(jnp.asarray(x)))


def test_group_norm_silu_bf16():
    x = randn(1, 2, 6, 6, 32) + 2.0
    mod = tl.GroupNormSiLU(32, 8, 1e-5)
    apply = _pair(jl.GroupNormSiLU(8, 1e-5, dtype=jnp.bfloat16), mod,
                  (jnp.asarray(x),), dtype=jnp.bfloat16)
    _close(mod(torch.from_numpy(x).bfloat16()), apply(jnp.asarray(x, jnp.bfloat16)), TOL_BF16)


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16])
def test_group_norm_fp32_statistics(dtype):
    """Flax nn.GroupNorm takes fp32 statistics even for bf16 inputs; with a
    large mean offset bf16 statistics would be far off. (In fp32 the offset
    is smaller: E[x^2] - E[x]^2 at an offset of 50 cancels to ~1e-3 in
    either package, whatever the order of the sums.)"""
    x = randn(2, 2, 6, 10, 32) + (5.0 if dtype is None else 50.0)
    mod = tl.GroupNorm(32, 8, eps=1e-6)
    apply = _pair(fnn.GroupNorm(8, epsilon=1e-6, dtype=dtype), mod, (jnp.asarray(x),),
                  dtype=dtype)
    xt = torch.from_numpy(x)
    tol = TOL if dtype is None else TOL_BF16
    _close(mod(xt if dtype is None else xt.bfloat16()),
           apply(jnp.asarray(x) if dtype is None else jnp.asarray(x, dtype)), tol)


def test_layer_norm_epsilon():
    """Flax LayerNorm's epsilon is 1e-6 (PyTorch's default 1e-5): at an input
    variance of 1e-6 the two differ by ~40%."""
    x = randn(3, 2, 7, 32, scale=1e-3)
    mod = tl.LayerNorm(32)
    apply = _pair(fnn.LayerNorm(), mod, (jnp.asarray(x),))
    _close(mod(torch.from_numpy(x)), apply(jnp.asarray(x)))
    assert not np.allclose(
        torch.nn.functional.layer_norm(torch.from_numpy(x), (32,), mod.weight, mod.bias,
                                       1e-5).detach().numpy(),
        np.asarray(apply(jnp.asarray(x))), atol=TOL, rtol=TOL)


def test_timestep_embedding_mlp():
    x = randn(4, 3, 32)
    mod = tl.TimestepEmbedding(32, 128)
    apply = _pair(jl.TimestepEmbedding(128), mod, (jnp.asarray(x),))
    _close(mod(torch.from_numpy(x)), apply(jnp.asarray(x)))


def test_resnet_block():
    x, temb = randn(5, 2, 6, 10, 32), randn(6, 2, 128)
    mod = tl.ResnetBlock2D(32, 64, 128, groups=8)
    apply = _pair(jl.ResnetBlock2D(64, groups=8), mod, (jnp.asarray(x), jnp.asarray(temb)))
    _close(mod(torch.from_numpy(x), torch.from_numpy(temb)),
           apply(jnp.asarray(x), jnp.asarray(temb)))


def test_self_attention_2d():
    x = randn(7, 2, 8, 8, 64)
    mod = tl.SelfAttention2D(64, head_dim=64, groups=8, eps=1e-6)
    apply = _pair(jl.SelfAttention2D(64, head_dim=64, groups=8, eps=1e-6), mod,
                  (jnp.asarray(x),))
    _close(mod(torch.from_numpy(x)), apply(jnp.asarray(x)))


@pytest.mark.parametrize("cross", [False, True])
def test_cross_attention(cross):
    x, ctx = randn(8, 2, 40, 32), randn(9, 2, 3, 16)
    mod = tl.CrossAttention(32, 2, 16, 16 if cross else None)
    args = (jnp.asarray(x), jnp.asarray(ctx)) if cross else (jnp.asarray(x),)
    apply = _pair(jl.CrossAttention(32, 2, 16, 16 if cross else None), mod, args)
    targs = (torch.from_numpy(x), torch.from_numpy(ctx)) if cross else (torch.from_numpy(x),)
    _close(mod(*targs), apply(*args))


@pytest.mark.parametrize("fused", [False, True])
def test_feed_forward(fused):
    """Unfused: GEGLU with tanh gelu then net.2; fused: the kernel path
    (interpret-mode Pallas on the JAX side, the plain version here)."""
    x = randn(10, 2, 50, 32)
    mod = tl.FeedForward(32, fused=fused)
    apply = _pair(jl.FeedForward(32, fused=fused), mod, (jnp.asarray(x),))
    before = geglu_ff.launches
    _close(mod(torch.from_numpy(x)), apply(jnp.asarray(x)))
    assert geglu_ff.launches == before + int(fused)


def test_basic_transformer_block():
    x, ctx = randn(11, 2, 24, 32), randn(12, 2, 3, 16)
    mod = tl.BasicTransformerBlock(32, 2, 16, 16)
    apply = _pair(jl.BasicTransformerBlock(32, 2, 16, 16), mod,
                  (jnp.asarray(x), jnp.asarray(ctx)))
    _close(mod(torch.from_numpy(x), torch.from_numpy(ctx)), apply(jnp.asarray(x), jnp.asarray(ctx)))


def test_transformer_2d_takes_kernels(monkeypatch):
    """16 x 32 = 512 tokens: the JAX side runs the whole-row attention and
    the fused GEGLU Pallas kernels (interpret mode), the port their
    wrappers; one call each per block on both sides."""
    import d3roma_tpu.ops.pallas as jax_pallas

    monkeypatch.setenv("D3ROMA_PALLAS_INTERPRET", "1")
    calls = {"mha": 0, "geglu": 0}
    real_mha, real_geglu = jax_pallas.mha_attention, jax_pallas.geglu_ff

    def mha(*a, **k):
        calls["mha"] += 1
        return real_mha(*a, **k)

    def geglu(*a, **k):
        calls["geglu"] += 1
        return real_geglu(*a, **k)

    monkeypatch.setattr(jax_pallas, "mha_attention", mha)
    monkeypatch.setattr(jax_pallas, "geglu_ff", geglu)
    x, ctx = randn(13, 1, 16, 32, 32), randn(14, 1, 2, 16)
    kw = dict(groups=8, use_flash="pallas-self", fused_ff=True)
    mod = tl.Transformer2D(32, 1, 32, 16, **kw)
    apply = _pair(jl.Transformer2D(32, 1, 32, 16, **kw), mod,
                  (jnp.asarray(x), jnp.asarray(ctx)))
    calls.update(mha=0, geglu=0)
    before = (mha_attention.launches, geglu_ff.launches)
    ref = apply(jnp.asarray(x), jnp.asarray(ctx))
    out = mod(torch.from_numpy(x), torch.from_numpy(ctx))
    _close(out, ref)
    assert calls == {"mha": 1, "geglu": 1}
    assert (mha_attention.launches - before[0], geglu_ff.launches - before[1]) == (1, 1)


@pytest.mark.parametrize("asym", [False, True])
def test_downsample(asym):
    x = randn(15, 2, 9, 11, 16)
    mod = tl.Downsample2D(16, asymmetric_padding=asym)
    apply = _pair(jl.Downsample2D(16, asymmetric_padding=asym), mod, (jnp.asarray(x),))
    _close(mod(torch.from_numpy(x)), apply(jnp.asarray(x)))


def test_upsample_to_odd_size():
    """The UNet's up path at 640x360 resizes 23 -> 45 rows. jax.image.resize
    "nearest" is PyTorch's "nearest-exact"; plain "nearest" picks other
    rows there."""
    x = randn(16, 1, 23, 40, 16)
    mod = tl.Upsample2D(16)
    apply = _pair(jl.Upsample2D(16), mod, (jnp.asarray(x), (45, 80)))
    _close(mod(torch.from_numpy(x), (45, 80)), apply(jnp.asarray(x), (45, 80)))
    resized = np.asarray(jax.image.resize(jnp.asarray(x), (1, 45, 80, 16), "nearest"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    exact = torch.nn.functional.interpolate(xt, size=(45, 80), mode="nearest-exact")
    plain = torch.nn.functional.interpolate(xt, size=(45, 80), mode="nearest")
    np.testing.assert_array_equal(exact.permute(0, 2, 3, 1).numpy(), resized)
    assert not np.array_equal(plain.permute(0, 2, 3, 1).numpy(), resized)
