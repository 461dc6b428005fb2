"""DeepCache in the port against the JAX package: the step patterns, the
UNet's trunk and shallow passes at depth 1 and 2, and the F/S step loop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.models.torch_import import unet_torch_to_flax
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu.pipelines import sampling as jax_sampling
from d3roma_tpu_torch.models import UNet2DCondition
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import SamplerSpec
from d3roma_tpu_torch.pipelines import sampling as port_sampling
from torch_port_utils import SCHEDULE, TINY_UNET3, randn, randomize_, state_dict_numpy, to_numpy

# fp32 on both sides: the same math with sums in another order
TOL = 1e-4


@pytest.mark.parametrize("pattern", ["F", "FSFSFF", "fssf", "FFFF", "S", "FXF", "FS"])
def test_parse_cache_schedule_matches_jax(pattern):
    for n in (len(pattern), len(pattern) + 1):
        try:
            ref = jax_sampling.parse_cache_schedule(pattern, n)
        except ValueError:
            with pytest.raises(ValueError):
                port_sampling.parse_cache_schedule(pattern, n)
        else:
            assert port_sampling.parse_cache_schedule(pattern, n) == ref


def test_uniform_cache_schedule_matches_jax():
    for k in (0, 1, 2, 3, 4, 11):
        for n in (1, 5, 10):
            assert (port_sampling.uniform_cache_schedule(k, n)
                    == jax_sampling.uniform_cache_schedule(k, n))


@pytest.fixture(scope="module")
def unets():
    port = randomize_(UNet2DCondition(**TINY_UNET3, device="cpu"), 0)
    params = jax.tree_util.tree_map(jnp.asarray, unet_torch_to_flax(state_dict_numpy(port)))
    return port, JaxUNet(**TINY_UNET3), params


def _inputs():
    x = randn(1, 2, 16, 32, TINY_UNET3["in_channels"])
    ctx = randn(2, 2, 2, TINY_UNET3["cross_attention_dim"])
    return x, ctx


@pytest.mark.parametrize("depth", [1, 2])
def test_trunk_and_shallow_pass_match_jax(unets, depth):
    port, jax_unet, params = unets
    jax_unet = dataclasses.replace(jax_unet, cache_depth=depth)
    port.cache_depth = depth
    x, ctx = _inputs()
    apply = jax.jit(jax_unet.apply, static_argnames=("return_trunk",))
    ref_out, ref_trunk = apply({"params": params}, jnp.asarray(x), jnp.int32(501),
                               jnp.asarray(ctx), return_trunk=True)
    # a stale trunk (another step's input), as the S steps of a schedule see
    x2 = randn(3, *x.shape)
    ref_cached = apply({"params": params}, jnp.asarray(x2), jnp.int32(401), jnp.asarray(ctx),
                       cached_trunk=ref_trunk)
    with torch.no_grad():
        out, trunk = port(torch.from_numpy(x), 501, torch.from_numpy(ctx), return_trunk=True)
        cached = port(torch.from_numpy(x2), 401, torch.from_numpy(ctx), cached_trunk=trunk)
        plain = port(torch.from_numpy(x), 501, torch.from_numpy(ctx))
        same_step = port(torch.from_numpy(x), 501, torch.from_numpy(ctx), cached_trunk=trunk)
    # the trunk enters the first refreshed up block: 64 channels at 8x16 for
    # depth 2 (up block 1), at 16x32 for depth 1 (up block 2)
    assert tuple(trunk.shape) == ((2, 8, 16, 64) if depth == 2 else (2, 16, 32, 64))
    for got, ref in ((out, ref_out), (trunk, ref_trunk), (cached, ref_cached)):
        np.testing.assert_allclose(to_numpy(got), np.asarray(ref), atol=TOL, rtol=TOL)
    # return_trunk changes nothing, and the shallow pass on its own step's
    # trunk is the full pass
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    torch.testing.assert_close(same_step, out, rtol=1e-6, atol=1e-6)


def test_cache_depth_range(unets):
    port = unets[0]
    for bad in (0, 3):
        with pytest.raises(ValueError):
            port.cache_depth = bad


# A toy model for the step loop, the same function in both frameworks: the
# "trunk" is the full step's input latent, and the shallow pass uses it, so
# a wrong trunk (or a full pass where a shallow one belongs) shows.
def _toy(lib):
    tanh = torch.tanh if lib is torch else jnp.tanh

    def full(model_input, t):
        return tanh(0.7 * model_input[..., :4] - 0.3 * model_input[..., 4:8] + t / 1000.0)

    def trunk_fn(model_input, t):
        return full(model_input, t), model_input[..., :4] * 0.5

    def cached(model_input, t, trunk):
        return tanh(trunk - 0.3 * model_input[..., 4:8] + t / 1000.0)

    return full, trunk_fn, cached


@pytest.mark.parametrize("steps,interval,schedule", [
    (6, 2, None), (7, 3, None), (6, 1, "FSFSFF"), (5, 1, "FSSFS"), (4, 1, "FFFF"), (4, 1, None),
])
def test_step_loop_matches_jax(steps, interval, schedule):
    x_init, conds = randn(4, 2, 4, 6, 4), randn(5, 2, 4, 6, 4)
    jax_spec = JaxSamplerSpec("my_ddim", JaxScheduleConfig(**SCHEDULE))
    spec = SamplerSpec("my_ddim", ScheduleConfig(**SCHEDULE))
    ts, prev_ts = port_sampling._timestep_arrays(spec.schedule, steps)
    _, _, ref = jax_sampling.run_sampler_steps(
        _toy(jnp)[0], jax_spec, jax_spec.schedule.tables(), jnp.asarray(x_init),
        jnp.asarray(conds), jax.random.PRNGKey(0), jnp.asarray(ts, jnp.int32),
        jnp.asarray(prev_ts, jnp.int32), None, None, cache_interval=interval,
        model_fn_trunk=_toy(jnp)[1], model_fn_cached=_toy(jnp)[2], cache_schedule=schedule)
    full, trunk_fn, cached = _toy(torch)
    _, x0s = port_sampling.run_sampler_steps(
        full, spec, spec.schedule.tables("cpu"), torch.from_numpy(x_init),
        torch.from_numpy(conds), ts, prev_ts, cache_interval=interval, model_fn_trunk=trunk_fn,
        model_fn_cached=cached, cache_schedule=schedule)
    np.testing.assert_allclose(x0s.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    # without DeepCache the loop differs wherever a shallow step would run
    _, plain = port_sampling.run_sampler_steps(full, spec, spec.schedule.tables("cpu"),
                                               torch.from_numpy(x_init),
                                               torch.from_numpy(conds), ts, prev_ts)
    has_shallow = "S" in (schedule or port_sampling.uniform_cache_schedule(interval, steps))
    assert has_shallow == (not np.allclose(plain.numpy(), x0s.numpy(), atol=TOL))
