"""The port's diffusion numerics against the JAX package's: beta schedules,
timestep tables, the DDIM step, the disparity normalizer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops import normalizer as jax_norm
from d3roma_tpu.ops import scheduler_step as jax_step
from d3roma_tpu.ops import schedules as jax_sched
from d3roma_tpu.pipelines import sampling as jax_sampling
from d3roma_tpu_torch.ops import normalizer as port_norm
from d3roma_tpu_torch.ops import scheduler_step as port_step
from d3roma_tpu_torch.ops import schedules as port_sched
from d3roma_tpu_torch.pipelines import sampling as port_sampling
from torch_port_utils import SCHEDULE, randn


@pytest.mark.parametrize("kind", ["linear", "scaled_linear", "squaredcos_cap_v2", "sigmoid"])
def test_betas_and_tables(kind):
    cfg = dict(num_train_timesteps=1000, beta_schedule=kind, beta_start=0.00085,
               beta_end=0.012, rescale_betas_zero_snr=kind == "linear")
    np.testing.assert_array_equal(port_sched.make_betas(1000, kind),
                                  jax_sched.make_betas(1000, kind))
    ref = jax_sched.ScheduleConfig(**cfg).tables()
    out = port_sched.ScheduleConfig(**cfg).tables(device="cpu")
    for field in ("alphas_cumprod", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                  "final_alpha_cumprod", "posterior_variance", "posterior_mean_coef1"):
        got = getattr(out, field)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref, field)))


@pytest.mark.parametrize("spacing,offset,steps", [
    ("leading", 1, 10), ("leading", 0, 7), ("linspace", 0, 10), ("trailing", 0, 10),
    ("leading", 1, 1000)])
def test_timesteps_and_previous(spacing, offset, steps):
    jcfg = jax_sched.ScheduleConfig(timestep_spacing=spacing, steps_offset=offset)
    pcfg = port_sched.ScheduleConfig(timestep_spacing=spacing, steps_offset=offset)
    np.testing.assert_array_equal(port_sched.set_timesteps(pcfg, steps),
                                  jax_sched.set_timesteps(jcfg, steps))
    ts, prev = port_sampling._timestep_arrays(pcfg, steps)
    jts, jprev = jax_sampling._timestep_arrays(jcfg, steps)
    np.testing.assert_array_equal(ts, np.asarray(jts))
    np.testing.assert_array_equal(prev, np.asarray(jprev))
    for inter in (1, 3, steps):
        np.testing.assert_array_equal(port_sampling._kept_indices(steps, inter),
                                      jax_sampling._kept_indices(steps, inter))


@pytest.mark.parametrize("prediction", ["v_prediction", "epsilon", "sample", "thresholded"])
@pytest.mark.parametrize("t,prev_t", [(901, 801), (981, 881), (1, -99)])
def test_ddim_step(prediction, t, prev_t):
    """fp32 on both sides; prev_t < 0 takes alphas_cumprod[0]
    (set_alpha_to_one=False). (t = T, which leading spacing with
    steps_offset=1 yields at S = T steps, is left out: the JAX package's
    jnp.take fills it with NaN, the port clamps it to T - 1.)"""
    cfg = dict(SCHEDULE, prediction_type=prediction, clip_sample=prediction == "sample")
    if prediction == "thresholded":  # Imagen dynamic thresholding of x0
        cfg.update(prediction_type="epsilon", thresholding=True, sample_max_value=1.5)
    jcfg, pcfg = jax_sched.ScheduleConfig(**cfg), port_sched.ScheduleConfig(**cfg)
    out, x = randn(0, 2, 4, 6, 4), randn(1, 2, 4, 6, 4)
    ref = jax_step.ddim_step(jcfg.tables(), jcfg, jnp.asarray(out), jnp.int32(t),
                             jnp.int32(prev_t), jnp.asarray(x))
    got = port_step.ddim_step(pcfg.tables("cpu"), pcfg, torch.from_numpy(out), t, prev_t,
                              torch.from_numpy(x))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode,num_chs,bounds,gammas", [
    ("average", 1, (128.0,), (1.0,)),
    ("average", 3, (64.0,), (0.5,)),
    ("piecewise", 3, (64.0, 32.0, 32.0), (1.0, 0.8, 1.2)),
])
def test_normalizer(mode, num_chs, bounds, gammas):
    kw = dict(ssi=False, mode=mode, num_chs=num_chs, ch_bounds=bounds, ch_gammas=gammas)
    disp = np.abs(randn(2, 2, 5, 7, 1, scale=60.0))
    ref_y, _, _ = jax_norm.Normalizer(**kw).normalize(jnp.asarray(disp))
    port = port_norm.Normalizer(**kw)
    y = port.normalize(torch.from_numpy(disp))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=1e-5, rtol=1e-5)
    ref_back = jax_norm.Normalizer(**kw).denormalize(ref_y)
    np.testing.assert_allclose(port.denormalize(y).numpy(), np.asarray(ref_back),
                               atol=1e-4, rtol=1e-5)


def test_add_noise():
    cfg = dict(SCHEDULE)
    x0, noise = randn(3, 2, 4, 6, 4), randn(4, 2, 4, 6, 4)
    t = np.array([0, 981], np.int32)
    ref = jax_sched.add_noise(jax_sched.ScheduleConfig(**cfg).tables(), jnp.asarray(x0),
                              jnp.asarray(noise), jnp.asarray(t))
    out = port_sched.add_noise(port_sched.ScheduleConfig(**cfg).tables("cpu"),
                               torch.from_numpy(x0), torch.from_numpy(noise),
                               torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_ssi_normalizer_not_ported():
    with pytest.raises(NotImplementedError):
        port_norm.Normalizer(ssi=True)
