"""The reverse-process steps of the port (ops/scheduler_step.py) against the
JAX package's, called eagerly on the same numpy inputs and the same noise:
every prediction type, clip and threshold setting, DDPM variance type, the
last step (prev_t = -1), t = 0 (DDPM's noise masked off), the guidance hook
and the zero-SNR terminal step. Tolerance: 1e-6 relative to max |ref| (the
same fp32 ops in the same order).

Plus one non-DDIM sampler through the latent pipeline (the same loop as the
pixel pipeline's), against the JAX latent pipeline with its key schedule
replayed as explicit noise, within 1e-3 of max |ref|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.guidance import FlowGuidance as JaxGuidance
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.ops import scheduler_step as jax_step
from d3roma_tpu.pipelines import GuidedLatentDiffusionPipeline as JaxLatentPipeline
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu_torch.models import (
    AutoencoderKL,
    UNet2DCondition,
    flax_unet_to_torch,
    flax_vae_to_torch,
)
from d3roma_tpu_torch.ops import scheduler_step as port_step
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec
from d3roma_tpu_torch.pipelines.sampling import SAMPLER_KINDS, run_sampler_steps
from torch_port_utils import jax_noise_schedule, randn, random_flax_tree, to_numpy

TOL = 1e-6
SHAPE = (2, 4, 6, 3)
PREDICTIONS = ("epsilon", "sample", "v_prediction")
CLIPS = {"none": dict(clip_sample=False), "clip": dict(clip_sample=True, clip_sample_range=0.8),
         "threshold": dict(thresholding=True, sample_max_value=1.5,
                           dynamic_thresholding_ratio=0.9)}


def _close(got, ref):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(to_numpy(got), ref, atol=TOL * scale, rtol=TOL)


def _cfgs(**kw):
    return JaxScheduleConfig(**kw), ScheduleConfig(**kw)


def _inputs(seed, scale=1.0):
    return randn(seed, *SHAPE, scale=scale), randn(seed + 1, *SHAPE)


def _guide(lib):
    """An imputation-like hook: a fixed target inside a fixed mask."""
    target, mask = randn(40, *SHAPE, scale=0.3), (randn(41, *SHAPE) > 0).astype(np.float32)
    if lib == "jax":
        t, m = jnp.asarray(target), jnp.asarray(mask)
    else:
        t, m = torch.from_numpy(target), torch.from_numpy(mask)
    return lambda x0, step: x0 * (1 - m) + t * m


def test_sampler_kinds():
    from d3roma_tpu.pipelines.sampling import SAMPLER_KINDS as JAX_KINDS

    assert SAMPLER_KINDS == JAX_KINDS
    spec = SamplerSpec("heun", ScheduleConfig())
    assert spec.is_ode and not spec.is_ddim
    assert SamplerSpec("my_ddim", ScheduleConfig()).is_ddim
    assert not SamplerSpec("my_ddpm", ScheduleConfig()).is_ode
    with pytest.raises(ValueError):
        SamplerSpec("dpm", ScheduleConfig())


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("prediction", PREDICTIONS)
@pytest.mark.parametrize("t,prev_t", [(87, 62), (12, -1), (0, -25)])
def test_ddpm_step(prediction, clip, t, prev_t):
    jcfg, pcfg = _cfgs(num_train_timesteps=100, prediction_type=prediction, **CLIPS[clip])
    out, x = _inputs(0)
    key = jax.random.PRNGKey(t)
    noise = np.array(jax.random.normal(key, SHAPE, jnp.float32))
    ref = jax_step.ddpm_step(jcfg.tables(), jcfg, jnp.asarray(out), jnp.int32(t),
                             jnp.int32(prev_t), jnp.asarray(x), key=key)
    got = port_step.ddpm_step(pcfg.tables("cpu"), pcfg, torch.from_numpy(out), t, prev_t,
                              torch.from_numpy(x), noise=torch.from_numpy(noise))
    for a, b in zip(got, ref):
        _close(a, b)
    if t == 0:  # no noise at t == 0
        mean = port_step.ddpm_step(pcfg.tables("cpu"), pcfg, torch.from_numpy(out), t, prev_t,
                                   torch.from_numpy(x))
        assert torch.equal(mean.prev_sample, got.prev_sample)


@pytest.mark.parametrize("variance_type", ["fixed_small", "fixed_small_log", "fixed_large",
                                           "fixed_large_log", "learned", "learned_range"])
def test_ddpm_variance_types_and_guidance(variance_type):
    jcfg, pcfg = _cfgs(num_train_timesteps=50, prediction_type="epsilon",
                       variance_type=variance_type, beta_schedule="squaredcos_cap_v2")
    out, x = _inputs(3)
    var = np.abs(randn(5, *SHAPE)) if variance_type == "learned" else np.tanh(randn(5, *SHAPE))
    key = jax.random.PRNGKey(9)
    noise = np.array(jax.random.normal(key, SHAPE, jnp.float32))
    ref = jax_step.ddpm_step(jcfg.tables(), jcfg, jnp.asarray(out), jnp.int32(30), jnp.int32(20),
                             jnp.asarray(x), key=key, guidance_fn=_guide("jax"),
                             variance_output=jnp.asarray(var))
    got = port_step.ddpm_step(pcfg.tables("cpu"), pcfg, torch.from_numpy(out), 30, 20,
                              torch.from_numpy(x), guidance_fn=_guide("torch"),
                              variance_output=torch.from_numpy(var),
                              noise=torch.from_numpy(noise))
    for a, b in zip(got, ref):
        _close(a, b)


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("prediction", PREDICTIONS)
def test_ddim_step_guided(prediction, clip):
    """The guidance hook, eta > 0 with explicit noise, and the clipped model
    output (epsilon re-derived from the guided x0)."""
    jcfg, pcfg = _cfgs(num_train_timesteps=100, prediction_type=prediction, **CLIPS[clip])
    out, x = _inputs(6)
    key = jax.random.PRNGKey(2)
    noise = np.array(jax.random.normal(key, SHAPE, jnp.float32))
    for prev_t in (40, -1):
        ref = jax_step.ddim_step(jcfg.tables(), jcfg, jnp.asarray(out), jnp.int32(60),
                                 jnp.int32(prev_t), jnp.asarray(x), eta=0.7, key=key,
                                 use_clipped_model_output=True, guidance_fn=_guide("jax"))
        got = port_step.ddim_step(pcfg.tables("cpu"), pcfg, torch.from_numpy(out), 60, prev_t,
                                  torch.from_numpy(x), eta=0.7, use_clipped_model_output=True,
                                  guidance_fn=_guide("torch"), noise=torch.from_numpy(noise))
        for a, b in zip(got, ref):
            _close(a, b)


@pytest.mark.parametrize("ends", ["plain", "zero_snr", "alpha_to_one"])
@pytest.mark.parametrize("prediction", PREDICTIONS)
def test_euler_and_heun(prediction, ends):
    """Euler, then the Heun correction on a second model output, at an inner
    step and the last step (prev_t = -1). Heun falls back to Euler from
    alpha_bar = 0 (the first step of zero-terminal-SNR betas) and into
    alpha_bar = 1 (the last step with set_alpha_to_one, sigma_prev = 0)."""
    zero_snr = ends == "zero_snr"
    kw = dict(num_train_timesteps=100, prediction_type=prediction, clip_sample=False,
              rescale_betas_zero_snr=zero_snr, set_alpha_to_one=ends == "alpha_to_one")
    if zero_snr and prediction == "epsilon":
        kw["prediction_type"] = "v_prediction"  # epsilon has no x0 at alpha_bar = 0
    jcfg, pcfg = _cfgs(**kw)
    out, x = _inputs(8)
    out2 = randn(10, *SHAPE)
    steps = ((99, 80), (40, 20), (10, -1))
    for t, prev_t in steps:
        args = (jnp.asarray(out), jnp.int32(t), jnp.int32(prev_t), jnp.asarray(x))
        ref_e = jax_step.euler_step(jcfg.tables(), jcfg, *args, guidance_fn=_guide("jax"))
        got_e = port_step.euler_step(pcfg.tables("cpu"), pcfg, torch.from_numpy(out), t, prev_t,
                                     torch.from_numpy(x), guidance_fn=_guide("torch"))
        for a, b in zip(got_e, ref_e):
            _close(a, b)
        ref_h = jax_step.heun_correct(jcfg.tables(), jcfg, jnp.asarray(out), jnp.asarray(out2),
                                      jnp.int32(t), jnp.int32(prev_t), jnp.asarray(x),
                                      ref_e.prev_sample, guidance_fn=_guide("jax"))
        got_h = port_step.heun_correct(pcfg.tables("cpu"), pcfg, torch.from_numpy(out),
                                       torch.from_numpy(out2), t, prev_t, torch.from_numpy(x),
                                       got_e.prev_sample, guidance_fn=_guide("torch"))
        for a, b in zip(got_h, ref_h):
            assert np.isfinite(np.asarray(b)).all()
            _close(a, b)
        falls_back = (zero_snr and t == 99) or (ends == "alpha_to_one" and prev_t < 0)
        assert torch.equal(got_h.prev_sample, got_e.prev_sample) == falls_back, (t, prev_t)


def test_posterior_mean_variance_and_sigma():
    jcfg, pcfg = _cfgs(num_train_timesteps=100, beta_schedule="scaled_linear")
    x0, xt = _inputs(12)
    t = np.array([0, 73], np.int32)
    ref = jax_step.posterior_mean_variance(jcfg.tables(), jnp.asarray(x0), jnp.asarray(xt),
                                           jnp.asarray(t))
    got = port_step.posterior_mean_variance(pcfg.tables("cpu"), torch.from_numpy(x0),
                                            torch.from_numpy(xt), torch.from_numpy(t))
    for a, b in zip(got, ref):
        assert tuple(a.shape) == tuple(np.shape(b))
        _close(a, b)
    ab = np.linspace(0.01, 0.99, 7, dtype=np.float32)
    _close(port_step.sigma_of(torch.from_numpy(ab)), jax_step.sigma_of(jnp.asarray(ab)))


def test_batched_timesteps():
    """[B] timesteps, one of them 0 (its noise masked) and one prev_t < 0."""
    jcfg, pcfg = _cfgs(num_train_timesteps=100, prediction_type="v_prediction")
    out, x = _inputs(14)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, SHAPE, jnp.float32))
    t, prev = np.array([0, 50], np.int32), np.array([-1, 30], np.int32)
    ref = jax_step.ddpm_step(jcfg.tables(), jcfg, jnp.asarray(out), jnp.asarray(t),
                             jnp.asarray(prev), jnp.asarray(x), key=key)
    got = port_step.ddpm_step(pcfg.tables("cpu"), pcfg, torch.from_numpy(out),
                              torch.from_numpy(t), torch.from_numpy(prev), torch.from_numpy(x),
                              noise=torch.from_numpy(noise))
    for a, b in zip(got, ref):
        _close(a, b)


# ---------------------------------------------------------------------- #
# a non-DDIM sampler through the latent pipeline

LATENT_UNET = dict(in_channels=12, out_channels=4, block_out_channels=(16, 32),
                   down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                   up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
                   attention_head_dim=8, cross_attention_dim=16, norm_groups=8)
LATENT_VAE = dict(block_out_channels=(8, 16), norm_groups=4)


@pytest.mark.parametrize("kind", ["my_ddpm"])
def test_latent_pipeline_non_ddim(kind):
    sched = dict(num_train_timesteps=100, prediction_type="v_prediction", clip_sample=False)
    ju, jv = JaxUNet(**LATENT_UNET), JaxVAE(**LATENT_VAE)
    up = random_flax_tree(ju, 0, jnp.zeros((1, 4, 4, 12)), jnp.array([0]), jnp.zeros((1, 2, 16)))
    vp = random_flax_tree(jv, 1, jnp.zeros((1, 16, 16, 3)))
    text = randn(2, 1, 2, 16)
    norm = dict(ssi=False, mode="average", num_chs=1, ch_bounds=(128.0,), ch_gammas=(1.0,))
    jax_pipe = JaxLatentPipeline(
        unet=ju, unet_params=jax.tree_util.tree_map(jnp.asarray, up), vae=jv,
        vae_params=jax.tree_util.tree_map(jnp.asarray, vp), text_embed=jnp.asarray(text),
        spec=JaxSamplerSpec(kind, JaxScheduleConfig(**sched)),
        guidance=JaxGuidance(flow_guidance_weight=0.0), normalizer=JaxNormalizer(**norm))
    unet = UNet2DCondition(**LATENT_UNET, device="cpu")
    unet.load_state_dict(flax_unet_to_torch(up), strict=True)
    vae = AutoencoderKL(**LATENT_VAE, device="cpu")
    vae.load_state_dict(flax_vae_to_torch(vp), strict=True)
    port = GuidedLatentDiffusionPipeline(
        unet=unet, vae=vae, text_embed=torch.from_numpy(text),
        spec=SamplerSpec(kind, ScheduleConfig(**sched)), normalizer=Normalizer(**norm),
        device="cpu")
    rgb, raw = randn(3, 2, 16, 16, 3, scale=0.5), np.abs(randn(4, 2, 16, 16, 1, scale=0.5))
    key, steps = jax.random.PRNGKey(11), 3
    ref = jax_pipe(key, num_inference_steps=steps, num_intermediate_images=1,
                   cond_channels="rgb+raw", rgb_images=jnp.asarray(rgb),
                   sim_disp=jnp.asarray(raw))
    x_init, noises = jax_noise_schedule(key, (2, 8, 8, 4), steps)  # one VAE downsample
    out = port(num_inference_steps=steps, num_intermediate_images=1, cond_channels="rgb+raw",
               rgb_images=torch.from_numpy(rgb), sim_disp=torch.from_numpy(raw),
               latents=torch.from_numpy(x_init), step_noise=[torch.from_numpy(n) for n in noises])
    want = np.asarray(ref.images)
    np.testing.assert_allclose(out.images.numpy(), want, atol=1e-3 * np.abs(want).max(), rtol=0)


def test_heun_refuses_deepcache():
    """Heun's second model call has no cached pass: deepcache() refuses it,
    in the interval and the pattern form, and so do replace_sampler() on a
    cached pipeline and the loop itself."""
    norm = dict(ssi=False, mode="average", num_chs=1, ch_bounds=(128.0,), ch_gammas=(1.0,))
    heun = SamplerSpec("heun", ScheduleConfig(num_train_timesteps=100))
    pipe = GuidedLatentDiffusionPipeline(
        unet=UNet2DCondition(**LATENT_UNET, device="cpu"),
        vae=AutoencoderKL(**LATENT_VAE, device="cpu"), text_embed=torch.zeros(1, 2, 16),
        spec=heun, normalizer=Normalizer(**norm), device="cpu")
    for schedule in (2, "FSF"):
        with pytest.raises(ValueError, match="heun"):
            pipe.deepcache(schedule)
    pipe.replace_sampler(SamplerSpec("my_ddim", heun.schedule)).deepcache(2)
    with pytest.raises(ValueError, match="heun"):
        pipe.replace_sampler(heun)
    with pytest.raises(ValueError, match="heun"):
        run_sampler_steps(lambda x, t: x[..., :4], heun, heun.schedule.tables("cpu"),
                          torch.zeros(1, 2, 2, 4), torch.zeros(1, 2, 2, 8), [90, 50, 10],
                          [57, 17, -23], cache_interval=2, model_fn_trunk=lambda x, t: (x, x),
                          model_fn_cached=lambda x, t, tr: x)
