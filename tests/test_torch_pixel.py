"""The pixel family: the port's UNet2D and GuidedDiffusionPipeline against
the JAX package's, on the same numpy-seeded weights and inputs, at the
UNet2D of tests/test_pipelines.py (two levels, (16, 32) channels, one layer
a block, 8 groups).

- One UNet2D forward in fp32 at 23x40, where the level-1 feature (12x20)
  upsamples back to 23 rows, not a doubling: within 1e-4 of max |ref| (the
  same fp32 math, sums in another order).
- The same forward under quant=True (dynamic int8 at every resnet and
  resampler conv and attention projection): every int8 op is exact per op,
  but a last-place float difference in front of a quantization moves a
  value by one quantum, so the bound is the int8 noise level: 0.2 max and
  3e-2 mean of max |ref| (as tests/test_torch_quant_modes.py states it for
  images), with the port's int8 sites counted against the JAX ones.
- The whole pipeline for every sampler kind (and imputation guidance), with
  the JAX key schedule replayed as explicit noise: within 1e-3 of max |ref|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3roma_tpu.models.layers as jax_layers
import d3roma_tpu_torch.models.layers as port_layers
from d3roma_tpu.guidance import FlowGuidance as JaxGuidance
from d3roma_tpu.models import UNet2D as JaxUNet2D
from d3roma_tpu.models import pixel_in_channels as jax_pixel_in_channels
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.pipelines import GuidedDiffusionPipeline as JaxPipeline
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu_torch.guidance import FlowGuidance
from d3roma_tpu_torch.models import UNet2D, flax_unet2d_to_torch, pixel_in_channels
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import GuidedDiffusionPipeline, SamplerSpec
from torch_port_utils import (
    PIXEL_SCHEDULE,
    TINY_UNET2D,
    jax_noise_schedule,
    randn,
    random_flax_tree,
    to_numpy,
)

UNET_TOL = 1e-4
PIPE_TOL = 1e-3
HW = (16, 24)
STEPS = 4
# (kind, schedule, eta): every sampler kind, across prediction types,
# clipping and DDPM variance types
CASES = {
    "my_ddpm": (PIXEL_SCHEDULE, 0.0),
    "ddpm": (dict(num_train_timesteps=100, prediction_type="epsilon", clip_sample=False,
                  variance_type="fixed_large"), 0.0),
    "ddim": (dict(num_train_timesteps=100, prediction_type="v_prediction", clip_sample=False,
                  timestep_spacing="trailing"), 0.0),
    "my_ddim": (dict(PIXEL_SCHEDULE, prediction_type="epsilon"), 0.6),
    "euler": (dict(num_train_timesteps=100, prediction_type="v_prediction",
                   clip_sample=False), 0.0),
    "heun": (dict(PIXEL_SCHEDULE, prediction_type="epsilon", thresholding=True,
                  sample_max_value=1.5), 0.0),
}


@pytest.fixture(scope="module")
def models():
    jax_unet = JaxUNet2D(**TINY_UNET2D)
    params = random_flax_tree(jax_unet, 0, jnp.zeros((1, 23, 40, 5)), jnp.array([0]))
    port = UNet2D(**TINY_UNET2D, device="cpu")
    port.load_state_dict(flax_unet2d_to_torch(params), strict=True)
    return jax_unet, jax.tree_util.tree_map(jnp.asarray, params), port


@pytest.fixture(scope="module")
def conds():
    h, w = HW
    rgb = randn(1, 2, h, w, 3, scale=0.5)
    disp = np.abs(randn(2, 2, h, w, 1, scale=20.0)) + 5.0
    disp[:, : h // 3] = 0.0  # invalid rows
    norm = Normalizer(ssi=True, safe_ssi=False)
    raw, _, _ = norm.normalize(torch.from_numpy(disp), torch.from_numpy(disp > 0))
    return rgb, raw.numpy(), disp > 0


def test_pixel_in_channels():
    for combo in ("left+right+raw", "rgb+raw", "rgb+left+right", "rgb+left+right+raw",
                  "rgb", "left+right"):
        assert pixel_in_channels(combo, 1) == jax_pixel_in_channels(combo, 1)
    with pytest.raises(ValueError):
        pixel_in_channels("raw", 1)


def test_unet2d_forward_fp32(models):
    jax_unet, params, port = models
    x, t = randn(5, 2, 23, 40, 5), np.array([3, 97], np.int32)
    ref = np.asarray(jax.jit(jax_unet.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t))
    assert tuple(out.shape) == (2, 23, 40, 1) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=UNET_TOL * np.abs(ref).max(), rtol=0)


def test_unet2d_forward_dynamic_int8(models, monkeypatch):
    jax_unet, params, port = models
    x, t = randn(6, 2, 23, 40, 5), np.array([11, 60], np.int32)
    jax_calls = {"dot": 0, "conv": 0}
    for name, key in (("int8_dot_general", "dot"), ("int8_conv_general_dilated", "conv")):
        real = getattr(jax_layers, name)

        def counted(*a, _real=real, _key=key, **k):
            jax_calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(jax_layers, name, counted)
    ref = np.asarray(jax.jit(dataclasses.replace(jax_unet, quant=True).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t)))
    port_calls = {"dot": 0, "conv": 0}
    for name, key in (("int8_linear_dynamic", "dot"), ("int8_conv_dynamic", "conv")):
        real = getattr(port_layers, name)

        def counted(*a, _real=real, _key=key, **k):
            port_calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(port_layers, name, counted)
    port.set_quant(True)
    try:
        with torch.no_grad():
            out = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    finally:
        port.set_quant(False)
    # 4 projections at each of the 4 attention sites (down level 1, mid, and
    # 2 in up level 0); the resnets' convs and the resamplers
    assert port_calls == jax_calls and port_calls["dot"] == 16, (port_calls, jax_calls)
    err = np.abs(out - ref) / np.abs(ref).max()
    assert err.max() <= 0.2 and err.mean() <= 3e-2, (err.max(), err.mean())


def _pipes(models, kind, schedule, eta, guidance_weight=0.0):
    jax_unet, params, port_unet = models
    norm = dict(ssi=True, safe_ssi=False)
    jax_pipe = JaxPipeline(
        unet=jax_unet, unet_params=params,
        spec=JaxSamplerSpec(kind, JaxScheduleConfig(**schedule), eta=eta),
        guidance=JaxGuidance(flow_guidance_weight=guidance_weight),
        normalizer=JaxNormalizer(**norm))
    port = GuidedDiffusionPipeline(
        unet=port_unet, spec=SamplerSpec(kind, ScheduleConfig(**schedule), eta=eta),
        guidance=FlowGuidance(flow_guidance_weight=guidance_weight),
        normalizer=Normalizer(**norm), device="cpu")
    return jax_pipe, port


def _run_both(jax_pipe, port, conds, seed, raw_mask=None):
    rgb, raw, _ = conds
    key = jax.random.PRNGKey(seed)
    kw = dict(num_inference_steps=STEPS, num_intermediate_images=2, depth_channels=1,
              cond_channels="rgb+raw")
    ref = jax_pipe(key, rgb_images=jnp.asarray(rgb), sim_disp=jnp.asarray(raw),
                   raw_mask=None if raw_mask is None else jnp.asarray(raw_mask), **kw)
    x_init, noises = jax_noise_schedule(key, rgb.shape[:3] + (1,), STEPS)
    out = port(rgb_images=torch.from_numpy(rgb), sim_disp=torch.from_numpy(raw),
               raw_mask=None if raw_mask is None else torch.from_numpy(raw_mask),
               x_init=torch.from_numpy(x_init), step_noise=[torch.from_numpy(n) for n in noises],
               **kw)
    return out, ref


@pytest.mark.parametrize("kind", sorted(CASES))
def test_pixel_pipeline_matches_jax(models, conds, kind):
    schedule, eta = CASES[kind]
    jax_pipe, port = _pipes(models, kind, schedule, eta)
    out, ref = _run_both(jax_pipe, port, conds, seed=3)
    assert tuple(out.images.shape) == (2,) + HW + (1,)
    assert tuple(out.intermediates.shape) == (2, 2) + HW + (1,)
    for got, want in ((out.images, ref.images), (out.intermediates, ref.intermediates)):
        want = np.asarray(want)
        np.testing.assert_allclose(to_numpy(got), want, atol=PIPE_TOL * np.abs(want).max(),
                                   rtol=0)


def test_pixel_pipeline_imputation_guidance(models, conds):
    """Imputation on: x_hat0 takes the normalized raw disparity inside the
    raw mask at every step, as in the JAX pipeline (the final image is a
    noisy prev_sample, so it is compared, not checked against raw)."""
    jax_pipe, port = _pipes(models, "my_ddpm", PIXEL_SCHEDULE, 0.0, guidance_weight=1.0)
    assert port.guidance.enabled
    _, raw, mask = conds
    out, ref = _run_both(jax_pipe, port, conds, seed=4, raw_mask=mask)
    for got, want in ((out.images, ref.images), (out.intermediates, ref.intermediates)):
        want = np.asarray(want)
        np.testing.assert_allclose(to_numpy(got), want, atol=PIPE_TOL * np.abs(want).max(),
                                   rtol=0)
    inter = out.intermediates.numpy()
    np.testing.assert_allclose(inter[:, mask[..., 0]], np.broadcast_to(
        raw[mask[..., 0]], inter[:, mask[..., 0]].shape), atol=1e-6)
    # any other mode is refused
    port.guidance = FlowGuidance(flow_guidance_mode="gradient")
    rgb, raw, _ = conds
    with pytest.raises(NotImplementedError):
        port(num_inference_steps=STEPS, num_intermediate_images=2, depth_channels=1,
             cond_channels="rgb+raw", rgb_images=torch.from_numpy(rgb),
             sim_disp=torch.from_numpy(raw), generator=torch.Generator().manual_seed(0))


def test_pixel_pipeline_generator_and_no_fallback(models, conds):
    """Noise from a torch.Generator is reproducible, add_noise_rgb's rgb
    noise too (refused before the port had it); without a noise source DDPM
    raises; without CUDA the pipeline refuses to be made on the default
    device."""
    _, port = _pipes(models, "my_ddpm", PIXEL_SCHEDULE, 0.0)
    rgb, raw, _ = conds
    kw = dict(num_inference_steps=2, num_intermediate_images=1, depth_channels=1,
              cond_channels="rgb+raw", rgb_images=torch.from_numpy(rgb),
              sim_disp=torch.from_numpy(raw))
    a = port(generator=torch.Generator().manual_seed(0), **kw)
    b = port(generator=torch.Generator().manual_seed(0), **kw)
    assert torch.equal(a.images, b.images) and torch.isfinite(a.images).all()
    c = port(generator=torch.Generator().manual_seed(0), add_noise_rgb=True, **kw)
    d = port(generator=torch.Generator().manual_seed(0), add_noise_rgb=True, **kw)
    assert torch.equal(c.images, d.images) and not torch.equal(c.images, a.images)
    with pytest.raises(ValueError):  # DDPM without a noise source
        port(**kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            GuidedDiffusionPipeline(unet=models[2], spec=port.spec, guidance=port.guidance,
                                    normalizer=port.normalizer)
