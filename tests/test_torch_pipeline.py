"""The slice as a whole: the port's latent pipeline (RGB + raw, DDIM,
v-prediction, leading spacing) against the JAX GuidedLatentDiffusionPipeline
with the same weights, conditions and initial noise, at a tiny width where
the JAX side runs both Pallas kernels in interpret mode. Stage by stage
(encoded conditions, one UNet forward, decode) and end to end, plus the
kernel launch counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3roma_tpu.ops.pallas as jax_pallas
from d3roma_tpu.guidance import FlowGuidance
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.models import decode_latent as jax_decode_latent
from d3roma_tpu.models import encode_disp_to_latent as jax_encode_disp
from d3roma_tpu.models import encode_image_to_latent as jax_encode
from d3roma_tpu.models.torch_import import unet_torch_to_flax, vae_torch_to_flax
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.pipelines import GuidedLatentDiffusionPipeline as JaxPipeline
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu.pipelines.sampling import latent_encode_conds as jax_encode_conds
from d3roma_tpu_torch.models import (
    AutoencoderKL,
    UNet2DCondition,
    decode_latent,
    encode_disp_to_latent,
    encode_image_to_latent,
)
from d3roma_tpu_torch.ops.kernels import geglu_ff, mha_attention
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec
from d3roma_tpu_torch.pipelines.sampling import latent_encode_conds
from torch_port_utils import (
    IMAGE_HW,
    SCHEDULE,
    TINY_UNET,
    TINY_VAE,
    randn,
    randomize_,
    state_dict_numpy,
    to_numpy,
)

STEPS = 3
# stages: fp32 on both sides, the same math with sums in another order
STAGE_TOL = 1e-4
# final images in [-1, 1]: those differences carried through 3 steps and
# the decoder
IMAGE_TOL = 1e-3
# kernel calls of one UNet forward of the tiny model: self-attention at the
# 512-token level (down block 0, 1 block; up block 1, 2 blocks), and a fused
# feed-forward in each of its 4 transformer blocks
PER_FORWARD = {"attention": 3, "geglu": 4}


@pytest.fixture(scope="module")
def models():
    unet = randomize_(UNet2DCondition(**TINY_UNET, device="cpu"), 0)
    vae = randomize_(AutoencoderKL(**TINY_VAE, device="cpu"), 1)
    text_embed = randn(2, 1, 2, TINY_UNET["cross_attention_dim"])
    h, w = IMAGE_HW
    rgb = randn(3, 2, h, w, 3, scale=0.5)
    raw = np.abs(randn(4, 2, h, w, 1, scale=0.5))
    port = GuidedLatentDiffusionPipeline(
        unet=unet, vae=vae, text_embed=torch.from_numpy(text_embed),
        spec=SamplerSpec("my_ddim", ScheduleConfig(**SCHEDULE)),
        normalizer=Normalizer(ssi=False, mode="average", num_chs=1,
                              ch_bounds=(128.0,), ch_gammas=(1.0,)),
        device="cpu")
    jax_pipe = JaxPipeline(
        unet=JaxUNet(**TINY_UNET),
        unet_params=jax.tree_util.tree_map(jnp.asarray,
                                           unet_torch_to_flax(state_dict_numpy(unet))),
        vae=JaxVAE(**TINY_VAE),
        vae_params=jax.tree_util.tree_map(jnp.asarray,
                                          vae_torch_to_flax(state_dict_numpy(vae))),
        text_embed=jnp.asarray(text_embed),
        spec=JaxSamplerSpec("my_ddim", JaxScheduleConfig(**SCHEDULE)),
        guidance=FlowGuidance(flow_guidance_weight=0.0),
        normalizer=JaxNormalizer(ssi=False, mode="average", num_chs=1,
                                 ch_bounds=(128.0,), ch_gammas=(1.0,)))
    return port, jax_pipe, rgb, raw


@pytest.fixture
def jax_kernel_calls(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode and count the
    calls that reach them (at trace time)."""
    monkeypatch.setenv("D3ROMA_PALLAS_INTERPRET", "1")
    calls = {"attention": 0, "geglu": 0}
    for name, key in (("mha_attention", "attention"), ("geglu_ff", "geglu")):
        real = getattr(jax_pallas, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(jax_pallas, name, counted)
    return calls


def _port_counts():
    return {"attention": mha_attention.launches, "geglu": geglu_ff.launches}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _close(out, ref, tol):
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref, np.float32), atol=tol, rtol=tol)


def test_encode_conds(models):
    port, jax_pipe, rgb, raw = models
    vapply = jax_pipe._vae_apply(jax_pipe.vae_params)
    ref, ref_lat = jax_encode_conds(lambda x: jax_encode(vapply, x), "rgb+raw",
                                    rgb=jnp.asarray(rgb), sim_disp=jnp.asarray(raw))
    with torch.no_grad():
        out, lat = latent_encode_conds(lambda x: encode_image_to_latent(port.vae, x),
                                       "rgb+raw", rgb=torch.from_numpy(rgb),
                                       sim_disp=torch.from_numpy(raw))
    assert tuple(out.shape) == (2, 16, 32, 8) and set(lat) == set(ref_lat)
    _close(out, ref, STAGE_TOL)
    with torch.no_grad():
        disp = encode_disp_to_latent(port.vae, torch.from_numpy(raw))
    _close(disp, jax_encode_disp(vapply, jnp.asarray(raw)), STAGE_TOL)


def _jax_unet_forward(jax_pipe, x, t, ctx):
    return jax.jit(jax_pipe.unet.apply)({"params": jax_pipe.unet_params}, jnp.asarray(x),
                                        jnp.int32(t), jnp.asarray(ctx))


def test_unet_forward(models, jax_kernel_calls):
    port, jax_pipe, _, _ = models
    x = randn(5, 2, 16, 32, TINY_UNET["in_channels"])
    ctx = np.broadcast_to(np.asarray(jax_pipe.text_embed), (2, 2, 16))
    ref = _jax_unet_forward(jax_pipe, x, 741, ctx)
    before = _port_counts()
    with torch.no_grad():
        out = port.unet(torch.from_numpy(x), 741, torch.from_numpy(np.ascontiguousarray(ctx)))
    assert jax_kernel_calls == PER_FORWARD
    assert _delta(_port_counts(), before) == PER_FORWARD
    _close(out, ref, STAGE_TOL)


def test_decode(models):
    port, jax_pipe, _, _ = models
    z = randn(6, 2, 16, 32, 4, scale=0.5)
    ref = jax_decode_latent(jax_pipe._vae_apply(jax_pipe.vae_params), jnp.asarray(z))
    with torch.no_grad():
        out = decode_latent(port.vae, torch.from_numpy(z))
    assert tuple(out.shape) == (2,) + IMAGE_HW + (1,)
    _close(out, ref, STAGE_TOL)


def test_pipeline_matches_jax(models, jax_kernel_calls):
    port, jax_pipe, rgb, raw = models
    key = jax.random.PRNGKey(11)
    ref = jax_pipe(key, num_inference_steps=STEPS, num_intermediate_images=STEPS,
                   cond_channels="rgb+raw", rgb_images=jnp.asarray(rgb),
                   sim_disp=jnp.asarray(raw))
    assert jax_kernel_calls["attention"] > 0 and jax_kernel_calls["geglu"] > 0
    # the JAX initial noise, drawn as latent_denoise draws it: split the key
    # once, normal from the second half, in the input images' dtype
    _, k_init = jax.random.split(key)
    h, w = IMAGE_HW
    x_init = np.array(jax.random.normal(k_init, (2, h // 2, w // 2, 4), jnp.float32))

    before = _port_counts()
    out = port(num_inference_steps=STEPS, num_intermediate_images=STEPS,
               cond_channels="rgb+raw", rgb_images=torch.from_numpy(rgb),
               sim_disp=torch.from_numpy(raw), latents=torch.from_numpy(x_init))
    assert _delta(_port_counts(), before) == {k: STEPS * v for k, v in PER_FORWARD.items()}
    assert tuple(out.images.shape) == (2,) + IMAGE_HW + (1,)
    assert tuple(out.intermediates.shape) == (STEPS, 2) + IMAGE_HW + (1,)
    images = np.asarray(ref.images)
    # most pixels lie inside (-1, 1), so the clamp does not hide differences
    assert np.mean(np.abs(images) < 0.999) > 0.5
    _close(out.images, images, IMAGE_TOL)
    _close(out.intermediates, ref.intermediates, IMAGE_TOL)


def test_fast_inference_latency_bf16(models, jax_kernel_calls):
    """fast_inference("latency") on both sides: bf16 weights, the kernels at
    the same sites (interpret-mode Pallas in JAX, the plain versions here),
    and the fp32 conv_out of the UNet and the VAE, so the model outputs stay
    fp32. bf16 rounds at different points in the two packages (XLA's and
    PyTorch's CPU convolutions and matmuls, 2^-8 relative per rounding), and
    the differences add up over the ~50 layers of a forward: tolerances 5e-2
    of max |output| on one UNet forward, and 0.1 max / 1e-2 mean on the
    final images after 2 steps."""
    port, jax_pipe, rgb, raw = models
    unet = randomize_(UNet2DCondition(**TINY_UNET, device="cpu"), 0)
    vae = randomize_(AutoencoderKL(**TINY_VAE, device="cpu"), 1)
    fast = GuidedLatentDiffusionPipeline(
        unet=unet, vae=vae, text_embed=port.text_embed, spec=port.spec,
        normalizer=port.normalizer, device="cpu").fast_inference("latency")
    jax_fast = jax_pipe.fast_inference("latency")
    assert all(p.dtype == torch.bfloat16 for p in unet.parameters())
    assert unet.use_flash_attention == "pallas-self" and unet.fused_ff

    x = randn(7, 2, 16, 32, TINY_UNET["in_channels"])
    ctx = np.broadcast_to(np.asarray(jax_pipe.text_embed), (2, 2, 16))
    ref = np.asarray(_jax_unet_forward(jax_fast, x, 741, ctx), np.float32)
    with torch.no_grad():
        out = unet(torch.from_numpy(x), 741, torch.from_numpy(np.ascontiguousarray(ctx)))
        assert out.dtype == torch.float32
        assert vae.encode(torch.from_numpy(rgb)).mean.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= 5e-2 * np.abs(ref).max()

    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_fast(key, num_inference_steps=2, num_intermediate_images=1,
                              cond_channels="rgb+raw", rgb_images=jnp.asarray(rgb),
                              sim_disp=jnp.asarray(raw)).images, np.float32)
    _, k_init = jax.random.split(key)
    h, w = IMAGE_HW
    x_init = np.array(jax.random.normal(k_init, (2, h // 2, w // 2, 4), jnp.float32))
    before = _port_counts()
    got = fast(num_inference_steps=2, num_intermediate_images=1, cond_channels="rgb+raw",
               rgb_images=torch.from_numpy(rgb), sim_disp=torch.from_numpy(raw),
               latents=torch.from_numpy(x_init))
    assert _delta(_port_counts(), before) == {k: 2 * v for k, v in PER_FORWARD.items()}
    assert got.images.dtype == torch.float32
    err = np.abs(got.images.numpy() - ref)
    assert err.max() <= 0.1 and err.mean() <= 1e-2, (err.max(), err.mean())
    disp = fast.normalizer.denormalize(got.images)
    assert tuple(disp.shape) == (2,) + IMAGE_HW + (1,) and torch.isfinite(disp).all()
