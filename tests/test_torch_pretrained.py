"""Pipeline directories across the two packages: a directory that the JAX
package's `save_pretrained` writes loads with the port's `from_pretrained`,
and the other way round, for the pixel and the latent pipeline (with its
act_scales and text embedding). The params come back bit-equal (values and
dtypes, bf16 included) and the pipelines compute the same thing: equal
outputs within a package, and the port against the JAX package within 1e-3
of max |ref| with the JAX key schedule replayed as explicit noise.

Also `utils/flax_msgpack.py` against `flax.serialization`: the same bytes,
chunked leaves included."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from d3roma_tpu.guidance import FlowGuidance as JaxGuidance
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2D as JaxUNet2D
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.pipelines import GuidedDiffusionPipeline as JaxPixelPipeline
from d3roma_tpu.pipelines import GuidedLatentDiffusionPipeline as JaxLatentPipeline
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu_torch.guidance import FlowGuidance
from d3roma_tpu_torch.models import UNet2D, flax_unet2d_to_torch
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import (
    GuidedDiffusionPipeline,
    GuidedLatentDiffusionPipeline,
    SamplerSpec,
)
from d3roma_tpu_torch.utils import flax_msgpack
from torch_port_utils import (
    PIXEL_SCHEDULE,
    TINY_UNET2D,
    jax_noise_schedule,
    randn,
    random_flax_tree,
    randomize_,
)

TOL = 1e-3
PIXEL_KW = dict(num_inference_steps=3, num_intermediate_images=1, depth_channels=1,
                cond_channels="rgb+raw")
LATENT_UNET = dict(in_channels=12, out_channels=4, block_out_channels=(16, 32),
                   down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                   up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
                   attention_head_dim=8, cross_attention_dim=16, norm_groups=8)
LATENT_VAE = dict(block_out_channels=(8, 16), norm_groups=4)
ACT_SCALES = {"unet": [0.5, 0.25, 0.125], "unet_cached": [0.75], "vae_encode": [1.5],
              "vae_decode": [2.0, 3.0], "unet@q": [[0.5, 0.4]], "@quantiles": [0.999]}


def _same_tree(a, b, path=""):
    """Leaf for leaf the same values and dtype; leaves numpy (any dtype,
    JAX bf16 included) or torch."""
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(a[k], b[k], f"{path}/{k}")
            continue
        x, y = (v if isinstance(v, torch.Tensor) else flax_msgpack.loads(
            serialization.to_bytes({"v": np.asarray(v)}))["v"] for v in (a[k], b[k]))
        assert x.dtype == y.dtype and x.shape == y.shape, (path, k, x.dtype, y.dtype)
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y), (path, k)


def _same_state(a: torch.nn.Module, b: torch.nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def test_flax_msgpack_matches_flax(monkeypatch):
    tree = {"conv": {"kernel": randn(0, 3, 3, 4, 8), "bias": randn(1, 8)},
            "norm": {"scale": jnp.ones((8,), jnp.bfloat16)}, "zero_d": np.zeros((), np.float16),
            "a_name_longer_than_thirty_one_chars": {"x": np.arange(300, dtype=np.int64)}}
    data = serialization.to_bytes(tree)
    got = flax_msgpack.loads(data)
    assert got["norm"]["scale"].dtype == torch.bfloat16 and got["zero_d"].shape == ()
    assert flax_msgpack.dumps(got) == data
    # a numpy scalar (ext type 3) reads as a 0-d tensor
    assert flax_msgpack.loads(serialization.to_bytes({"step": np.int32(7)}))["step"].item() == 7
    # chunked leaves (flax splits a leaf above MAX_CHUNK_SIZE bytes)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 1000)
    data = serialization.to_bytes(tree)
    got = flax_msgpack.loads(data)
    assert torch.equal(got["a_name_longer_than_thirty_one_chars"]["x"], torch.arange(300))
    assert flax_msgpack.dumps(got) == data
    with pytest.raises(ValueError):
        flax_msgpack.loads(data[:-3])


@pytest.fixture(scope="module")
def pixel_case():
    unet = JaxUNet2D(**TINY_UNET2D)
    params = random_flax_tree(unet, 0, jnp.zeros((1, 16, 16, 5)), jnp.array([0]))
    pipe = JaxPixelPipeline(
        unet=unet, unet_params=jax.tree_util.tree_map(jnp.asarray, params),
        spec=JaxSamplerSpec("my_ddpm", JaxScheduleConfig(**PIXEL_SCHEDULE)),
        guidance=JaxGuidance(flow_guidance_weight=0.0, num_opt_steps=3),
        normalizer=JaxNormalizer(ssi=True, safe_ssi=False, low_p=0.02))
    rgb = randn(1, 2, 16, 24, 3, scale=0.5)
    raw = np.clip(randn(2, 2, 16, 24, 1, scale=0.5), -1, 1)
    return pipe, params, rgb, raw


def _jax_pixel(pipe, rgb, raw, seed=5):
    out = pipe(jax.random.PRNGKey(seed), rgb_images=jnp.asarray(rgb), sim_disp=jnp.asarray(raw),
               **PIXEL_KW)
    return np.asarray(out.images)


def _port_pixel(pipe, rgb, raw, seed=5):
    x_init, noises = jax_noise_schedule(jax.random.PRNGKey(seed), rgb.shape[:3] + (1,),
                                        PIXEL_KW["num_inference_steps"])
    out = pipe(rgb_images=torch.from_numpy(rgb), sim_disp=torch.from_numpy(raw),
               x_init=torch.from_numpy(x_init), step_noise=[torch.from_numpy(n) for n in noises],
               **PIXEL_KW)
    return out.images.float().numpy()


def test_pixel_jax_directory_in_the_port_and_back(pixel_case, tmp_path):
    jax_pipe, params, rgb, raw = pixel_case
    jax_pipe.save_pretrained(str(tmp_path / "jax"))
    port = GuidedDiffusionPipeline.from_pretrained(str(tmp_path / "jax"), device="cpu")
    assert port.spec.kind == "my_ddpm" and port.spec.schedule == ScheduleConfig(**PIXEL_SCHEDULE)
    assert dataclasses.asdict(port.normalizer) == dataclasses.asdict(jax_pipe.normalizer)
    assert dataclasses.asdict(port.guidance) == dataclasses.asdict(jax_pipe.guidance)
    ref_state = flax_unet2d_to_torch(params)
    for k, v in port.unet.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, ref_state[k]), k
    ref = _jax_pixel(jax_pipe, rgb, raw)
    np.testing.assert_allclose(_port_pixel(port, rgb, raw), ref, atol=TOL * np.abs(ref).max(),
                               rtol=0)

    port.save_pretrained(str(tmp_path / "port"))
    back = JaxPixelPipeline.from_pretrained(str(tmp_path / "port"))
    _same_tree(params, back.unet_params)
    assert back.unet == jax_pipe.unet and back.spec == jax_pipe.spec
    assert back.normalizer == jax_pipe.normalizer and back.guidance == jax_pipe.guidance
    np.testing.assert_array_equal(_jax_pixel(back, rgb, raw), ref)


def test_pixel_port_directory_in_jax_and_back(pixel_case, tmp_path):
    _, _, rgb, raw = pixel_case
    unet = randomize_(UNet2D(**TINY_UNET2D, device="cpu"), 3)
    spec = SamplerSpec("heun", ScheduleConfig(num_train_timesteps=50, prediction_type="epsilon"))
    port = GuidedDiffusionPipeline(unet=unet, spec=spec,
                                   guidance=FlowGuidance(flow_guidance_weight=1.0),
                                   normalizer=Normalizer(ssi=True, ransac_error_threshold=0.3),
                                   device="cpu")
    port.save_pretrained(str(tmp_path / "port"))
    jax_pipe = JaxPixelPipeline.from_pretrained(str(tmp_path / "port"))
    assert jax_pipe.spec.kind == "heun" and jax_pipe.guidance.enabled
    ref = _jax_pixel(jax_pipe, rgb, raw)
    got = _port_pixel(port, rgb, raw)
    np.testing.assert_allclose(got, ref, atol=TOL * np.abs(ref).max(), rtol=0)
    jax_pipe.save_pretrained(str(tmp_path / "jax"))
    again = GuidedDiffusionPipeline.from_pretrained(str(tmp_path / "jax"), device="cpu")
    _same_state(again.unet, port.unet)
    assert (again.spec, again.normalizer, again.guidance) == (port.spec, port.normalizer,
                                                              port.guidance)
    np.testing.assert_array_equal(_port_pixel(again, rgb, raw), got)


def test_half_precision_directories_stay_bf16(pixel_case, tmp_path):
    jax_pipe, _, _, _ = pixel_case
    half = jax_pipe.half_precision()
    half.save_pretrained(str(tmp_path / "jax"))
    port = GuidedDiffusionPipeline.from_pretrained(str(tmp_path / "jax"), device="cpu")
    assert {v.dtype for v in port.unet.state_dict().values()} == {torch.bfloat16}
    port.save_pretrained(str(tmp_path / "port"))
    back = JaxPixelPipeline.from_pretrained(str(tmp_path / "port"))
    _same_tree(half.unet_params, back.unet_params)


@pytest.fixture(scope="module")
def latent_case():
    ju, jv = JaxUNet(**LATENT_UNET), JaxVAE(**LATENT_VAE)
    up = random_flax_tree(ju, 0, jnp.zeros((1, 4, 4, 12)), jnp.array([0]), jnp.zeros((1, 2, 16)))
    vp = random_flax_tree(jv, 1, jnp.zeros((1, 16, 16, 3)))
    pipe = JaxLatentPipeline(
        unet=ju, unet_params=jax.tree_util.tree_map(jnp.asarray, up), vae=jv,
        vae_params=jax.tree_util.tree_map(jnp.asarray, vp),
        text_embed=jnp.asarray(randn(2, 1, 2, 16)),
        spec=JaxSamplerSpec("my_ddpm", JaxScheduleConfig(num_train_timesteps=100,
                                                         prediction_type="v_prediction",
                                                         clip_sample=False)),
        guidance=JaxGuidance(flow_guidance_weight=1.0, flow_guidance_mode="gradient"),
        normalizer=JaxNormalizer(ssi=False, mode="average", num_chs=1, ch_bounds=(128.0,),
                                 ch_gammas=(1.0,)),
        act_scales=ACT_SCALES)
    rgb, raw = randn(3, 2, 16, 16, 3, scale=0.5), np.abs(randn(4, 2, 16, 16, 1, scale=0.5))
    return pipe, up, vp, rgb, raw


def test_latent_directories_both_ways(latent_case, tmp_path):
    jax_pipe, up, vp, rgb, raw = latent_case
    jax_pipe.save_pretrained(str(tmp_path / "jax"))
    port = GuidedLatentDiffusionPipeline.from_pretrained(str(tmp_path / "jax"), device="cpu")
    assert port.act_scales == ACT_SCALES and port.spec.kind == "my_ddpm"
    assert port.guidance.enabled and port.guidance.flow_guidance_mode == "gradient"
    assert torch.equal(port.text_embed, torch.from_numpy(np.array(jax_pipe.text_embed)))
    port.save_pretrained(str(tmp_path / "port"))
    with open(tmp_path / "port" / "act_scales.json") as f:
        assert json.load(f) == ACT_SCALES
    back = JaxLatentPipeline.from_pretrained(str(tmp_path / "port"))
    _same_tree(up, back.unet_params)
    _same_tree(vp, back.vae_params)
    assert back.act_scales == ACT_SCALES and back.spec == jax_pipe.spec
    assert back.unet == jax_pipe.unet and back.vae == jax_pipe.vae
    np.testing.assert_array_equal(np.asarray(back.text_embed), np.asarray(jax_pipe.text_embed))

    key, steps = jax.random.PRNGKey(2), 2
    kw = dict(num_inference_steps=steps, num_intermediate_images=1, cond_channels="rgb+raw")
    ref = np.asarray(jax_pipe(key, rgb_images=jnp.asarray(rgb), sim_disp=jnp.asarray(raw),
                              **kw).images)
    np.testing.assert_array_equal(np.asarray(back(key, rgb_images=jnp.asarray(rgb),
                                                  sim_disp=jnp.asarray(raw), **kw).images), ref)
    x_init, noises = jax_noise_schedule(key, (2, 8, 8, 4), steps)
    got = port(rgb_images=torch.from_numpy(rgb), sim_disp=torch.from_numpy(raw),
               latents=torch.from_numpy(x_init), step_noise=[torch.from_numpy(n) for n in noises],
               **kw).images.numpy()
    np.testing.assert_allclose(got, ref, atol=TOL * np.abs(ref).max(), rtol=0)
    # the saved guidance is carried, not run: asking for it still raises
    with pytest.raises(NotImplementedError):
        port(rgb_images=torch.from_numpy(rgb), sim_disp=torch.from_numpy(raw),
             raw_depth=torch.from_numpy(raw), generator=torch.Generator(), **kw)


def test_wrong_pipeline_class_is_refused(latent_case, tmp_path):
    jax_pipe = latent_case[0]
    jax_pipe.save_pretrained(str(tmp_path / "d"))
    with pytest.raises(ValueError, match="GuidedLatentDiffusionPipeline"):
        GuidedDiffusionPipeline.from_pretrained(str(tmp_path / "d"), device="cpu")
