"""The slice as a whole: the port's latent pipeline (RGB + raw, DDIM,
v-prediction, leading spacing) against the JAX GuidedLatentDiffusionPipeline
with the same weights, conditions and initial noise, at a tiny width where
the JAX side runs both Pallas kernels in interpret mode. Stage by stage
(encoded conditions, one UNet forward, decode) and end to end, plus the
kernel launch counts."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3roma_tpu.models.layers as jax_layers
import d3roma_tpu.ops.pallas as jax_pallas
import d3roma_tpu.ops.quant as jax_quant
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
from d3roma_tpu_torch.ops.kernels import (
    conv2d_int8,
    geglu_ff,
    geglu_ff_int8,
    mha_attention,
    mha_attention_int8,
)
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec
from d3roma_tpu_torch.pipelines.sampling import latent_encode_conds
from torch_port_utils import (
    IMAGE_HW,
    SCHEDULE,
    TINY_UNET,
    TINY_UNET3,
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


# ---------------------------------------------------------------------------
# The bench default: fast_inference("throughput") (bf16, static int8 in the
# UNet and the VAE, the int8 attention, GEGLU and conv kernels) with
# DeepCache interval 2 at depth 2 and calibrated activation scales.

DC_STEPS = 2  # pattern "FS": one full pass with its trunk, one shallow pass


@pytest.fixture(scope="module")
def bench_default():
    """The tiny bench-default pipeline in both packages on the same weights:
    JAX calibrates, then runs one call with its Pallas kernels in interpret
    mode while the kernel calls are counted (at trace time, so one full and
    one shallow UNet pass, one encode and one decode). The port calibrates
    on the noise the JAX calibration drew."""
    unet = randomize_(UNet2DCondition(**TINY_UNET3, device="cpu"), 0)
    vae = randomize_(AutoencoderKL(**TINY_VAE, device="cpu"), 1)
    text_embed = randn(2, 1, 2, TINY_UNET3["cross_attention_dim"])
    h, w = IMAGE_HW
    rgb = randn(3, 2, h, w, 3, scale=0.5)
    raw = np.abs(randn(4, 2, h, w, 1, scale=0.5))
    jax_pipe = JaxPipeline(
        unet=JaxUNet(**TINY_UNET3),
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
    port = GuidedLatentDiffusionPipeline(
        unet=unet, vae=vae, text_embed=torch.from_numpy(text_embed),
        spec=SamplerSpec("my_ddim", ScheduleConfig(**SCHEDULE)),
        normalizer=Normalizer(ssi=False, mode="average", num_chs=1,
                              ch_bounds=(128.0,), ch_gammas=(1.0,)),
        device="cpu").fast_inference("throughput").deepcache(2, depth=2)

    cal_key, key = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    batch = dict(rgb_images=jnp.asarray(rgb), sim_disp=jnp.asarray(raw))
    jax_fast = (jax_pipe.fast_inference("throughput").deepcache(2, depth=2)
                .calibrate(cal_key, [batch], cond_channels="rgb+raw",
                           num_inference_steps=DC_STEPS))
    latent_shape = (2, h // 2, w // 2, 4)
    # the noise JAX's calibrate drew for batch 0, and its __call__'s noise
    cal_noise = np.array(jax.random.normal(jax.random.fold_in(cal_key, 0), latent_shape))
    x_init = np.array(jax.random.normal(jax.random.split(key)[1], latent_shape, jnp.float32))

    calls = {"attention": 0, "geglu": 0, "conv": 0}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("D3ROMA_PALLAS_INTERPRET", "1")
        for mod, name, k in ((jax_pallas, "mha_attention", "attention"),
                             (jax_pallas, "geglu_ff", "geglu"),
                             (jax_layers, "int8_conv_general_dilated_static", "conv")):
            def counted(*a, _real=getattr(mod, name), _k=k, **kw):
                calls[_k] += 1
                return _real(*a, **kw)
            mp.setattr(mod, name, counted)
        ref = jax_fast(key, num_inference_steps=DC_STEPS, num_intermediate_images=1,
                       cond_channels="rgb+raw", rgb_images=jnp.asarray(rgb),
                       sim_disp=jnp.asarray(raw))

    shape_logs = {}
    port.calibrate(None, [dict(rgb_images=torch.from_numpy(rgb), sim_disp=torch.from_numpy(raw),
                               latents=torch.from_numpy(cal_noise))],
                   cond_channels="rgb+raw", num_inference_steps=DC_STEPS, shape_logs=shape_logs)
    return dict(port=port, jax_fast=jax_fast, ref=np.asarray(ref.images, np.float32),
                jax_calls=calls, x_init=x_init, rgb=rgb, raw=raw,
                port_scales=dict(port.act_scales), shape_logs=shape_logs)


def _int8_counts():
    return {"attention": mha_attention_int8.launches, "geglu": geglu_ff_int8.launches,
            "conv": conv2d_int8.launches}


def test_bench_default_replays_a_jax_table(bench_default):
    """(a) The JAX-calibrated table, through its JSON form, replays unchanged
    in the port; the output against the JAX pipeline on the same weights,
    table and initial noise, and the kernel launches of one call.

    Every int8 op matches its JAX counterpart exactly on equal inputs
    (test_torch_quant.py, test_torch_conv2d.py, the int8 kernel tests), and
    the call order is JAX's (test_bench_default_calibration_matches_jax).
    But the float ops between them round differently in the two packages
    (XLA's and PyTorch's bf16 ops, GroupNorm statistics, exp and tanh in the
    last place), and a value that lands on the other side of a rounding
    boundary before a quantization moves by one int8 quantum. Each
    quantized layer turns a difference d well below a quantum q into one of
    about sqrt(d q), so over the ~60 quantized layers of a pass the two
    pipelines drift apart to the int8 quantization noise itself: at this
    tiny random model, about 2e-2 mean on images in [-1, 1] (the same as
    between the int8 and the bf16 pipeline). Bounds: 0.2 max, 3e-2 mean."""
    bd = bench_default
    port = bd["port"]
    port.act_scales = json.loads(json.dumps(bd["jax_fast"].act_scales))
    assert set(port.act_scales) == {"unet", "unet_cached", "vae_encode", "vae_decode"}
    before = _int8_counts()
    got = port(num_inference_steps=DC_STEPS, num_intermediate_images=1,
               cond_channels="rgb+raw", rgb_images=torch.from_numpy(bd["rgb"]),
               sim_disp=torch.from_numpy(bd["raw"]), latents=torch.from_numpy(bd["x_init"]))
    # (c) launches of one call: one full and one shallow pass, one encode,
    # one decode, as the JAX trace counted
    assert _delta(_int8_counts(), before) == bd["jax_calls"]
    assert bd["jax_calls"]["attention"] > 0 and bd["jax_calls"]["geglu"] > 0
    assert got.images.dtype == torch.float32
    err = np.abs(got.images.numpy() - bd["ref"])
    assert np.mean(np.abs(bd["ref"]) < 0.999) > 0.5
    assert err.max() <= 0.2 and err.mean() <= 3e-2, (err.max(), err.mean())


def test_bench_default_calibration_matches_jax(bench_default):
    """(b) The port's own calibrate() against JAX's on one batch with the
    same initial noise: the same tables with the same lengths; the call
    order's kinds and shapes equal JAX's quant_call_map; each scale within
    5e-2 of JAX's (absmax taps of bf16 activations whose rounding differs
    between the two packages)."""
    bd = bench_default
    ours, ref = bd["port_scales"], bd["jax_fast"].act_scales
    assert set(ours) == set(ref)
    for table in ref:
        assert len(ours[table]) == len(ref[table]), table
        np.testing.assert_allclose(ours[table], ref[table], rtol=5e-2, err_msg=table)
    h, w = IMAGE_HW
    call_map = bd["jax_fast"].quant_call_map(batch=2, height=h * 4, width=w * 4)
    call_map.update(_jax_vae_call_maps(bd["jax_fast"], h, w))
    for table in ref:
        assert [(k, tuple(s)) for k, s in call_map[table]] == bd["shape_logs"][table], table


def _jax_vae_call_maps(jax_pipe, h, w):
    """(kind, shape) of every static int8 call of the JAX VAE's stacked
    encode (rgb + raw, batch 2) and decode, from an abstract capture trace."""
    vapply = jax_pipe._vae_apply(jax_pipe.vae_params)
    logs = {}
    for table, fn, shape in (
            ("vae_encode", lambda x: jax_encode(vapply, x), (4, h, w, 3)),
            ("vae_decode", lambda z: jax_decode_latent(vapply, z), (2, h // 2, w // 2, 4))):
        logs[table] = []
        with jax_quant.capture_act_scales([], shape_log=logs[table]):
            jax.eval_shape(fn, jax.ShapeDtypeStruct(shape, jnp.float32))
    return logs


def test_bench_default_needs_the_shallow_table(bench_default):
    """A calibrated full-pass table without the shallow pass's is refused:
    the shallow pass visits another sequence of sites."""
    port = bench_default["port"]
    saved = port.act_scales
    try:
        port.act_scales = {k: v for k, v in saved.items() if k != "unet_cached"}
        with pytest.raises(ValueError, match="unet_cached"):
            port._unet_cache_fns()
    finally:
        port.act_scales = saved
