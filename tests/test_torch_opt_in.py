"""The opt-in kernel configuration as a whole:
`fast_inference("wino").fuse_norms()` with the fused self-attention, DeepCache
interval 2 at depth 2 and calibrated scales, in the port against the JAX
pipeline on the same weights, conditions and initial noise, at a tiny width
with head dim 64 (the fused attention's only head width). The 16x32 latent
level routes its 3x3 convs to Winograd and the 8x16 level to static int8,
so both conv routes run; every self-attention site takes the fused kernel.

On the CPU the JAX GroupNormSiLU takes its XLA branch (bf16 normalize) where
the port's fused branch runs the kernel's plain version (fp32 normalize);
that difference is far inside the int8 noise the image bounds allow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3roma_tpu.ops.pallas as jax_pallas
import d3roma_tpu.ops.quant as jax_quant
import d3roma_tpu.ops.winograd as jax_wino
from d3roma_tpu.guidance import FlowGuidance
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.models import decode_latent as jax_decode_latent
from d3roma_tpu.models import encode_image_to_latent as jax_encode
from d3roma_tpu.models.torch_import import unet_torch_to_flax, vae_torch_to_flax
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.pipelines import GuidedLatentDiffusionPipeline as JaxPipeline
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
from d3roma_tpu_torch.models.layers import GroupNormSiLU
from d3roma_tpu_torch.ops.kernels import (
    conv2d_int8,
    conv3x3_winograd,
    fused_self_attention_int8,
    geglu_ff_int8,
    group_norm_silu,
    group_norm_silu_supported,
    mha_attention_int8,
)
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec
from torch_port_utils import IMAGE_HW, SCHEDULE, TINY_UNET3, TINY_VAE, randn, randomize_, \
    state_dict_numpy

# head dim 64 at widths 64 and 128: one head at the 16x32 level, two below
TINY_OPT = dict(TINY_UNET3, block_out_channels=(64, 128, 128), attention_head_dim=64)
STEPS = 2  # pattern "FS": one full pass with its trunk, one shallow pass


def _kinds():
    return {"attention_fused": fused_self_attention_int8, "attention": mha_attention_int8,
            "geglu": geglu_ff_int8, "conv": conv2d_int8, "wino": conv3x3_winograd}


def _counts():
    return {k: fn.launches for k, fn in _kinds().items()}


@pytest.fixture(scope="module")
def opt_in():
    unet = randomize_(UNet2DCondition(**TINY_OPT, device="cpu"), 0)
    vae = randomize_(AutoencoderKL(**TINY_VAE, device="cpu"), 1)
    text_embed = randn(2, 1, 2, TINY_OPT["cross_attention_dim"])
    h, w = IMAGE_HW
    rgb = randn(3, 2, h, w, 3, scale=0.5)
    raw = np.abs(randn(4, 2, h, w, 1, scale=0.5))
    jax_pipe = JaxPipeline(
        unet=JaxUNet(**TINY_OPT),
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
        device="cpu").fast_inference("wino").fuse_norms()
    port.unet.set_kernels(use_flash_attention="fused")
    port.deepcache(2, depth=2)

    import dataclasses

    jax_opt = jax_pipe.fast_inference("wino").fuse_norms()
    jax_opt = dataclasses.replace(
        jax_opt, unet=dataclasses.replace(jax_opt.unet, use_flash_attention="fused"))
    cal_key, key = jax.random.PRNGKey(31), jax.random.PRNGKey(32)
    batch = dict(rgb_images=jnp.asarray(rgb), sim_disp=jnp.asarray(raw))
    jax_opt = jax_opt.deepcache(2, depth=2).calibrate(cal_key, [batch], cond_channels="rgb+raw",
                                                      num_inference_steps=STEPS)
    latent_shape = (2, h // 2, w // 2, 4)
    cal_noise = np.array(jax.random.normal(jax.random.fold_in(cal_key, 0), latent_shape))
    x_init = np.array(jax.random.normal(jax.random.split(key)[1], latent_shape, jnp.float32))

    # the JAX kernel calls of one __call__, counted at trace time: one full
    # and one shallow UNet pass, one encode, one decode
    calls = {k: 0 for k in _kinds()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("D3ROMA_PALLAS_INTERPRET", "1")
        for mod, name, k in ((jax_pallas, "fused_self_attention", "attention_fused"),
                             (jax_pallas, "mha_attention", "attention"),
                             (jax_pallas, "geglu_ff", "geglu"),
                             (jax_quant, "int8_conv_general_dilated_static", "conv"),
                             (jax_wino, "winograd_conv3x3", "wino")):
            def counted(*a, _real=getattr(mod, name), _k=k, **kw):
                calls[_k] += 1
                return _real(*a, **kw)
            mp.setattr(mod, name, counted)
        ref = jax_opt(key, num_inference_steps=STEPS, num_intermediate_images=1,
                      cond_channels="rgb+raw", rgb_images=jnp.asarray(rgb),
                      sim_disp=jnp.asarray(raw))

    shape_logs = {}
    port.calibrate(None, [dict(rgb_images=torch.from_numpy(rgb), sim_disp=torch.from_numpy(raw),
                               latents=torch.from_numpy(cal_noise))],
                   cond_channels="rgb+raw", num_inference_steps=STEPS, shape_logs=shape_logs)
    return dict(port=port, jax_opt=jax_opt, ref=np.asarray(ref.images, np.float32),
                jax_calls=calls, x_init=x_init, rgb=rgb, raw=raw,
                port_scales=dict(port.act_scales), shape_logs=shape_logs)


def test_configuration():
    """What the configuration methods set in the port's models."""
    unet = UNet2DCondition(**TINY_OPT, device="cpu")
    vae = AutoencoderKL(**TINY_VAE, device="cpu")
    pipe = GuidedLatentDiffusionPipeline(
        unet=unet, vae=vae, text_embed=torch.zeros(1, 2, 16),
        spec=SamplerSpec("my_ddim", ScheduleConfig(**SCHEDULE)),
        normalizer=Normalizer(ssi=False, mode="average", num_chs=1, ch_bounds=(128.0,),
                              ch_gammas=(1.0,)), device="cpu")
    assert pipe.fast_inference("wino") is pipe and pipe.fuse_norms() is pipe
    assert unet.quant == vae.quant == "wino_static" and unet.fused_norm and vae.fused_norm
    assert all(m.fused for m in list(unet.modules()) + list(vae.modules())
               if isinstance(m, GroupNormSiLU))
    assert unet.use_flash_attention == "pallas-self" and unet.fused_ff
    # "dense" is ported since the bench's slice: dynamic int8 at the dense layers
    assert pipe.fast_inference("dense") is pipe and unet.quant == vae.quant == "dense"


def test_calibration_matches_jax(opt_in):
    """The port's calibrate() against JAX's on one batch with the same noise:
    the same tables with the same lengths; the call order's kinds (with the
    fused attention's "attn" taps) and shapes equal JAX's quant_call_map;
    each scale within 5e-2 of JAX's."""
    bd = opt_in
    ours, ref = bd["port_scales"], bd["jax_opt"].act_scales
    assert set(ours) == set(ref) == {"unet", "unet_cached", "vae_encode", "vae_decode"}
    for table in ref:
        assert len(ours[table]) == len(ref[table]), table
        np.testing.assert_allclose(ours[table], ref[table], rtol=5e-2, err_msg=table)
    h, w = IMAGE_HW
    call_map = bd["jax_opt"].quant_call_map(batch=2, height=h * 4, width=w * 4)
    vapply = bd["jax_opt"]._vae_apply(bd["jax_opt"].vae_params)
    for table, fn, shape in (
            ("vae_encode", lambda x: jax_encode(vapply, x), (4, h, w, 3)),
            ("vae_decode", lambda z: jax_decode_latent(vapply, z), (2, h // 2, w // 2, 4))):
        call_map[table] = []
        with jax_quant.capture_act_scales([], shape_log=call_map[table]):
            jax.eval_shape(fn, jax.ShapeDtypeStruct(shape, jnp.float32))
    for table in ref:
        assert [(k, tuple(s)) for k, s in call_map[table]] == bd["shape_logs"][table], table
    kinds = {k for k, _ in bd["shape_logs"]["unet"]}
    assert "attn" in kinds and "conv" in kinds


def test_call_matches_jax(opt_in):
    """One call replaying the JAX-calibrated table, against the JAX pipeline
    on the same weights, table and initial noise; the kernel launches of the
    call equal the JAX trace's kernel calls, and the fused GroupNorm runs at
    every GroupNormSiLU whose shape its gate admits. Image bounds: the int8
    noise level (see test_torch_pipeline.py's bench default), 0.2 max and
    3e-2 mean on images in [-1, 1]."""
    import json

    bd = opt_in
    port = bd["port"]
    port.act_scales = json.loads(json.dumps(bd["jax_opt"].act_scales))
    admitted = [0]

    def count(mod, args):
        admitted[0] += int(group_norm_silu_supported(args[0].shape, args[0].dtype))

    hooks = [m.register_forward_pre_hook(count)
             for m in list(port.unet.modules()) + list(port.vae.modules())
             if isinstance(m, GroupNormSiLU)]
    before, gn_before = _counts(), group_norm_silu.launches
    try:
        got = port(num_inference_steps=STEPS, num_intermediate_images=1,
                   cond_channels="rgb+raw", rgb_images=torch.from_numpy(bd["rgb"]),
                   sim_disp=torch.from_numpy(bd["raw"]),
                   latents=torch.from_numpy(bd["x_init"]))
    finally:
        for hk in hooks:
            hk.remove()
    launches = {k: _counts()[k] - before[k] for k in before}
    assert launches == bd["jax_calls"]
    assert all(v > 0 for v in launches.values()), launches
    assert group_norm_silu.launches - gn_before == admitted[0] > 0
    err = np.abs(got.images.numpy() - bd["ref"])
    assert np.mean(np.abs(bd["ref"]) < 0.999) > 0.5
    assert err.max() <= 0.2 and err.mean() <= 3e-2, (err.max(), err.mean())
