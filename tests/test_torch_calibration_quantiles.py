"""The rest of calibration: `calibrate(quantiles=...)` (the "<table>@q" rows
and the "@quantiles" key), `with_act_clipping` (percentile, margin only,
pins), `quant_call_map` and `kind_pins`, in the port against the JAX
pipeline on the same weights, conditions and initial noise; the quantile
itself against jnp.quantile past torch.quantile's 2^24-element limit; and
the JAX bench's "vae8" setting, whose calibration makes the UNet static in
both packages.

Calibrated with the JAX bench's vae8 selection (a float UNet, a static int8
VAE), DeepCache interval 2 at depth 2, two steps (pattern "FS"). The taps
of the two packages come from bf16-free but differently rounded float
forwards, so tables and quantile rows agree to 5e-2 (as
test_torch_pipeline.py's absmax tables); the clipping arithmetic on one
table is exact."""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3roma_tpu.ops.quant as jq
from d3roma_tpu.guidance import FlowGuidance
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.models.torch_import import unet_torch_to_flax, vae_torch_to_flax
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.pipelines import GuidedLatentDiffusionPipeline as JaxPipeline
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
from d3roma_tpu_torch.ops import quant as tq
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec
from torch_port_utils import IMAGE_HW, SCHEDULE, TINY_UNET3, TINY_VAE, randn, randomize_, \
    state_dict_numpy

STEPS = 2
QUANTILES = (0.999, 0.99)
TABLES = ("unet", "unet_cached", "vae_encode", "vae_decode")


@pytest.fixture(scope="module")
def calibrated():
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
        vae=JaxVAE(**TINY_VAE, quant="static"),
        vae_params=jax.tree_util.tree_map(jnp.asarray,
                                          vae_torch_to_flax(state_dict_numpy(vae))),
        text_embed=jnp.asarray(text_embed),
        spec=JaxSamplerSpec("my_ddim", JaxScheduleConfig(**SCHEDULE)),
        guidance=FlowGuidance(flow_guidance_weight=0.0),
        normalizer=JaxNormalizer(ssi=False, mode="average", num_chs=1,
                                 ch_bounds=(128.0,), ch_gammas=(1.0,))).deepcache(2, depth=2)
    port = GuidedLatentDiffusionPipeline(
        unet=unet, vae=vae, text_embed=torch.from_numpy(text_embed),
        spec=SamplerSpec("my_ddim", ScheduleConfig(**SCHEDULE)),
        normalizer=Normalizer(ssi=False, mode="average", num_chs=1,
                              ch_bounds=(128.0,), ch_gammas=(1.0,)),
        device="cpu").deepcache(2, depth=2)
    port.vae.set_quant("static")
    before = (jax_pipe.unet.quant, jax_pipe.vae.quant, port.unet.quant, port.vae.quant)

    cal_key = jax.random.PRNGKey(21)
    jax_cal = jax_pipe.calibrate(cal_key, [dict(rgb_images=jnp.asarray(rgb),
                                                sim_disp=jnp.asarray(raw))],
                                 cond_channels="rgb+raw", num_inference_steps=STEPS,
                                 quantiles=QUANTILES)
    latent_shape = (2, h // 2, w // 2, 4)
    cal_noise = np.array(jax.random.normal(jax.random.fold_in(cal_key, 0), latent_shape))
    port.calibrate(None, [dict(rgb_images=torch.from_numpy(rgb), sim_disp=torch.from_numpy(raw),
                               latents=torch.from_numpy(cal_noise))],
                   cond_channels="rgb+raw", num_inference_steps=STEPS, quantiles=QUANTILES)
    return dict(jax=jax_cal, port=port, before=before)


def test_vae8_calibration_makes_the_unet_static(calibrated):
    """The JAX bench's vae8 (a float UNet, a static VAE): calibrate() switches
    a UNet in no static mode to "static", with the VAE, in both packages
    (the JAX one returns that pipeline, the port changes its own)."""
    assert calibrated["before"] == (False, "static", False, "static")
    jax_cal, port = calibrated["jax"], calibrated["port"]
    assert (jax_cal.unet.quant, jax_cal.vae.quant) == ("static", "static")
    assert (port.unet.quant, port.vae.quant) == ("static", "static")


def test_quantile_tables_match_jax(calibrated):
    """The same keys (four tables, their "@q" rows, "@quantiles"), the same
    lengths and row widths; absmax tables and quantile rows within 5e-2;
    each table the rows' absmax column times the margin."""
    ours, ref = calibrated["port"].act_scales, calibrated["jax"].act_scales
    assert set(ours) == set(ref) == set(TABLES) | {t + "@q" for t in TABLES} | {"@quantiles"}
    assert ours["@quantiles"] == ref["@quantiles"] == list(QUANTILES)
    for t in TABLES:
        assert len(ours[t]) == len(ref[t]) == len(ours[t + "@q"]) > 0, t
        q_ours, q_ref = np.asarray(ours[t + "@q"]), np.asarray(ref[t + "@q"])
        assert q_ours.shape == q_ref.shape == (len(ref[t]), 1 + len(QUANTILES)), t
        np.testing.assert_allclose(q_ours, q_ref, rtol=5e-2, err_msg=t)
        np.testing.assert_allclose(ours[t], ref[t], rtol=5e-2, err_msg=t)
        assert ours[t] == [float(max(np.float32(v) * 1.25, 1e-8)) for v in q_ours[:, 0]], t
        assert np.all(q_ours[:, 0] >= q_ours[:, 1]) and np.all(q_ours[:, 1] >= q_ours[:, 2])


@pytest.mark.parametrize("kw", [dict(percentile=0.999), dict(percentile=0.99, margin=1.0),
                                dict(margin=1.0), dict(margin=1.25),
                                dict(percentile=0.999, pins={"unet": [3, 0], "vae_decode": [1]})],
                         ids=["p0.999", "p0.99m1", "m1", "default", "pins"])
def test_with_act_clipping_matches_jax(calibrated, kw):
    """On one table (the JAX calibration's, through its JSON form) the port's
    with_act_clipping gives the JAX package's tables exactly: a percentile
    column, a margin-only re-derivation from the absmax column, pins kept
    as "<table>@pins" (sorted), earlier pins dropped."""
    table = json.loads(json.dumps(calibrated["jax"].act_scales))
    ref = calibrated["jax"].with_act_clipping(**kw).act_scales
    port = copy.copy(calibrated["port"])
    port.act_scales = dict(table, **{"unet_cached@pins": [5]})
    assert port.with_act_clipping(**kw) is port
    assert port.act_scales == json.loads(json.dumps(ref))
    with pytest.raises(ValueError, match="not captured"):
        port.with_act_clipping(percentile=0.5)


def test_call_map_and_kind_pins_match_jax(calibrated):
    """quant_call_map (an abstract trace: a meta replica of the UNet) equals
    the JAX package's jax.eval_shape trace, kind_pins selects the same
    indices, and neither changes the port's pipeline. A pipeline whose UNet
    is in no static mode is traced as "static", as in the JAX package."""
    h, w = IMAGE_HW
    shape = dict(batch=2, height=h * 4, width=w * 4)
    jax_cal, port = calibrated["jax"], calibrated["port"]
    ref = {k: [(kind, tuple(s)) for kind, s in v]
           for k, v in jax_cal.quant_call_map(**shape).items()}
    assert port.quant_call_map(**shape) == ref
    assert {kind for kind, _ in ref["unet"]} == {"dot", "conv", "geglu"}
    pins = port.kind_pins(("geglu", "conv"), **shape)
    assert pins == jax_cal.kind_pins(("geglu", "conv"), **shape) and pins["unet_cached"]
    assert pins["unet"] == [i for i, (kind, _) in enumerate(ref["unet"]) if kind != "dot"]
    assert (port.unet.quant, port.vae.quant) == ("static", "static")
    port.unet.set_quant(False)
    try:
        assert port.quant_call_map(**shape) == ref
        assert port.unet.quant is False
        # "wino_static" with the fused GroupNorm: the Winograd sites take no
        # tap (the replica's capture runs their XLA formulation on meta)
        port.unet.set_quant("wino_static")
        port.unet.set_kernels(fused_norm=True)
        jax_wino = dataclasses.replace(jax_cal, unet=dataclasses.replace(
            jax_cal.unet, quant="wino_static", fused_norm=True))
        got = port.quant_call_map(**shape)
        assert got == {k: [(kind, tuple(s)) for kind, s in v]
                       for k, v in jax_wino.quant_call_map(**shape).items()}
        assert len(got["unet"]) < len(ref["unet"]) and port.unet.fused_norm
    finally:
        port.unet.set_quant("static")
        port.unet.set_kernels(fused_norm=False)


def test_quantile_taps_match_jax():
    """A capture with quantiles records [absmax, q...]/127 of |x| per call,
    as the JAX package's jitted capture does."""
    x = randn(8, 3, 17, 29) * np.linspace(0.1, 3.0, 29, dtype=np.float32)

    def jax_capture(a):
        taps = []
        with jq.capture_act_scales(taps, quantiles=QUANTILES):
            jq.consume_act_scale(a, kind="conv")
        return taps[0]

    ref = np.asarray(jax.jit(jax_capture)(jnp.asarray(x)))
    taps, log = [], []
    with tq.capture_act_scales(taps, shape_log=log, quantiles=QUANTILES):
        assert tq.consume_act_scale(torch.from_numpy(x), "conv") == ("float", None)
    assert log == [("conv", x.shape)] and taps[0].shape == (1 + len(QUANTILES),)
    np.testing.assert_allclose(taps[0].numpy(), ref, rtol=1e-6)


def test_quantile_past_2_24_elements():
    """torch.quantile refuses more than 2^24 elements; abs_quantiles (topk
    order statistics, JAX's fp32 positions, its interpolation) equals the
    jitted jnp.quantile on 2^24 + 3 of them, where n itself rounds in fp32
    and the top position lands past the end (JAX's gather clamps it)."""
    n = 2**24 + 3
    a = np.abs(np.random.RandomState(0).standard_normal(n).astype(np.float32))
    qs = (0.999, 1.0)
    ref = np.asarray(jax.jit(lambda v: jnp.quantile(v, jnp.asarray(qs, jnp.float32)))(
        jnp.asarray(a)))
    got = tq.abs_quantiles(torch.from_numpy(a), qs).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[1] == a.max()
