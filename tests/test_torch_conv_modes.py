"""The bench default's calibrated pipeline (`fast_inference("throughput")`,
DeepCache interval 2 at depth 2, calibrated scales) under the "halo" and
"mxu" conv routes, in the port against the JAX pipeline under the same mode
on the same weights, conditions, scale table and initial noise (the JAX
bench's BENCH_QUANT=halo and BENCH_QUANT=mxu, set on the UNet and the VAE
as bench.py does).

Neither route changes the call order of the scale taps: every quantized
conv takes one "conv" tap, whether its gate sends it to the kernel or to the
static conv. So the port calibrates once, under "static"
(test_torch_pipeline.py holds that table against JAX's), and its table
replays under both modes; the JAX call order under each mode (abstract
traces, as `quant_call_map` takes them) equals the port's.

The JAX calls run their Pallas conv kernels (`conv3x3_halo`,
`conv3x3_flat`, called by the routes without `interpret`) in interpret mode.
The port's int8 conv runs its plain version in the kernel's "halo", "tpu"
or "xla" epilogue (test_torch_conv_entry.py holds a Conv2d under each mode
bit-equal to the JAX route). Image bounds as in test_torch_pipeline.py's
bench default (the int8 noise level, not the per-op parity): 0.2 max and
3e-2 mean on images in [-1, 1].
"""

import contextlib
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3roma_tpu.ops.pallas.conv2d as jax_conv2d
import d3roma_tpu.ops.pallas.conv2d_halo as jax_halo
import d3roma_tpu.ops.quant as jax_quant
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
from d3roma_tpu_torch.ops import quant as tq
from d3roma_tpu_torch.ops.kernels import conv2d_int8, geglu_ff_int8, mha_attention_int8
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec
from torch_port_utils import IMAGE_HW, SCHEDULE, TINY_UNET3, TINY_VAE, randn, randomize_, \
    state_dict_numpy

STEPS = 2  # calibration, pattern "FS": one full pass with its trunk, one shallow pass
CALL_STEPS = 1  # the compared calls: one full pass (each JAX kernel site costs a compile)
MODES = ("halo", "mxu")
# the kernel each mode's admitted convs take, by the port's epilogue name
KERNEL_EPILOGUE = {"halo": "halo", "mxu": "tpu"}
# the JAX kernel each mode's routes call, without `interpret`
JAX_KERNEL = {"halo": (jax_halo, "conv3x3_halo"), "mxu": (jax_conv2d, "conv3x3_flat")}


def _with_quant(pipe, quant):
    return dataclasses.replace(pipe, unet=dataclasses.replace(pipe.unet, quant=quant),
                               vae=dataclasses.replace(pipe.vae, quant=quant))


def _jax_call_maps(pipe, h, w):
    """(kind, shape) of every static int8 call of one call's UNet full and
    shallow pass (quant_call_map) and its VAE encode and decode, from
    abstract capture traces."""
    call_map = pipe.quant_call_map(batch=2, height=h * 4, width=w * 4)
    vapply = pipe._vae_apply(pipe.vae_params)
    for table, fn, shape in (
            ("vae_encode", lambda x: jax_encode(vapply, x), (4, h, w, 3)),
            ("vae_decode", lambda z: jax_decode_latent(vapply, z), (2, h // 2, w // 2, 4))):
        call_map[table] = []
        with jax_quant.capture_act_scales([], shape_log=call_map[table]):
            jax.eval_shape(fn, jax.ShapeDtypeStruct(shape, jnp.float32))
    return {k: [(kind, tuple(s)) for kind, s in v] for k, v in call_map.items()}


def _port_counts():
    return {"attention": mha_attention_int8.launches, "geglu": geglu_ff_int8.launches,
            **{f"conv_{k}": v for k, v in conv2d_int8.epilogue_launches.items()}}


@pytest.fixture(scope="module")
def routes():
    """The port calibrates once, under "static"; the JAX pipeline replays
    the port's table."""
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
    latent_shape = (2, h // 2, w // 2, 4)
    logs = {}
    port.calibrate(None, [dict(rgb_images=torch.from_numpy(rgb), sim_disp=torch.from_numpy(raw),
                               latents=torch.from_numpy(randn(5, *latent_shape)))],
                   cond_channels="rgb+raw", num_inference_steps=STEPS, shape_logs=logs)
    scales = dict(port.act_scales)

    jax_fast = jax_pipe.fast_inference("throughput").deepcache(2, depth=2)
    jax_fast = dataclasses.replace(jax_fast, act_scales=json.loads(json.dumps(scales)))
    return dict(port=port, jax_fast=jax_fast, rgb=rgb, raw=raw, scales=scales, logs=logs,
                latent_shape=latent_shape)


@contextlib.contextmanager
def _counted_gates(mp):
    """Counts the JAX gates' decisions (kernel or static conv) while active."""
    admitted = {"kernel": 0, "static": 0}
    for module, name in ((jax_conv2d, "conv3x3_supported"), (jax_halo, "halo_conv_supported")):
        def gate(*a, _real=getattr(module, name), **kw):
            ok = _real(*a, **kw)
            admitted["kernel" if ok else "static"] += 1
            return ok
        mp.setattr(module, name, gate)
    yield admitted


def test_one_table_and_call_order_for_every_mode(routes):
    """The port's "static" table has its four tables; the JAX call order's
    kinds and shapes under "halo" and "mxu" (one call: a full and a shallow
    UNet pass, the VAE encode and decode) equal the port's, and the JAX
    gates see every conv visit; a port UNet forward under capture logs the
    same taps under every static mode."""
    assert set(routes["scales"]) == {"unet", "unet_cached", "vae_encode", "vae_decode"}
    logs = routes["logs"]
    n_conv = sum(kind == "conv" for log in logs.values() for kind, _ in log)
    h, w = IMAGE_HW
    for mode in MODES:
        with pytest.MonkeyPatch.context() as mp, _counted_gates(mp) as gates:
            call_map = _jax_call_maps(_with_quant(routes["jax_fast"], mode), h, w)
        assert call_map == logs, mode
        assert gates["kernel"] > 0 and gates["static"] > 0, gates
        assert sum(gates.values()) == n_conv, (mode, gates)
    port = routes["port"]
    x = torch.from_numpy(randn(6, *routes["latent_shape"][:3], TINY_UNET3["in_channels"]))
    ctx = torch.from_numpy(randn(7, 2, 2, TINY_UNET3["cross_attention_dim"]))
    unet_logs = {}
    for mode in ("static",) + MODES:
        port.set_quant(mode)
        unet_logs[mode] = []
        with torch.no_grad(), tq.capture_act_scales([], shape_log=unet_logs[mode]):
            port.unet(x, 741, ctx)
    assert unet_logs["halo"] == unet_logs["mxu"] == unet_logs["static"] == logs["unet"]


@pytest.mark.parametrize("mode", MODES)
def test_halo_and_mxu_match_jax(routes, mode):
    """One call under `mode` in each package (one full UNet pass between
    the VAE encode and decode), replaying the port's table, on the same
    initial noise: the port's int8 convs split over the epilogues as the
    JAX gates split the same visits between the TPU kernel and the static
    conv, with no launch of the other mode's kernel; the attention and GEGLU
    kernels launch; the images agree at the int8 noise level."""
    key = jax.random.PRNGKey(42)
    module, name = JAX_KERNEL[mode]
    with pytest.MonkeyPatch.context() as mp, _counted_gates(mp) as gates:
        mp.setenv("D3ROMA_PALLAS_INTERPRET", "1")
        mp.setattr(module, name, functools.partial(getattr(module, name), interpret=True))
        ref = _with_quant(routes["jax_fast"], mode)(
            key, num_inference_steps=CALL_STEPS, num_intermediate_images=1,
            cond_channels="rgb+raw", rgb_images=jnp.asarray(routes["rgb"]),
            sim_disp=jnp.asarray(routes["raw"]))
        ref = np.asarray(ref.images, np.float32)
    x_init = np.array(jax.random.normal(jax.random.split(key)[1], routes["latent_shape"],
                                        jnp.float32))
    port = routes["port"]
    port.act_scales = routes["scales"]
    port.set_quant(mode)
    before = _port_counts()
    got = port(num_inference_steps=CALL_STEPS, num_intermediate_images=1,
               cond_channels="rgb+raw", rgb_images=torch.from_numpy(routes["rgb"]),
               sim_disp=torch.from_numpy(routes["raw"]), latents=torch.from_numpy(x_init))
    launches = {k: v - before[k] for k, v in _port_counts().items()}
    kernel, other = KERNEL_EPILOGUE[mode], KERNEL_EPILOGUE[MODES[1 - MODES.index(mode)]]
    assert gates["kernel"] > 0 and gates["static"] > 0, gates
    assert (launches[f"conv_{kernel}"], launches["conv_xla"], launches[f"conv_{other}"]) \
        == (gates["kernel"], gates["static"], 0), (mode, launches, gates)
    assert launches["attention"] > 0 and launches["geglu"] > 0
    err = np.abs(got.images.numpy() - ref)
    assert np.mean(np.abs(ref) < 0.999) > 0.5
    assert err.max() <= 0.2 and err.mean() <= 3e-2, (mode, err.max(), err.mean())
