"""The int8 modes beside the static ones, as the JAX bench selects them:
BENCH_QUANT=1 (`quantize_int8()`: dynamic int8 in the UNet and the VAE),
"dense" (dynamic int8 at the dense layers only) and "wino" (bf16 Winograd
at the stride-1 3x3 convs inside the liveness cap, float elsewhere), each
with the bench's kernels and DeepCache interval 2 at depth 2, in the port
against the JAX pipeline on the same weights, conditions and initial noise.

One call each (pattern "FS": one full and one shallow UNet pass, one
encode, one decode). The JAX calls are counted at trace time, the port's
by its wrappers: every dynamic int8 dense and conv site, every whole-row
attention site (int8 under True, bf16 under "dense" and "wino", none at the
VAE under "dense" and "wino") and every Winograd site must match, the fused
self-attention and the fused GEGLU must not run under any of the three.
Under "wino" the JAX package runs the XLA formulation on the CPU at every
Winograd site (its fused kernel is TPU-only), the port the Winograd
kernel's plain version where `pick_config` admits the batch chunk (on the
TPU, the fused kernel's sites) and the XLA formulation elsewhere: the two
must split the JAX sites by that gate.

Image bounds: under True and "dense", the int8 noise level (as in
test_torch_pipeline.py: every int8 op is exact per op, test_torch_dynamic_
quant.py, but a last-place difference in the float ops between them moves a
value by one quantum): 0.2 max, 3e-2 mean on images in [-1, 1]. Under
"wino" (no int8): the kernel's plain version rounds x to bf16 where the XLA
formulation keeps fp32, 2e-2 max, 2e-3 mean."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3roma_tpu.models.layers as jax_layers
import d3roma_tpu.ops.pallas as jax_pallas
import d3roma_tpu.ops.winograd as jax_wino
from d3roma_tpu.guidance import FlowGuidance
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.models.torch_import import unet_torch_to_flax, vae_torch_to_flax
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.ops.pallas.winograd_fused import pick_config as jax_pick_config
from d3roma_tpu.pipelines import GuidedLatentDiffusionPipeline as JaxPipeline
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
from d3roma_tpu_torch.models import layers as port_layers
from d3roma_tpu_torch.ops import winograd as port_wino
from d3roma_tpu_torch.ops.kernels import (
    conv3x3_winograd,
    fused_self_attention_bf16,
    fused_self_attention_int8,
    geglu_ff,
    geglu_ff_int8,
    mha_attention,
    mha_attention_int8,
)
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec
from torch_port_utils import IMAGE_HW, SCHEDULE, TINY_UNET3, TINY_VAE, randn, randomize_, \
    state_dict_numpy

STEPS = 2
MODES = {"all": True, "dense": "dense", "wino": "wino"}
BOUNDS = {"all": (0.2, 3e-2), "dense": (0.2, 3e-2), "wino": (2e-2, 2e-3)}


@pytest.fixture(scope="module")
def pipes():
    unet = randomize_(UNet2DCondition(**TINY_UNET3, device="cpu"), 0)
    vae = randomize_(AutoencoderKL(**TINY_VAE, device="cpu"), 1)
    text_embed = randn(2, 1, 2, TINY_UNET3["cross_attention_dim"])
    h, w = IMAGE_HW
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
                                 ch_bounds=(128.0,), ch_gammas=(1.0,))).deepcache(2, depth=2)
    port = GuidedLatentDiffusionPipeline(
        unet=unet, vae=vae, text_embed=torch.from_numpy(text_embed),
        spec=SamplerSpec("my_ddim", ScheduleConfig(**SCHEDULE)),
        normalizer=Normalizer(ssi=False, mode="average", num_chs=1,
                              ch_bounds=(128.0,), ch_gammas=(1.0,)),
        device="cpu").deepcache(2, depth=2)
    return dict(jax=jax_pipe, port=port, rgb=randn(3, 2, h, w, 3, scale=0.5),
                raw=np.abs(randn(4, 2, h, w, 1, scale=0.5)), latent_shape=(2, h // 2, w // 2, 4))


def _jax_for(jax_pipe, mode):
    """The JAX bench's selection: quantize_int8() for "1", else the mode set
    on the UNet and the VAE."""
    if mode == "all":
        return jax_pipe.quantize_int8()
    q = MODES[mode]
    return dataclasses.replace(jax_pipe, unet=dataclasses.replace(jax_pipe.unet, quant=q),
                               vae=dataclasses.replace(jax_pipe.vae, quant=q))


def _port_for(port, mode):
    return port.quantize_int8() if mode == "all" else port.set_quant(MODES[mode])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_matches_jax(pipes, mode):
    calls = {"dense": 0, "conv": 0, "attention_int8": 0, "attention": 0, "wino_fused": 0,
             "wino_xla": 0, "fused": 0}

    def count(key):
        calls[key] += 1

    key = jax.random.PRNGKey(42)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("D3ROMA_PALLAS_INTERPRET", "1")
        for name, k in (("int8_dot_general", "dense"), ("int8_conv_general_dilated", "conv")):
            mp.setattr(jax_layers, name, lambda *a, _r=getattr(jax_layers, name), _k=k, **kw: (
                count(_k), _r(*a, **kw))[1])
        mp.setattr(jax_pallas, "mha_attention", lambda *a, _r=jax_pallas.mha_attention, **kw: (
            count("attention_int8" if kw.get("quant") == "int8" else "attention"),
            _r(*a, **kw))[1])
        for name in ("fused_self_attention", "geglu_ff"):
            mp.setattr(jax_pallas, name, lambda *a, _r=getattr(jax_pallas, name), **kw: (
                count("fused"), _r(*a, **kw))[1])
        mp.setattr(jax_wino, "_wino_dispatch_single", lambda x, w, _r=jax_wino._wino_dispatch_single: (
            count("wino_fused" if jax_pick_config(x.shape) is not None else "wino_xla"),
            _r(x, w))[1])
        ref = _jax_for(pipes["jax"], mode)(
            key, num_inference_steps=STEPS, num_intermediate_images=1, cond_channels="rgb+raw",
            rgb_images=jnp.asarray(pipes["rgb"]), sim_disp=jnp.asarray(pipes["raw"]))
        ref = np.asarray(ref.images, np.float32)
    x_init = np.array(jax.random.normal(jax.random.split(key)[1], pipes["latent_shape"],
                                        jnp.float32))

    got_calls = dict.fromkeys(calls, 0)
    kernels = {"attention_int8": mha_attention_int8, "attention": mha_attention,
               "wino_fused": conv3x3_winograd}
    fused = (fused_self_attention_int8, fused_self_attention_bf16, geglu_ff, geglu_ff_int8)
    before = {k: fn.launches for k, fn in kernels.items()}
    before_fused = sum(fn.launches for fn in fused)
    port = _port_for(pipes["port"], mode)
    with pytest.MonkeyPatch.context() as mp:
        for name, k in (("int8_linear_dynamic", "dense"), ("int8_conv_dynamic", "conv")):
            mp.setattr(port_layers, name, lambda *a, _r=getattr(port_layers, name), _k=k, **kw: (
                got_calls.__setitem__(_k, got_calls[_k] + 1), _r(*a, **kw))[1])
        mp.setattr(port_wino, "winograd_conv3x3", lambda *a, _r=port_wino.winograd_conv3x3, **kw: (
            got_calls.__setitem__("wino_xla", got_calls["wino_xla"] + 1), _r(*a, **kw))[1])
        got = port(num_inference_steps=STEPS, num_intermediate_images=1,
                   cond_channels="rgb+raw", rgb_images=torch.from_numpy(pipes["rgb"]),
                   sim_disp=torch.from_numpy(pipes["raw"]), latents=torch.from_numpy(x_init))
    got_calls.update({k: fn.launches - before[k] for k, fn in kernels.items()})
    got_calls["fused"] = sum(fn.launches for fn in fused) - before_fused
    assert got_calls == calls, (mode, got_calls, calls)
    expect_int8 = mode != "wino"
    assert (calls["dense"] > 0) == expect_int8 and (calls["conv"] > 0) == (mode == "all")
    assert (calls["attention_int8"] > 0) == (mode == "all") and calls["fused"] == 0
    assert (calls["wino_fused"] > 0 and calls["wino_xla"] > 0) == (mode == "wino")
    err = np.abs(got.images.numpy() - ref)
    assert np.mean(np.abs(ref) < 0.999) > 0.5
    max_err, mean_err = BOUNDS[mode]
    assert err.max() <= max_err and err.mean() <= mean_err, (mode, err.max(), err.mean())


def test_fast_inference_dense_is_the_jax_configuration(pipes):
    """fast_inference("dense"): bf16 weights, the whole-row attention at
    self-attention sites, the fused GEGLU flag set (the dynamic mode then
    runs it unfused), "dense" in the UNet and the VAE, as the JAX package's
    replaced copy has it."""
    ref = pipes["jax"].fast_inference("dense")
    port = GuidedLatentDiffusionPipeline(
        unet=UNet2DCondition(**TINY_UNET3, device="cpu"),
        vae=AutoencoderKL(**TINY_VAE, device="cpu"), text_embed=torch.zeros(1, 2, 16),
        spec=SamplerSpec("my_ddim", ScheduleConfig(**SCHEDULE)),
        normalizer=Normalizer(ssi=False, mode="average", num_chs=1, ch_bounds=(128.0,),
                              ch_gammas=(1.0,)), device="cpu").fast_inference("dense")
    assert (port.unet.quant, port.vae.quant) == (ref.unet.quant, ref.vae.quant) == ("dense",) * 2
    assert port.unet.use_flash_attention == ref.unet.use_flash_attention == "pallas-self"
    assert port.unet.fused_ff == ref.unet.fused_ff is True
    assert ref.unet.dtype == jnp.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in port.unet.parameters())
    assert port.quantize_int8() is port and (port.unet.quant, port.vae.quant) == (True, True)
