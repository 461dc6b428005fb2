"""The latency path with the fused self-attention: `fast_inference("latency")`
(bf16, no int8) then `set_kernels(use_flash_attention="fused")`, the JAX
bench's BENCH_QUANT=0 BENCH_FLASH=4, in the port against the JAX pipeline on
the same weights, conditions and initial noise.

The tiny UNet has head dim 64, a 16x64 latent level (1024 tokens, the flash
route's threshold) and a 8x32 one below it. The flagship's bf16 fused gate
refuses its 3600-token sites (their score row overflows it) and admits its
920-token ones; at these widths it would admit every site, so both
packages' gates are narrowed alike to refuse the 1024-token level. Those
sites then take the flash route: the port's whole-row kernel, and in JAX,
whose flash route is TPU-only, XLA's attention off the TPU. The 8x32 level
(the mid block) takes the fused kernel on both sides (interpret-mode Pallas
in JAX). test_torch_attention_fused_bf16.py holds the real gate's
decisions at the flagship sites.

Tolerances as in test_torch_pipeline.py's bf16 latency test: bf16 rounds at
different points in the two packages (2^-8 relative per rounding), and the
differences add up over the layers: 5e-2 of max |output| on one UNet
forward; 0.1 max and 1e-2 mean on the final images in [-1, 1].
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3roma_tpu.ops.pallas as jax_pallas
import d3roma_tpu_torch.models.layers as port_layers
from d3roma_tpu.guidance import FlowGuidance
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.models.torch_import import unet_torch_to_flax, vae_torch_to_flax
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.pipelines import GuidedLatentDiffusionPipeline as JaxPipeline
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
from d3roma_tpu_torch.ops.kernels import fused_self_attention_bf16, geglu_ff, mha_attention
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec
from torch_port_utils import SCHEDULE, TINY_UNET, TINY_VAE, randn, randomize_, state_dict_numpy

TINY_A = dict(TINY_UNET, block_out_channels=(64, 128), attention_head_dim=64)
IMAGE_HW = (32, 128)
LATENT_HW = (16, 64)
BATCH = 2
STEPS = 2
# kernel calls of one UNet forward: the mid block's self-attention on the
# fused kernel; down block 0's and up block 1's two at the 1024-token level
# on the flash route (the whole-row kernel); a fused GEGLU in each of the 4
# transformer blocks
PER_FORWARD = {"fused": 1, "attention": 3, "geglu": 4}


def _counts():
    return {"fused": fused_self_attention_bf16.launches, "attention": mha_attention.launches,
            "geglu": geglu_ff.launches}


@pytest.fixture(scope="module", autouse=True)
def narrowed_gate():
    """Both packages' fused-attention gates, refusing the 1024-token level."""
    with pytest.MonkeyPatch.context() as mp:
        for module, real in ((jax_pallas, jax_pallas.fused_attention_supported),
                             (port_layers, port_layers.fused_attention_supported)):
            def gate(n, c, head_dim, itemsize=1, _real=real):
                return n < port_layers.FLASH_MIN_SEQ and _real(n, c, head_dim, itemsize)
            mp.setattr(module, "fused_attention_supported", gate)
        yield


@pytest.fixture(scope="module")
def latency_fused():
    unet = randomize_(UNet2DCondition(**TINY_A, device="cpu"), 0)
    vae = randomize_(AutoencoderKL(**TINY_VAE, device="cpu"), 1)
    text_embed = randn(2, 1, 2, TINY_A["cross_attention_dim"])
    h, w = IMAGE_HW
    rgb = randn(3, BATCH, h, w, 3, scale=0.5)
    raw = np.abs(randn(4, BATCH, h, w, 1, scale=0.5))
    jax_pipe = JaxPipeline(
        unet=JaxUNet(**TINY_A),
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
    jax_fast = jax_pipe.fast_inference("latency")
    jax_fast = dataclasses.replace(
        jax_fast, unet=dataclasses.replace(jax_fast.unet, use_flash_attention="fused"))
    port = GuidedLatentDiffusionPipeline(
        unet=unet, vae=vae, text_embed=torch.from_numpy(text_embed),
        spec=SamplerSpec("my_ddim", ScheduleConfig(**SCHEDULE)),
        normalizer=Normalizer(ssi=False, mode="average", num_chs=1,
                              ch_bounds=(128.0,), ch_gammas=(1.0,)),
        device="cpu").fast_inference("latency")
    port.unet.set_kernels(use_flash_attention="fused")
    return port, jax_fast, rgb, raw


def test_unet_forward_matches_jax(latency_fused, monkeypatch):
    port, jax_fast, _, _ = latency_fused
    monkeypatch.setenv("D3ROMA_PALLAS_INTERPRET", "1")
    calls = {"fused": 0}
    real = jax_pallas.fused_self_attention

    def counted(*a, **k):
        calls["fused"] += 1
        return real(*a, **k)

    monkeypatch.setattr(jax_pallas, "fused_self_attention", counted)
    x = randn(5, BATCH, *LATENT_HW, TINY_A["in_channels"])
    ctx = np.broadcast_to(np.asarray(jax_fast.text_embed), (BATCH, 2, 16))
    ref = np.asarray(jax.jit(jax_fast.unet.apply)(
        {"params": jax_fast.unet_params}, jnp.asarray(x), jnp.int32(741), jnp.asarray(ctx)),
        np.float32)
    before = _counts()
    with torch.no_grad():
        out = port.unet(torch.from_numpy(x), 741, torch.from_numpy(np.array(ctx)))
    assert {k: _counts()[k] - before[k] for k in before} == PER_FORWARD
    assert calls["fused"] == PER_FORWARD["fused"]
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= 5e-2 * np.abs(ref).max()


def test_call_matches_jax(latency_fused, monkeypatch):
    port, jax_fast, rgb, raw = latency_fused
    monkeypatch.setenv("D3ROMA_PALLAS_INTERPRET", "1")
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_fast(key, num_inference_steps=STEPS, num_intermediate_images=1,
                              cond_channels="rgb+raw", rgb_images=jnp.asarray(rgb),
                              sim_disp=jnp.asarray(raw)).images, np.float32)
    _, k_init = jax.random.split(key)
    x_init = np.array(jax.random.normal(k_init, (BATCH, *LATENT_HW, 4), jnp.float32))
    before = _counts()
    got = port(num_inference_steps=STEPS, num_intermediate_images=1, cond_channels="rgb+raw",
               rgb_images=torch.from_numpy(rgb), sim_disp=torch.from_numpy(raw),
               latents=torch.from_numpy(x_init))
    assert {k: _counts()[k] - before[k] for k in before} == {
        k: STEPS * v for k, v in PER_FORWARD.items()}
    assert np.mean(np.abs(ref) < 0.999) > 0.5
    err = np.abs(got.images.numpy() - ref)
    assert err.max() <= 0.1 and err.mean() <= 1e-2, (err.max(), err.mean())
