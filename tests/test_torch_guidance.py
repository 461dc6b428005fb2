"""Test-time guidance in the port (d3roma_tpu_torch/guidance.py, ops/warp.py,
ops/losses.py, the latent pipeline's guidance and add_noise_rgb hooks)
against the JAX package on the CPU, with one set of numpy-seeded inputs and
weights (the tiny models of torch_port_utils).

Tolerances: the stateless ops (warp, SSIM, VLB helpers, photometric loss)
and their gradients within OP_RTOL of the reference's largest magnitude
(fp32, the same arithmetic in another order); the latent guidance function
(Adam through the tiny VAE decoder) within GUIDE_ATOL in fp32; under
dynamic int8 its gradient within INT8_GRAD_RTOL (the gradient reaches the
latent through the absmax scales); the guided pipeline at the int8 noise
level of tests/test_torch_pipeline.py (INT8_MAX / INT8_MEAN) under dynamic
int8, add_noise_rgb's within IMAGE_ATOL in fp32, D3RoMa's depth within
DEPTH_RTOL; under static int8 guided and
unguided are bit-equal in both packages (every path to the decode crosses
a fixed-scale rounding, whose derivative is zero); at the VAE's int8
whole-row attention site both packages refuse a gradient. The evaluation
loop's guidance-weight sweep with a guided weight (SSI least squares inside
the guidance) meets tests/test_torch_evaluate.py's per-sample tolerances."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3roma_tpu.guidance as jax_guidance
import d3roma_tpu.ops.losses as jax_losses
import d3roma_tpu.ops.warp as jax_warp
from d3roma_tpu.guidance import FlowGuidance as JaxGuidance
from d3roma_tpu.inference import D3RoMa as JaxD3RoMa
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.models import decode_latent as jax_decode_latent
from d3roma_tpu.models.torch_import import unet_torch_to_flax, vae_torch_to_flax
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.pipelines import GuidedLatentDiffusionPipeline as JaxPipeline
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu.utils.camera import Realsense as JaxRealsense
from d3roma_tpu_torch import guidance
from d3roma_tpu_torch.guidance import FlowGuidance, frozen_parameters, grad_of
from d3roma_tpu_torch.inference import D3RoMa
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition, decode_latent
from d3roma_tpu_torch.ops import losses, warp
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec
from d3roma_tpu_torch.utils.camera import Realsense
import test_torch_evaluate as evaluate_tests
from test_torch_evaluate import pipelines, tree  # noqa: F401 (fixtures)
from test_torch_inference import COMMON, _frame, _jax_call_keys, _Replay
from torch_port_utils import SCHEDULE, TINY_UNET, TINY_VAE, randn, randomize_, state_dict_numpy

OP_RTOL = 1e-5
GUIDE_ATOL = 1e-5
INT8_GRAD_RTOL = 1e-4
IMAGE_ATOL = 1e-4
INT8_MAX, INT8_MEAN = 0.2, 3e-2
DEPTH_RTOL = 1e-4
STEPS = 2
GUIDE = dict(flow_guidance_weight=1.0, flow_guidance_mode="gradient", num_opt_steps=2,
             opt_lr=0.05)
NORM = dict(ssi=False, mode="average", num_chs=1, ch_bounds=(128.0,), ch_gammas=(1.0,))
# 16x32 images: a 128-token latent, below every attention kernel's 512-token
# gate in both packages, so the VAE's attention is float and differentiable
HW = (16, 32)


def _close(ours, ref, rtol=OP_RTOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(ours, np.float32), ref, rtol=0,
                               atol=rtol * max(float(np.abs(ref).max()), 1e-12))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def test_warp_and_losses_match_jax():
    rs = np.random.RandomState(0)
    img = rs.standard_normal((2, 6, 9, 3)).astype(np.float32)
    # integer, fractional and out-of-image coordinates
    x = np.concatenate([rs.uniform(-2, 10, (2, 6, 5)), np.tile(np.arange(4.0), (2, 6, 1))],
                       axis=2).astype(np.float32)
    y = rs.uniform(-1.5, 6.5, (2, 6, 9)).astype(np.float32)
    _close(warp.bilinear_sample(_t(img), _t(x), _t(y)),
           jax_warp.bilinear_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    disp = rs.uniform(0, 4, (2, 6, 9)).astype(np.float32)
    disp[:, :, 0] = 2.0  # integer disparities
    w_ref = jax.grad(lambda d: jnp.sum(jax_warp.warp_right_to_left(jnp.asarray(img), d) ** 2))(
        jnp.asarray(disp))
    w_ours = grad_of(lambda d: torch.sum(warp.warp_right_to_left(_t(img), d) ** 2), _t(disp))
    _close(w_ours, w_ref)

    a, b = rs.uniform(-1, 1, (2, 7, 5, 3)), rs.uniform(-1, 1, (2, 7, 5, 3))
    _close(losses.ssim(_t(a), _t(b)), jax_losses.ssim(jnp.asarray(a, jnp.float32),
                                                      jnp.asarray(b, jnp.float32)))
    m1, v1, m2, v2 = (rs.standard_normal((4, 3)).astype(np.float32) for _ in range(4))
    _close(losses.normal_kl(_t(m1), _t(v1), _t(m2), _t(v2)),
           jax_losses.normal_kl(m1, v1, m2, v2))
    xs = np.concatenate([rs.uniform(-1, 1, 20), [-1.0, 1.0, -0.9995, 0.9995]]).astype(np.float32)
    # bins of probability well above fp32's resolution (a bin of ~1e-7 is
    # the difference of two cdf values near 1, its log moved by an ulp)
    means = (xs + rs.uniform(-0.05, 0.05, 24)).astype(np.float32)
    logs = rs.uniform(-3, -1, 24).astype(np.float32)
    _close(losses.discretized_gaussian_log_likelihood(_t(xs), means=_t(means), log_scales=_t(logs)),
           jax_losses.discretized_gaussian_log_likelihood(xs, means=means, log_scales=logs))
    _close(losses.approx_standard_normal_cdf(_t(xs)), jax_losses.approx_standard_normal_cdf(xs))
    t = np.array([0, 3, 9], np.int64)
    mse, lv = rs.uniform(0, 1, 3).astype(np.float32), rs.uniform(-5, 0, 10).astype(np.float32)
    _close(losses.mse_to_vlb(torch.from_numpy(t), _t(mse), _t(lv)),
           jax_losses.mse_to_vlb(jnp.asarray(t), mse, lv))


def test_photometric_matches_jax():
    rs = np.random.RandomState(1)
    left, right = (jnp.asarray(rs.uniform(0, 1, (1, 8, 12, 3)), jnp.float32) for _ in range(2))
    nd = rs.uniform(-1, 1, (1, 8, 12)).astype(np.float32)

    def unnorm(x):
        return (x + 1.0) * 2.0

    _close(guidance.photometric_loss(_t(nd) + 2.0, _t(left), _t(right)),
           jax_guidance.photometric_loss(jnp.asarray(nd) + 2.0, left, right))
    ref = jax_guidance.photometric_grad(jnp.asarray(nd), left, right, unnorm)
    assert float(jnp.sqrt(jnp.sum(ref ** 2))) == pytest.approx(1.0, rel=1e-5)  # clipped
    _close(guidance.photometric_grad(_t(nd), _t(left), _t(right), unnorm), ref)
    kw = dict(num_iters=4, lr=1e-2, alpha=1e-2)
    ref = jax_guidance.photometric_optimize(jnp.asarray(nd), left, right, unnorm, **kw)
    assert float(jnp.abs(ref - nd).max()) > 1e-4
    _close(guidance.photometric_optimize(_t(nd), _t(left), _t(right), unnorm, **kw), ref)


@pytest.fixture(scope="module")
def vae_pair():
    vae = randomize_(AutoencoderKL(**TINY_VAE, device="cpu"), 1)
    params = jax.tree_util.tree_map(jnp.asarray, vae_torch_to_flax(state_dict_numpy(vae)))
    return vae, params


def _decoders(vae_pair, quant):
    vae, params = vae_pair
    vae.set_quant(quant)
    jvae = JaxVAE(**TINY_VAE, quant=quant)

    def jax_decode(z):
        return jax_decode_latent(
            lambda x, method: jvae.apply({"params": params}, x, method=method), z)

    def port_decode(z):
        with frozen_parameters(vae):
            return decode_latent(vae, z)

    return jax_decode, port_decode


def _raw_depth(hw, seed=5):
    raw = np.abs(randn(seed, 2, hw[0], hw[1], 1, scale=30.0))
    raw[raw < 5] = 0.0  # sensor holes
    return raw


@pytest.mark.parametrize("quant", [False, True])
def test_latent_guidance_fn_matches_jax(vae_pair, quant):
    """Adam on the latent through the tiny decoder, three steps in fp32;
    under dynamic int8 the loss gradient the Adam steps take."""
    jax_decode, port_decode = _decoders(vae_pair, quant)
    raw = _raw_depth(HW)
    z = randn(6, 2, HW[0] // 2, HW[1] // 2, 4)
    jn, pn = JaxNormalizer(**NORM), Normalizer(**NORM)
    if quant:
        mask = (raw > 0).astype(np.float32)

        def jax_loss(latent):
            return jnp.mean(jnp.abs(jn.denormalize(jax_decode(latent)) * mask - raw * mask))

        g_ref = jax.jit(jax.grad(jax_loss))(jnp.asarray(z))
        g = grad_of(lambda latent: torch.mean(torch.abs(
            pn.denormalize(port_decode(latent)) * _t(mask) - _t(raw * mask))), _t(z))
        assert float(jnp.abs(g_ref).max()) > 0
        _close(g, g_ref, INT8_GRAD_RTOL)
    else:
        gkw = dict(GUIDE, num_opt_steps=3)
        jfn = JaxGuidance(**gkw).make_latent_guidance_fn(jax_decode, jn.denormalize,
                                                         jnp.asarray(raw))
        ref = np.asarray(jax.jit(lambda latent: jfn(latent, 0))(jnp.asarray(z)))
        pfn = FlowGuidance(**gkw).make_latent_guidance_fn(port_decode, pn.denormalize, _t(raw))
        with torch.no_grad():
            out = pfn(_t(z), 0)
        assert not out.requires_grad and np.abs(ref - z).max() > 0.01
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=GUIDE_ATOL)
    vae_pair[0].set_quant(False)


def test_int8_attention_refuses_a_gradient(vae_pair, monkeypatch):
    """quant=True at the VAE's int8 whole-row attention site (a 512-token
    latent, head width 64): the JAX kernel (interpret mode) cannot be
    differentiated, and neither can the port's."""
    monkeypatch.setenv("D3ROMA_PALLAS_INTERPRET", "1")
    jax_decode, port_decode = _decoders(vae_pair, True)
    z = randn(7, 1, 16, 32, 4)
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(lambda latent: jnp.mean(jax_decode(latent)))(jnp.asarray(z))
    with pytest.raises(RuntimeError, match="mha_attention_int8 has no gradient"):
        grad_of(lambda latent: torch.mean(port_decode(latent)), _t(z))
    # static int8: no gradient reaches the site, and none comes out
    vae_pair[0].set_quant("static")
    assert not grad_of(lambda latent: torch.mean(port_decode(latent)), _t(z)).any()
    vae_pair[0].set_quant(False)


@pytest.fixture(scope="module")
def pipes():
    unet = randomize_(UNet2DCondition(**TINY_UNET, device="cpu"), 0)
    vae = randomize_(AutoencoderKL(**TINY_VAE, device="cpu"), 1)
    text_embed = randn(2, 1, 2, TINY_UNET["cross_attention_dim"])
    port = GuidedLatentDiffusionPipeline(
        unet=unet, vae=vae, text_embed=torch.from_numpy(text_embed),
        spec=SamplerSpec("my_ddim", ScheduleConfig(**SCHEDULE)), normalizer=Normalizer(**NORM),
        device="cpu", guidance=FlowGuidance(**GUIDE))
    jax_pipe = JaxPipeline(
        unet=JaxUNet(**TINY_UNET),
        unet_params=jax.tree_util.tree_map(jnp.asarray,
                                           unet_torch_to_flax(state_dict_numpy(unet))),
        vae=JaxVAE(**TINY_VAE),
        vae_params=jax.tree_util.tree_map(jnp.asarray, vae_torch_to_flax(state_dict_numpy(vae))),
        text_embed=jnp.asarray(text_embed),
        spec=JaxSamplerSpec("my_ddim", JaxScheduleConfig(**SCHEDULE)),
        guidance=JaxGuidance(**GUIDE), normalizer=JaxNormalizer(**NORM))
    h, w = HW
    rgb = randn(3, 2, h, w, 3, scale=0.5)
    raw = np.abs(randn(4, 2, h, w, 1, scale=0.5))
    return port, jax_pipe, rgb, raw, _raw_depth(HW)


def _run(pipe, is_jax, rgb, raw, raw_depth=None, key=jax.random.PRNGKey(11), **kw):
    common = dict(num_inference_steps=STEPS, num_intermediate_images=1,
                  cond_channels="rgb+raw")
    if raw_depth is not None:
        norm = (JaxNormalizer if is_jax else Normalizer)(**NORM)
        kw.update(raw_depth=raw_depth if is_jax else _t(raw_depth),
                  denormer=norm.denormalize)
    if is_jax:
        return np.asarray(pipe(key, rgb_images=jnp.asarray(rgb), sim_disp=jnp.asarray(raw),
                               **common, **kw).images, np.float32)
    _, k_init = jax.random.split(key)
    x_init = np.array(jax.random.normal(k_init, (2, HW[0] // 2, HW[1] // 2, 4), jnp.float32))
    with torch.no_grad():
        return pipe(rgb_images=_t(rgb), sim_disp=_t(raw), latents=_t(x_init), **common,
                    **kw).images.float().numpy()


def test_guided_pipeline_matches_jax_under_dynamic_int8(pipes):
    """The guided latent pipeline under quantize_int8() (its fp32 form is
    held to the JAX one by the evaluation sweep below and by D3RoMa's)."""
    port, jax_pipe, rgb, raw, raw_depth = pipes
    jax_pipe = jax_pipe.quantize_int8()
    port.unet.set_quant(True)
    port.vae.set_quant(True)
    try:
        ref = _run(jax_pipe, True, rgb, raw, raw_depth)
        ours = _run(port, False, rgb, raw, raw_depth)
        unguided = _run(port, False, rgb, raw)
    finally:
        port.unet.set_quant(False)
        port.vae.set_quant(False)
    assert np.mean(np.abs(ref) < 0.999) > 0.5
    err = np.abs(ours - ref)
    assert err.max() <= INT8_MAX and err.mean() <= INT8_MEAN, (err.max(), err.mean())
    # the guidance moved the result well beyond the difference
    assert np.abs(ours - unguided).max() > 2 * err.max()


def test_static_int8_guidance_is_a_no_op(pipes, vae_pair):
    """Static int8 (fast_inference("throughput")): the port's guided call
    bit-equal to its unguided one (plain versions on the CPU); in the JAX
    package the loss gradient through the static VAE is exactly zero."""
    port, _, rgb, raw, raw_depth = pipes
    try:
        port.unet.set_quant("static")
        port.vae.set_quant("static")
        guided = _run(port, False, rgb, raw, raw_depth)
        plain = _run(port, False, rgb, raw)
    finally:
        port.unet.set_quant(False)
        port.vae.set_quant(False)
    assert np.array_equal(guided, plain)
    jax_decode, port_decode = _decoders(vae_pair, "static")
    z = randn(8, 2, HW[0] // 2, HW[1] // 2, 4)
    g = jax.jit(jax.grad(lambda latent: jnp.mean(jax_decode(latent))))(jnp.asarray(z))
    assert not np.asarray(g).any()
    assert not grad_of(lambda latent: torch.mean(port_decode(latent)), _t(z)).any()
    vae_pair[0].set_quant(False)


def test_add_noise_rgb_matches_jax(pipes):
    """add_noise_rgb on the latent pipeline: the JAX rgb noise (the third key
    of each step's split) replayed as rgb_noise."""
    port, jax_pipe, rgb, raw, _ = pipes
    key = jax.random.PRNGKey(3)
    ref = _run(jax_pipe, True, rgb, raw, key=key, add_noise_rgb=True)
    k, rgb_noise = jax.random.split(key)[0], []
    for _ in range(STEPS):
        k, _, k_rgb = jax.random.split(k, 3)
        rgb_noise.append(torch.from_numpy(np.array(jax.random.normal(
            k_rgb, (2, HW[0] // 2, HW[1] // 2, 4), jnp.float32))))
    ours = _run(port, False, rgb, raw, key=key, add_noise_rgb=True, rgb_noise=rgb_noise)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=IMAGE_ATOL)
    assert np.abs(ours - _run(port, False, rgb, raw, key=key)).max() > 5 * IMAGE_ATOL


def test_d3roma_guided_through_denorm_builder(tmp_path, monkeypatch):
    """D3RoMa with a guided pipeline directory (gradient mode, SSI least
    squares): the pipeline takes the raw disparity, the config's
    denormalization as denorm_builder and the mask, as the JAX D3RoMa."""
    monkeypatch.chdir(tmp_path)
    unet = randomize_(UNet2DCondition(**TINY_UNET, device="cpu"), 0)
    vae = randomize_(AutoencoderKL(**TINY_VAE, device="cpu"), 1)
    JaxPipeline(
        unet=JaxUNet(**TINY_UNET),
        unet_params=jax.tree_util.tree_map(jnp.asarray,
                                           unet_torch_to_flax(state_dict_numpy(unet))),
        vae=JaxVAE(**TINY_VAE),
        vae_params=jax.tree_util.tree_map(jnp.asarray, vae_torch_to_flax(state_dict_numpy(vae))),
        text_embed=jnp.asarray(randn(2, 1, 2, 16)),
        spec=JaxSamplerSpec("my_ddim", JaxScheduleConfig(num_train_timesteps=1000)),
        guidance=JaxGuidance(**GUIDE), normalizer=JaxNormalizer(**NORM)).save_pretrained(
            str(tmp_path / "pipe"))
    ov = ["task=eval_ldm_mixed_rgb+raw", f"task.resume_pretrained={tmp_path / 'pipe'}",
          "task.ssi=true", "task.safe_ssi=false", "task.flow_guidance_mode=gradient"] + COMMON
    ref = JaxD3RoMa(ov, JaxRealsense.default_real("fxm"), variant="rgb+raw")
    ours = D3RoMa(ov, Realsense.default_real("fxm"), variant="rgb+raw", device="cpu")
    assert ours.pipeline.guidance == FlowGuidance(**GUIDE)
    seen = {}

    class Spy:  # records the pipeline call's arguments
        def __init__(self, pipe):
            self.pipe = pipe

        def __getattr__(self, name):
            return getattr(self.pipe, name)

        def __call__(self, **kw):
            seen.update(kw)
            return self.pipe(**kw)

    ours.pipeline = _Replay(Spy(ours.pipeline), _jax_call_keys(1))
    rgb, raw = _frame(0)
    depth = ours.infer_with_rgb_raw(rgb, raw)
    assert seen["denorm_builder"] is ours._denorm_builder
    assert tuple(seen["raw_depth"].shape) == tuple(seen["denorm_mask"].shape) == (1, 32, 64, 1)
    want = ref.infer_with_rgb_raw(rgb, raw)
    np.testing.assert_allclose(depth, want, rtol=DEPTH_RTOL, atol=0)


def test_eval_sweep_with_guidance_matches_jax(tree, pipelines, monkeypatch):
    """evaluate_dataset at flow_guidance_weights [1.0] (gradient mode, SSI
    least squares): the pipeline takes the padded raw disparity and the
    denormer, as the JAX loop passes them; the JAX noise replayed."""
    jax_pipe, port = pipelines
    gkw = dict(GUIDE, flow_guidance_weight=1.0)
    jax_pipe = dataclasses.replace(jax_pipe, guidance=JaxGuidance(**gkw))
    guided = GuidedLatentDiffusionPipeline.__new__(GuidedLatentDiffusionPipeline)
    guided.__dict__.update(port.__dict__, guidance=FlowGuidance(**gkw))
    kw = dict(flow_guidance_weights=[1.0], ssi=True, safe_ssi=False, eval_num_batch=1)

    def replay(key, cfg):
        return evaluate_tests._Replay(guided, evaluate_tests._jax_keys(
            key, evaluate_tests.FRAMES // evaluate_tests.BATCH, 1, cfg.num_inference_rounds),
            factor=2)

    (ref, ref_stat), (ours, stat) = evaluate_tests._run_both(tree, jax_pipe, replay,
                                                             monkeypatch, **kw)
    assert ours.keys() == ref.keys() == {"disp", "depth"}
    assert len(ref_stat._recent["epe"]) == evaluate_tests.BATCH
    for k, vals in ref_stat._recent.items():
        if k in evaluate_tests.RATES:
            np.testing.assert_allclose(stat._recent[k], vals, rtol=0, atol=2e-3, err_msg=k)
        else:
            np.testing.assert_allclose(stat._recent[k], vals, rtol=1e-4, atol=0, err_msg=k)
