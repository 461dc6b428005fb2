"""The port's train step (training/train_step.py) against the JAX
package's `make_train_step`, at tiny sizes: the same weights, batch and
random draws (the JAX keys' draws replayed through the step's `draws`),
one and three AdamW steps, for every prediction type in the pixel and the
latent family and both timestep samplers (the loss-aware one from a
prefilled, warmed history, so its weights are not uniform).

Tolerances:
- loss, per-sample loss and recon_mae within 1e-5 relative, grad_norm
  within 1e-4 relative (float32 forward and backward passes that sum in
  another order: a few ulps of each activation);
- the sampler state: timesteps equal, histories within 1e-5 relative;
- the parameters after one and after three steps: within two learning
  rates a step for every element, and within 1e-3 of the learning rate
  times the number of steps for 99.9% of the elements outside the key
  projections' biases. AdamW divides each gradient element by its running
  RMS, so an element whose gradient is at the rounding level moves by up
  to the learning rate in either direction: the key biases' gradient is
  zero in exact arithmetic (the softmax does not change when every key
  moves by the same bias), and a few elements elsewhere sum to nearly
  zero. Everywhere else the update is the same to a few ulps.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.config import TrainingConfig as JaxConfig
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2D as JaxUNet2D
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.ops.resample import SamplerState as JaxSamplerState
from d3roma_tpu.ops.resample import loss_aware_weights as jax_weights
from d3roma_tpu.training import build_optimizer as jax_build_optimizer
from d3roma_tpu.training import create_train_state as jax_create_state
from d3roma_tpu.training import make_train_step as jax_make_step
from d3roma_tpu_torch.config import TrainingConfig
from d3roma_tpu_torch.models import (
    AutoencoderKL,
    UNet2D,
    UNet2DCondition,
    flax_unet2d_to_torch,
    flax_unet_to_torch,
    flax_vae_to_torch,
)
from d3roma_tpu_torch.ops.resample import SamplerState
from d3roma_tpu_torch.training import build_optimizer, create_train_state, make_train_step
from torch_port_utils import JaxKeyDraws, ReplayDraws, jax_step_draws, random_flax_tree

HW = (16, 16)
B = 4
T = 20
LR = 1e-3
UNET = dict(in_channels=12, out_channels=4, block_out_channels=(8, 16),
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
            attention_head_dim=8, cross_attention_dim=16, norm_groups=4)
UNET2D = dict(in_channels=5, out_channels=1, block_out_channels=(8, 16),
              down_block_types=("DownBlock2D", "AttnDownBlock2D"),
              up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1,
              attention_head_dim=8, norm_groups=4)
VAE = dict(block_out_channels=(4, 8), latent_channels=4, norm_groups=2)

# (family, prediction type, timestep sampler, extra config); each family
# runs both samplers, every prediction type runs in each family that has it
# (the JAX step masks "sample" at the image's size, so it is pixel-only;
# v_pred_depth decodes through the VAE, so it is latent-only)
CASES = {
    "pixel-sample-uniform": ("pixel", "sample", "uniform", dict(loss_type="l1")),
    "pixel-epsilon-loss_aware": ("pixel", "epsilon", "loss-second-moment",
                                 dict(noise_strategy="pyramid", clip_sample=False)),
    "pixel-v_prediction-uniform": ("pixel", "v_prediction", "uniform",
                                   dict(noise_rgb=True, clip_sample=False)),
    "ldm-v_prediction-loss_aware": ("ldm", "v_prediction", "loss-second-moment", dict()),
    "ldm-epsilon-uniform": ("ldm", "epsilon", "uniform", dict(loss_type="l1", noise_rgb=True)),
    "ldm-v_pred_depth-loss_aware": ("ldm", "v_pred_depth", "loss-second-moment",
                                    dict(noise_strategy="pyramid", clip_sample=True)),
}


def _configs(family, pred, sampler, extra):
    kw = dict(ldm=family == "ldm", depth_channels=4 if family == "ldm" else 1,
              cond_channels="rgb+raw", image_size=HW, divis_by=8, num_train_timesteps=T,
              beta_schedule="scaled_linear", beta_start=0.00085, beta_end=0.012,
              prediction_type=pred, noise_strategy="randn", loss_type="mse",
              train_batch_size=B, gradient_accumulation_steps=1, clip_grad_norm=1.0,
              learning_rate=LR, lr_warmup_steps=0, lr_scheduler="constant",
              clip_sample=False, timestep_sampler=sampler, noise_rgb=False)
    kw.update(extra)
    return JaxConfig(**kw), TrainingConfig(**kw)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    h, w = HW
    disp = rs.uniform(-1.1, 1.1, (B, h, w, 1)).astype(np.float32)
    return {
        "normalized_disp": disp,
        "sim_disp": (disp + 0.05 * rs.standard_normal(disp.shape)).astype(np.float32),
        "normalized_rgb": rs.uniform(-1, 1, (B, h, w, 3)).astype(np.float32),
        "left_image": rs.uniform(-1, 1, (B, h, w, 3)).astype(np.float32),
        "right_image": rs.uniform(-1, 1, (B, h, w, 3)).astype(np.float32),
        "mask": (rs.rand(B, h, w, 1) > 0.2).astype(np.float32),
    }


def _warm_history(seed=5, H=10):
    rs = np.random.RandomState(seed)
    return (rs.rand(T, H).astype(np.float32) * np.linspace(0.2, 2.0, T)[:, None].astype(np.float32),
            np.full((T,), H, np.int32))


def _models(family):
    if family == "ldm":
        unet = JaxUNet(**UNET)
        params = random_flax_tree(unet, 1, jnp.zeros((1, 8, 8, 12)), jnp.array([0]),
                                  jnp.zeros((1, 2, 16)))
        vae = JaxVAE(**VAE)
        vae_params = random_flax_tree(vae, 2, jnp.zeros((1, 16, 16, 3)))
        text = np.random.RandomState(3).standard_normal((1, 2, 16)).astype(np.float32)
        port_unet = UNet2DCondition(**UNET, remat=True, device="cpu")
        port_unet.load_state_dict(flax_unet_to_torch(params))
        port_vae = AutoencoderKL(**VAE, device="cpu").requires_grad_(False)
        port_vae.load_state_dict(flax_vae_to_torch(vae_params))
        return (unet, params, vae, vae_params, text), (port_unet, port_vae, torch.from_numpy(text))
    unet = JaxUNet2D(**UNET2D)
    params = random_flax_tree(unet, 1, jnp.zeros((1, 16, 16, 5)), jnp.array([0]))
    port_unet = UNet2D(**UNET2D, device="cpu")
    port_unet.load_state_dict(flax_unet2d_to_torch(params))
    return (unet, params, None, None, None), (port_unet, None, None)


@functools.lru_cache(maxsize=None)
def _run(case, steps=3):
    family, pred, sampler, extra = CASES[case]
    jcfg, pcfg = _configs(family, pred, sampler, extra)
    (unet, params, vae, vae_params, text), (punet, pvae, ptext) = _models(family)
    ldm = family == "ldm"
    tables = jcfg.schedule_config(train=True).tables()
    tx = jax_build_optimizer(jcfg, 10)
    jstate = jax_create_state(jcfg, params, 10, 0, tx=tx)
    hist, cnt = _warm_history()
    jstate = jstate.replace(sampler_state=JaxSamplerState(jnp.asarray(hist), jnp.asarray(cnt)))
    if ldm:
        step = jax.jit(jax_make_step(
            jcfg, lambda p, x, t, c: unet.apply({"params": p}, x, t, c), tx, tables,
            lambda p, x, method: vae.apply({"params": p}, x, method=method), jnp.asarray(text)))
    else:
        step = jax.jit(jax_make_step(jcfg, lambda p, x, t: unet.apply({"params": p}, x, t), tx,
                                     tables))

    opt = build_optimizer(pcfg, 10, list(punet.parameters()))
    pstate = create_train_state(pcfg, punet, 10, seed=0, optimizer=opt)
    pstate.sampler_state = SamplerState(torch.from_numpy(hist.copy()), torch.from_numpy(cnt.copy()))
    pstep = make_train_step(pcfg, punet, opt, pcfg.schedule_config(train=True).tables("cpu"),
                            vae=pvae, text_embed=ptext)

    batch = _batch()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    lat = (B, HW[0] // 2, HW[1] // 2, 4) if ldm else None
    noise_shape = lat if ldm else (B,) + HW + (1,)
    rgb_shape = (lat if ldm else (B,) + HW + (3,)) if pcfg.noise_rgb else None
    out = []
    for i in range(steps):
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        probs = None
        if sampler != "uniform":
            w = np.array(jax_weights(jstate.sampler_state))
            probs = w / w.sum()
        draws = ReplayDraws(jax_step_draws(key, noise_shape, pcfg.noise_strategy, B, T, probs,
                                           rgb_shape))
        jstate, jm = step(jstate, jbatch, key, vae_params) if ldm else step(jstate, jbatch, key)
        pm = pstep(pstate, tbatch, draws)
        assert not draws.arrays  # every replayed draw consumed
        out.append((jm, pm, jax.tree.map(np.asarray, jstate.params),
                    {k: v.clone() for k, v in punet.state_dict().items()}))
    return jstate, pstate, out


def _rel(a, b, rtol, name):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol,
                               atol=0, err_msg=name)


def _check_params(family, jparams, ours, steps):
    convert = flax_unet_to_torch if family == "ldm" else flax_unet2d_to_torch
    ref = convert(jparams)
    assert ours.keys() == ref.keys()
    diffs = {k: np.abs(ours[k].numpy() - ref[k].numpy()).ravel() for k in ref}
    every = np.concatenate(list(diffs.values()))
    assert every.max() <= 2 * LR * steps, every.max()
    rest = np.concatenate([d for k, d in diffs.items() if not k.endswith("to_k.bias")])
    assert np.quantile(rest, 0.999) <= 1e-3 * LR * steps, np.quantile(rest, 0.999)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(case):
    """Three steps; metrics after each, parameters after the first and
    the third."""
    jstate, pstate, out = _run(case)
    for i, (jm, pm, jparams, ours) in enumerate(out):
        np.testing.assert_array_equal(pm["timesteps"].numpy(), np.array(jm["timesteps"]))
        _rel(float(pm["loss"]), float(jm["loss"]), 1e-5, "loss")
        _rel(pm["per_sample_loss"].numpy(), np.array(jm["per_sample_loss"]), 1e-5, "per_sample")
        _rel(float(pm["grad_norm"]), float(jm["grad_norm"]), 1e-4, "grad_norm")
        assert ("recon_mae" in pm) == ("recon_mae" in jm)
        if "recon_mae" in jm:
            _rel(float(pm["recon_mae"]), float(jm["recon_mae"]), 1e-5, "recon_mae")
        _rel(float(pm["t_mean"]), float(jm["t_mean"]), 1e-6, "t_mean")
        if i in (0, 2):
            _check_params(CASES[case][0], jparams, ours, i + 1)
    assert int(pstate.step) == int(jstate.step) == 3
    np.testing.assert_array_equal(pstate.sampler_state.loss_counts.numpy(),
                                  np.array(jstate.sampler_state.loss_counts))
    np.testing.assert_allclose(pstate.sampler_state.loss_history.numpy(),
                               np.array(jstate.sampler_state.loss_history), rtol=1e-5, atol=0)



def test_step_builds_a_graph_under_remat():
    """The UNet under remat records a graph on the training path (every
    parameter gets a gradient), and runs plainly under no_grad."""
    punet = UNet2DCondition(**UNET, remat=True, device="cpu")
    x = torch.randn(2, 8, 8, 12)
    out = punet(x, torch.tensor([3, 5]), torch.randn(2, 2, 16))
    grads = torch.autograd.grad(out.square().mean(), list(punet.parameters()))
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    punet.remat = False
    ref = punet(x, torch.tensor([3, 5]), torch.randn(2, 2, 16) * 0 + 0)
    with torch.no_grad():
        again = punet(x, torch.tensor([3, 5]), torch.zeros(2, 2, 16))
    torch.testing.assert_close(again, ref.detach(), rtol=0, atol=0)


def test_unknown_settings_rejected():
    _, pcfg = _configs("pixel", "v_pred_depth", "uniform", {})
    punet = UNet2D(**UNET2D, device="cpu")
    opt = build_optimizer(pcfg, 10, list(punet.parameters()))
    with pytest.raises(ValueError):
        make_train_step(pcfg, punet, opt, None)
    with pytest.raises(ValueError):
        make_train_step(dataclasses.replace(pcfg, prediction_type="sample"), punet, opt, None,
                        t_sampler="snr")


def test_eval_pipeline_from_live_params_sees_the_step():
    """The in-training eval builds its pipeline over the live models: after
    an optimizer step, the cached int8 operands (`_Cached`, made from the
    weights) are remade from the updated weights, so a quantized forward
    equals one of a fresh model loaded with them."""
    from d3roma_tpu_torch.training import create_pipeline

    _, pcfg = _configs("ldm", "v_prediction", "uniform", {})
    (_, params, _, vae_params, text), (punet, pvae, ptext) = _models("ldm")
    pipe = create_pipeline(pcfg, {"unet": punet, "vae": pvae, "text_embed": ptext})
    x = torch.from_numpy(np.random.RandomState(9).standard_normal((2, 8, 8, 12)).astype(np.float32))
    t = torch.tensor([3, 11])
    ctx = ptext.expand(2, -1, -1)

    def quantized(unet):
        unet.set_quant("all")
        with torch.no_grad():
            out = unet(x, t, ctx)
        unet.set_quant(False)
        return out

    before = quantized(pipe.unet)  # fills the cached int8 weights
    opt = build_optimizer(pcfg, 10, list(punet.parameters()))
    state = create_train_state(pcfg, punet, 10, optimizer=opt)
    step = make_train_step(pcfg, punet, opt, pcfg.schedule_config(train=True).tables("cpu"),
                           vae=pvae, text_embed=ptext)
    step(state, {k: torch.from_numpy(v) for k, v in _batch().items()},
         JaxKeyDraws(jax.random.PRNGKey(0), "randn"))
    after = quantized(pipe.unet)
    fresh = UNet2DCondition(**UNET, device="cpu")
    fresh.load_state_dict(punet.state_dict())
    assert not torch.equal(before, after)
    assert torch.equal(after, quantized(fresh))
