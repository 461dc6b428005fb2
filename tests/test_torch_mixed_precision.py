"""bf16 mixed-precision training (`mixed_precision="bf16"` / "fp16") in the
port against the JAX package, at tiny sizes.

The JAX trainer's `build_models(dtype=bfloat16)` computes in bf16 over fp32
parameters (Flax's module `dtype` with `param_dtype` fp32); the port does
the same through `models.set_compute_dtype`. Held here:

- each layer under bf16 compute against its Flax counterpart with fp32
  parameters (Dense, Conv, the GroupNorm + SiLU, GroupNorm and LayerNorm):
  the output bf16; the norms' fp32 affine on the fp32 statistics bit-equal
  to Flax's; Dense and Conv within one bf16 rounding (2^-8 of max |ref|:
  XLA rounds the product and then the biased sum, PyTorch's addmm and
  convolution round once); the GroupNorm + SiLU within two (the JAX layer
  rounds x * scale, then + shift, then the SiLU; the port's addcmul rounds
  once before the SiLU); the sites JAX pins to fp32 (the UNet's and the VAE's
  conv_out) and the VAE's "promote" quant convs compute with the
  unrounded fp32 weight, bit for bit the fp32 convolution, and differ from
  the same convolution on the bf16-rounded weight;
- "fp16" builds what "bf16" builds (the JAX package maps both to bf16
  compute), bit for bit;
- one and three train steps against the JAX `make_train_step` on the same
  weights, batch and replayed draws (tests/test_torch_train_step.py's
  pattern), AdamW and Adafactor, the latent family (v-prediction, the
  frozen VAE in bf16, the recon-MAE decode) and the pixel family (the JAX
  and the port's `build_models` at tiny widths; the latent UNet at tiny
  widths with dtype=bfloat16, which is what the JAX `build_models` builds
  at full width). Both sides round every activation to bf16, but not in the
  same places (XLA's and PyTorch's bf16 convolutions and matmuls sum in other
  orders and fuse other ops before a rounding), so the outputs differ by the
  bf16 noise itself: the UNet's outputs by ~2.7e-2 of their max here, as far
  as either side is from the fp32 forward. The loss, recon_mae and
  grad_norm are means over the batch of errors at that noise (measured: the
  loss and recon_mae within 1.1e-3 relative, grad_norm within 5.7e-3), so
  the tolerances are 5e-3 relative for the loss and recon_mae and 2e-2 for
  grad_norm. The parameters: an update is about the learning rate an
  element (AdamW's first one is lr times the gradient's sign; Adafactor's is
  clipped in block RMS, so an element may pass it: 1.04 lr measured), and 1%
  of the elements, whose gradients sit at the bf16 noise, flip sign and move
  the other way. So every element within 2.5 learning rates a step, and 90%
  within 0.1 of the learning rate times the number of steps (measured: at
  most 0.044 a step);
- the optimizer's state stays fp32 (the moments of AdamW, the factored
  moments of Adafactor).

A bf16 run's checkpoint and exports are held in tests/test_torch_train_loop.py.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3roma_tpu.models.layers as jax_layers
from d3roma_tpu.config import TrainingConfig as JaxConfig
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.training import build_optimizer as jax_build_optimizer
from d3roma_tpu.training import create_train_state as jax_create_state
from d3roma_tpu.training import make_train_step as jax_make_step
from d3roma_tpu.training.train_loop import build_models as jax_build_models
from d3roma_tpu_torch.config import TrainingConfig
from d3roma_tpu_torch.models import (
    AutoencoderKL,
    UNet2DCondition,
    flax_unet2d_to_torch,
    flax_unet_to_torch,
    flax_vae_to_torch,
    set_compute_dtype,
)
from d3roma_tpu_torch.models import layers
from d3roma_tpu_torch.training import build_models, build_optimizer, create_train_state
from d3roma_tpu_torch.training import make_train_step
from torch_port_utils import ReplayDraws, jax_step_draws, random_flax_tree

BF16 = torch.bfloat16
HW = (16, 16)
B = 4
T = 20
LR = 1e-3
UNET = dict(in_channels=12, out_channels=4, block_out_channels=(8, 16),
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
            attention_head_dim=8, cross_attention_dim=16, norm_groups=4)
VAE = dict(block_out_channels=(4, 8), latent_channels=4, norm_groups=2)
PIXEL_WIDTHS = [8, 16]
LOSS_RTOL, GRAD_NORM_RTOL = 5e-3, 2e-2
PARAM_MAX = 2.5  # every element within 2.5 lr a step
PARAM_SHARE, PARAM_TOL = 0.9, 0.1  # 90% of the elements within 0.1 lr a step


def _rs(seed):
    return np.random.RandomState(seed)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _off_grid(rs, shape, scale=1.0):
    """fp32 values that bf16 cannot hold (so a rounded weight shows)."""
    x = (rs.standard_normal(shape) * scale).astype(np.float32)
    return x + np.float32(scale * 2.0 ** -12) * np.sign(x)


# ---------------------------------------------------------------------- #
# layers under bf16 compute
# ---------------------------------------------------------------------- #


def _bf16_layer_case(name):
    rs = _rs(1)
    x = rs.standard_normal((2, 6, 5, 16)).astype(np.float32)
    w = _off_grid(rs, (16,), 0.5) + 1.0
    b = _off_grid(rs, (16,), 0.5)
    if name == "dense":
        k = _off_grid(rs, (16, 24), 0.25)
        bias = _off_grid(rs, (24,), 0.1)
        ref = fnn.Dense(24, dtype=jnp.bfloat16).apply(
            {"params": {"kernel": k, "bias": bias}}, jnp.asarray(x))
        mod = layers.Linear(16, 24)
        mod.load_state_dict({"weight": torch.from_numpy(k.T.copy()),
                             "bias": torch.from_numpy(bias)})
    elif name == "conv":
        k = _off_grid(rs, (3, 3, 16, 8), 0.1)
        bias = _off_grid(rs, (8,), 0.1)
        ref = fnn.Conv(8, (3, 3), padding=1, dtype=jnp.bfloat16).apply(
            {"params": {"kernel": k, "bias": bias}}, jnp.asarray(x))
        mod = layers.Conv2d(16, 8, 3, padding=1)
        mod.load_state_dict({"weight": torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                             "bias": torch.from_numpy(bias)})
    elif name == "group_norm_silu":
        ref = jax_layers.GroupNormSiLU(4, 1e-5, dtype=jnp.bfloat16).apply(
            {"params": {"scale": w, "bias": b}}, jnp.asarray(x))
        mod = layers.GroupNormSiLU(16, 4, 1e-5)
    elif name == "group_norm":
        ref = fnn.GroupNorm(4, epsilon=1e-6, dtype=jnp.bfloat16).apply(
            {"params": {"scale": w, "bias": b}}, jnp.asarray(x))
        mod = layers.GroupNorm(16, 4, 1e-6)
    else:
        ref = fnn.LayerNorm(dtype=jnp.bfloat16).apply(
            {"params": {"scale": w, "bias": b}}, jnp.asarray(x))
        mod = layers.LayerNorm(16)
    if name not in ("dense", "conv"):
        mod.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    return mod, torch.from_numpy(x), np.asarray(ref.astype(jnp.float32)), ref.dtype


LAYER_TOL = {"dense": 2.0 ** -8, "conv": 2.0 ** -8, "group_norm_silu": 2.0 ** -7,
             "group_norm": 0.0, "layer_norm": 0.0}


@pytest.mark.parametrize("name", sorted(LAYER_TOL))
def test_layer_bf16_compute_matches_flax(name):
    mod, x, ref, ref_dtype = _bf16_layer_case(name)
    set_compute_dtype(mod, BF16)
    assert all(p.dtype == torch.float32 for p in mod.parameters())
    with torch.no_grad():
        got = mod(x)
    assert ref_dtype == jnp.bfloat16 and got.dtype == BF16
    assert _rel_err(got.float().numpy(), ref) <= LAYER_TOL[name]


def test_pinned_and_promote_sites_see_the_unrounded_weight():
    """The UNet's conv_out, the VAE's conv_outs and quant convs under bf16
    compute: fp32 out, bit-equal to the fp32 convolution on the fp32
    master, not to the one on the bf16-rounded weight."""
    unet = UNet2DCondition(**UNET, device="cpu")
    vae = AutoencoderKL(**VAE, device="cpu")
    for m in (unet, vae):
        gen = torch.Generator().manual_seed(3)
        for p in m.parameters():
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2 + 2.0 ** -12)
    set_compute_dtype(unet, BF16)
    set_compute_dtype(vae, BF16)
    sites = {"unet.conv_out": unet.conv_out, "vae.encoder.conv_out": vae.encoder.conv_out,
             "vae.decoder.conv_out": vae.decoder.conv_out, "vae.quant_conv": vae.quant_conv,
             "vae.post_quant_conv": vae.post_quant_conv}
    gen = torch.Generator().manual_seed(4)
    for name, conv in sites.items():
        assert conv.dtype == BF16 and conv.weight.dtype == torch.float32, name
        x = torch.randn((2, 5, 6, conv.in_channels), generator=gen)
        inputs = [x] if conv.compute_dtype == "promote" else [x, x.to(BF16)]
        for xin in inputs:  # the pinned sites take the bf16 activations of the model
            with torch.no_grad():
                got = conv(xin)
                exact = torch.nn.functional.conv2d(
                    xin.float().permute(0, 3, 1, 2), conv.weight, conv.bias,
                    padding=conv.padding).permute(0, 2, 3, 1)
                rounded = torch.nn.functional.conv2d(
                    xin.float().permute(0, 3, 1, 2), conv.weight.to(BF16).float(),
                    conv.bias.to(BF16).float(), padding=conv.padding).permute(0, 2, 3, 1)
            assert got.dtype == torch.float32, name
            assert torch.equal(got, exact), name
            assert not torch.equal(got, rounded), name
    # the layers around them compute in bf16
    assert unet.conv_in.dtype == BF16 and vae.encoder.conv_in.dtype == BF16


def _pixel_config(cls, precision, **kw):
    return cls(ldm=False, depth_channels=1, cond_channels="rgb+raw", image_size=HW,
               divis_by=8, block_out_channels=PIXEL_WIDTHS, mixed_precision=precision, **kw)


def test_fp16_builds_what_bf16_builds():
    """Both packages map "fp16" to bf16 compute; the port's models equal
    each other's weights and forward bit for bit, "no" computes in fp32."""
    for precision, want in (("bf16", jnp.bfloat16), ("fp16", jnp.bfloat16),
                            ("no", jnp.float32)):
        jm = jax_build_models(_pixel_config(JaxConfig, precision), jax.random.PRNGKey(0))
        assert jm["unet"].dtype == want, precision
    built = {p: build_models(_pixel_config(TrainingConfig, p), 0, "cpu")["unet"]
             for p in ("bf16", "fp16", "no")}
    x = torch.from_numpy(_rs(2).standard_normal((2,) + HW + (5,)).astype(np.float32))
    outs = {}
    for p, unet in built.items():
        dts = {m.dtype for m in unet.modules() if hasattr(m, "compute_dtype") or isinstance(
            m, (layers.Linear, layers.GroupNormSiLU, layers.GroupNorm, layers.LayerNorm))}
        assert dts == ({None} if p == "no" else {BF16}), p
        assert all(t.dtype == torch.float32 for t in unet.state_dict().values()), p
        with torch.no_grad():
            outs[p] = unet(x, torch.tensor([3, 7]))
    for k, v in built["bf16"].state_dict().items():
        assert torch.equal(v, built["fp16"].state_dict()[k]), k
    assert torch.equal(outs["bf16"], outs["fp16"])
    assert not torch.equal(outs["bf16"], outs["no"])


# ---------------------------------------------------------------------- #
# train steps under bf16 compute
# ---------------------------------------------------------------------- #

CASES = {"ldm-adamw": ("ldm", "adamw"), "ldm-adafactor": ("ldm", "adafactor"),
         "pixel-adamw": ("pixel", "adamw"), "pixel-adafactor": ("pixel", "adafactor")}


def _configs(family, optimizer, precision="bf16"):
    kw = dict(ldm=family == "ldm", depth_channels=4 if family == "ldm" else 1,
              cond_channels="rgb+raw", image_size=HW, divis_by=8, num_train_timesteps=T,
              beta_schedule="scaled_linear", beta_start=0.00085, beta_end=0.012,
              prediction_type="v_prediction", noise_strategy="randn", loss_type="mse",
              train_batch_size=B, gradient_accumulation_steps=1, clip_grad_norm=1.0,
              learning_rate=LR, lr_warmup_steps=0, lr_scheduler="constant",
              clip_sample=False, timestep_sampler="uniform", noise_rgb=family == "ldm",
              optimizer=optimizer, mixed_precision=precision, block_out_channels=PIXEL_WIDTHS)
    return JaxConfig(**kw), TrainingConfig(**kw)


def _batch(seed=0):
    rs = _rs(seed)
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


def _models(family, jcfg, pcfg):
    """The JAX models in bf16 compute with their fp32 params, and the
    port's, built for bf16 compute, holding the same params."""
    if family == "ldm":
        unet = JaxUNet(**UNET, dtype=jnp.bfloat16)
        params = random_flax_tree(JaxUNet(**UNET), 1, jnp.zeros((1, 8, 8, 12)),
                                  jnp.array([0]), jnp.zeros((1, 2, 16)))
        vae = JaxVAE(**VAE, dtype=jnp.bfloat16)
        vae_params = random_flax_tree(JaxVAE(**VAE), 2, jnp.zeros((1, 16, 16, 3)))
        text = _rs(3).standard_normal((1, 2, 16)).astype(np.float32)
        port_unet = UNet2DCondition(**UNET, remat=True, device="cpu")
        port_unet.load_state_dict(flax_unet_to_torch(params))
        port_vae = AutoencoderKL(**VAE, device="cpu").requires_grad_(False)
        port_vae.load_state_dict(flax_vae_to_torch(vae_params))
        set_compute_dtype(port_unet, BF16)
        set_compute_dtype(port_vae, BF16)
        return (unet, params, vae, vae_params, text), (port_unet, port_vae, torch.from_numpy(text))
    jm = jax_build_models(jcfg, jax.random.PRNGKey(1))
    port_unet = build_models(pcfg, 0, "cpu")["unet"]
    port_unet.load_state_dict(flax_unet2d_to_torch(jm["unet_params"]))
    return (jm["unet"], jm["unet_params"], None, None, None), (port_unet, None, None)


@functools.lru_cache(maxsize=None)
def _run(case, steps=3):
    family, optimizer = CASES[case]
    jcfg, pcfg = _configs(family, optimizer)
    (unet, params, vae, vae_params, text), (punet, pvae, ptext) = _models(family, jcfg, pcfg)
    ldm = family == "ldm"
    assert unet.dtype == jnp.bfloat16
    tables = jcfg.schedule_config(train=True).tables()
    tx = jax_build_optimizer(jcfg, 10)
    jstate = jax_create_state(jcfg, params, 10, 0, tx=tx)
    if ldm:
        step = jax.jit(jax_make_step(
            jcfg, lambda p, x, t, c: unet.apply({"params": p}, x, t, c), tx, tables,
            lambda p, x, method: vae.apply({"params": p}, x, method=method), jnp.asarray(text)))
    else:
        step = jax.jit(jax_make_step(jcfg, lambda p, x, t: unet.apply({"params": p}, x, t), tx,
                                     tables))
    opt = build_optimizer(pcfg, 10, list(punet.parameters()))
    pstate = create_train_state(pcfg, punet, 10, seed=0, optimizer=opt)
    pstep = make_train_step(pcfg, punet, opt, pcfg.schedule_config(train=True).tables("cpu"),
                            vae=pvae, text_embed=ptext)
    batch = _batch()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    lat = (B, HW[0] // 2, HW[1] // 2, 4) if ldm else None
    noise_shape = lat if ldm else (B,) + HW + (1,)
    rgb_shape = lat if pcfg.noise_rgb else None
    out = []
    for i in range(steps):
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        draws = ReplayDraws(jax_step_draws(key, noise_shape, "randn", B, T, None, rgb_shape))
        jstate, jm = step(jstate, jbatch, key, vae_params) if ldm else step(jstate, jbatch, key)
        pm = pstep(pstate, tbatch, draws)
        assert not draws.arrays
        out.append((jm, pm, jax.tree.map(np.asarray, jstate.params),
                    {k: v.clone() for k, v in punet.state_dict().items()}))
    return pstate, out


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_steps_match_jax(case):
    """Three steps; metrics after each, parameters after the first and the
    third, every parameter and optimizer tensor fp32."""
    family = CASES[case][0]
    pstate, out = _run(case)
    convert = flax_unet_to_torch if family == "ldm" else flax_unet2d_to_torch
    for i, (jm, pm, jparams, ours) in enumerate(out):
        np.testing.assert_array_equal(pm["timesteps"].numpy(), np.array(jm["timesteps"]))
        assert pm["loss"].dtype == torch.float32 and jm["loss"].dtype == jnp.float32
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=GRAD_NORM_RTOL)
        np.testing.assert_allclose(float(pm["recon_mae"]), float(jm["recon_mae"]),
                                   rtol=LOSS_RTOL)
        if i in (0, 2):
            ref = convert(jparams)
            assert ours.keys() == ref.keys()
            assert all(v.dtype == torch.float32 for v in ours.values())
            diffs = np.concatenate([np.abs(ours[k].numpy() - ref[k].numpy()).ravel()
                                    for k in ref])
            steps = i + 1
            assert diffs.max() <= PARAM_MAX * LR * steps, diffs.max()
            assert np.quantile(diffs, PARAM_SHARE) <= PARAM_TOL * LR * steps, \
                np.quantile(diffs, PARAM_SHARE)
    moments = ("mu", "nu") if CASES[case][1] == "adamw" else ("v_row", "v_col", "v")
    for k in moments:
        assert all(t.dtype == torch.float32 for t in pstate.optimizer.state[k]), k
