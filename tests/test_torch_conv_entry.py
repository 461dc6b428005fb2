"""The port's 3x3 convolution entry points (on the CPU: the plain versions
of the int8 and the bf16 conv kernels) against the JAX Pallas kernels in
interpret mode on the same numpy inputs: conv3x3_flat (int8 and bf16),
conv3x3_rowtap, conv3x3_halo (int8 and bf16); the three gates against the
JAX gates; the "mxu" and "halo" conv routes of ops/quant.py, and a Conv2d
layer under each against the JAX route as its jitted forward runs it.

Tolerances: the int8 entry points are bit-equal (the same int32 sums, the
same fp32 products in the same order). The bf16 bodies are fp32 sums of the
same products in another order: 1e-5 of max |output| for these fp32 inputs
of 9 * Cin <= 1152 terms (each sum moves by a few ulps of the largest term).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops import quant as jq
from d3roma_tpu.ops.pallas import conv2d as jax_conv2d
from d3roma_tpu.ops.pallas import conv2d_halo as jax_halo
from d3roma_tpu_torch.models.layers import Conv2d
from d3roma_tpu_torch.ops import quant as tq
from d3roma_tpu_torch.ops.kernels import conv2d as pc
from torch_port_utils import randn

BF16_BODY_TOL = 1e-5


def _operands(b, h, w, cin, cout, seed=0):
    x = randn(seed, b, h, w, cin)
    wt = randn(seed + 1, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)  # HWIO
    return x, wt, float(np.float32(np.abs(x).max() / 127 * 1.25))


def _saturated(cin, cout, seed=0):
    """Inputs near the int8 limits: a row of taps' int32 partial is about
    105 * 105 * 3 * Cin, past 2^24 at Cin = 512."""
    rs = np.random.RandomState(seed)
    x = (4.0 + 0.2 * rs.standard_normal((1, 4, 6, cin))).astype(np.float32)
    wt = (1.0 + 0.05 * rs.standard_normal((3, 3, cin, cout))).astype(np.float32)
    return x, wt, float(np.float32(np.abs(x).max() / 127))


def _jax_halo(x, wt, quant, scale=jq.STATIC_ACT_SCALE):
    return np.asarray(jax_halo.conv3x3_halo(jnp.asarray(x), jnp.asarray(wt), quant=quant,
                                            act_scale=scale, block_m=128, interpret=True))


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 9, 13, 64, 48), (1, 5, 7, 32, 130)])
def test_int8_flat_and_rowtap_bit_equal(b, h, w, cin, cout):
    """conv3x3_flat(quant="static") and conv3x3_rowtap: the int8 kernel's
    "tpu" epilogue, acc * (act_scale * ws)."""
    x, wt, scale = _operands(b, h, w, cin, cout)
    xt, wtt = torch.from_numpy(x), torch.from_numpy(wt)
    flat = np.asarray(jax_conv2d.conv3x3_flat(jnp.asarray(x), jnp.asarray(wt), quant="static",
                                              act_scale=scale, interpret=True))
    rowtap = np.asarray(jax_conv2d.conv3x3_rowtap(jnp.asarray(x), jnp.asarray(wt),
                                                  act_scale=scale, interpret=True))
    before = dict(pc.conv2d_int8.epilogue_launches)
    np.testing.assert_array_equal(pc.conv3x3_flat(xt, wtt, "static", scale).numpy(), flat)
    np.testing.assert_array_equal(pc.conv3x3_rowtap(xt, wtt, scale).numpy(), rowtap)
    assert {k: v - before[k] for k, v in pc.conv2d_int8.epilogue_launches.items()} == {
        "xla": 0, "tpu": 2, "halo": 0}


@pytest.mark.parametrize("case", ["random", "past_2_24"])
def test_int8_halo_bit_equal(case):
    """conv3x3_halo(quant="static"): one int32 partial per row of taps,
    added in fp32. Past 2^24 that sum differs from one exact int32 sum, so
    there the "tpu" and "xla" orders differ from the kernel and "halo"
    does not."""
    x, wt, scale = _operands(2, 7, 11, 64, 40) if case == "random" else _saturated(512, 16)
    ref = _jax_halo(x, wt, "static", scale)
    xt, wtt = torch.from_numpy(x), torch.from_numpy(wt)
    np.testing.assert_array_equal(pc.conv3x3_halo(xt, wtt, "static", scale).numpy(), ref)
    if case == "past_2_24":
        wq, ws = tq.quantize_weight(wtt.permute(3, 0, 1, 2))
        for epilogue in ("tpu", "xla"):
            other = pc.conv2d_int8_plain(xt, wq, ws, scale, None, 1, 1, epilogue).numpy()
            assert (other != ref).any(), epilogue


def test_conv3x3_flat_kernel_past_2_24_is_the_tpu_order():
    """The TPU flat kernel keeps one exact int32 sum: past 2^24 it equals
    the "tpu" epilogue and not the "halo" one."""
    x, wt, scale = _saturated(512, 16, seed=3)
    ref = np.asarray(jax_conv2d.conv3x3_flat(jnp.asarray(x), jnp.asarray(wt), quant="static",
                                             act_scale=scale, interpret=True))
    xt, wtt = torch.from_numpy(x), torch.from_numpy(wt)
    np.testing.assert_array_equal(pc.conv3x3_flat(xt, wtt, "static", scale).numpy(), ref)
    wq, ws = tq.quantize_weight(wtt.permute(3, 0, 1, 2))
    assert (pc.conv2d_int8_plain(xt, wq, ws, scale, None, 1, 1, "halo").numpy() != ref).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["flat", "halo"])
def test_bf16_bodies(entry, dtype):
    """quant=None: the bf16 conv kernel's plain version against the TPU
    kernels' fp32 sums (the flat kernel takes the products in x's type, the
    halo kernel rounds x and w to bf16 first)."""
    x, wt, _ = _operands(2, 8, 11, 64, 40, seed=5)
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(wt, dtype)
    if entry == "flat":
        ref = jax_conv2d.conv3x3_flat(xj, wj, interpret=True, out_dtype=jnp.float32)
    else:
        ref = jax_halo.conv3x3_halo(xj, wj, quant=None, block_m=128, interpret=True,
                                    out_dtype=jnp.float32)
    ref = np.asarray(ref)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    wtt = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(getattr(torch, dtype))
    fn = pc.conv3x3_flat if entry == "flat" else pc.conv3x3_halo
    before = pc.conv2d_bf16.launches
    out = fn(xt, wtt, None, out_dtype=torch.float32) if entry == "halo" else \
        fn(xt, wtt, out_dtype=torch.float32)
    assert pc.conv2d_bf16.launches == before + 1 and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=BF16_BODY_TOL * np.abs(ref).max())


# stride-1 3x3 sites of the flagship UNet (batch 2) and VAE, and some that
# every gate refuses
_GATE_SITES = [
    ((2, 45, 80, 320), (3, 3, 320, 320)), ((2, 45, 80, 640), (3, 3, 640, 320)),
    ((2, 45, 80, 960), (3, 3, 960, 320)), ((2, 23, 40, 640), (3, 3, 640, 640)),
    ((2, 23, 40, 960), (3, 3, 960, 640)), ((2, 23, 40, 1920), (3, 3, 1920, 640)),
    ((2, 12, 20, 1280), (3, 3, 1280, 1280)), ((2, 6, 10, 2560), (3, 3, 2560, 1280)),
    ((4, 360, 640, 128), (3, 3, 128, 128)), ((4, 180, 320, 256), (3, 3, 256, 256)),
    ((2, 90, 160, 512), (3, 3, 512, 512)), ((4, 45, 80, 512), (3, 3, 512, 512)),
    ((2, 45, 80, 321), (3, 3, 321, 320)), ((2, 45, 80, 320), (1, 1, 320, 640)),
]


@pytest.mark.parametrize("x_shape,w_shape", _GATE_SITES)
def test_gates_equal_the_jax_gates(x_shape, w_shape):
    for strides, pad in (((1, 1), ((1, 1), (1, 1))), ((1, 1), "SAME"), ((2, 2), "SAME"),
                         ((1, 1), ((0, 0), (0, 0)))):
        assert pc.conv3x3_supported(x_shape, w_shape, strides, pad, torch.int8) == \
            jax_conv2d.conv3x3_supported(x_shape, w_shape, strides, pad, jnp.int8)
        assert pc.conv3x3_supported(x_shape, w_shape, strides, pad, torch.bfloat16) == \
            jax_conv2d.conv3x3_supported(x_shape, w_shape, strides, pad, jnp.bfloat16)
        assert pc.conv3x3_rowtap_supported(x_shape, w_shape, strides, pad) == \
            jax_conv2d.conv3x3_rowtap_supported(x_shape, w_shape, strides, pad)
        for itemsize in (1, 2):
            assert pc.halo_conv_supported(x_shape, w_shape, strides, pad, itemsize) == \
                jax_halo.halo_conv_supported(x_shape, w_shape, strides, pad, itemsize)


def test_halo_gate_at_the_flagship_widths():
    """The halo gate admits 320->320, 640->320, 640->640, 960->320 and every
    VAE width; it refuses 960->640 and everything at 1280 or wider."""
    s = ((1, 1), ((1, 1), (1, 1)))
    admitted = {(ci, co): pc.halo_conv_supported((2, 23, 40, ci), (3, 3, ci, co), *s)
                for ci, co in ((320, 320), (640, 320), (640, 640), (960, 320), (128, 128),
                               (256, 256), (512, 512), (960, 640), (1280, 1280),
                               (1920, 640), (2560, 1280))}
    assert [k for k, v in admitted.items() if v] == [
        (320, 320), (640, 320), (640, 640), (960, 320), (128, 128), (256, 256), (512, 512)]
    # the mxu gate: the UNet's frames, the VAE's 45x80x512, not its 90x160
    assert pc.conv3x3_supported((2, 12, 20, 2560), (3, 3, 2560, 1280), *s, torch.int8)
    assert pc.conv3x3_supported((4, 45, 80, 512), (3, 3, 512, 512), *s, torch.int8)
    assert not pc.conv3x3_supported((2, 90, 160, 512), (3, 3, 512, 512), *s, torch.int8)


@pytest.mark.parametrize("mode,x_shape,epilogue", [
    ("mxu", (1, 6, 8, 32), "tpu"), ("halo", (1, 6, 8, 32), "halo"),
    ("mxu", (1, 200, 200, 128), "xla"),   # the frame exceeds the mxu gate
    ("halo", (1, 6, 8, 36), "xla"),       # Cin % 8 != 0
])
def test_int8_conv_routes(mode, x_shape, epilogue):
    """int8_conv_mxu / int8_conv_halo take one "conv" tap, then send the
    site the gate admits to the kernel in the TPU order and any other to
    the static conv; under capture they run the float conv."""
    cin, cout = x_shape[-1], 16
    x = torch.from_numpy(randn(8, *x_shape, scale=0.5))
    wq, ws = tq.quantize_weight(torch.from_numpy(randn(9, cout, 3, 3, cin, scale=0.1)))
    route = tq.INT8_CONV_ROUTES[mode]
    before = dict(pc.conv2d_int8.epilogue_launches)
    with tq.replay_act_scales([0.02]):
        out = route(x, wq, ws, None, 1, 1, lambda: None)
    after = pc.conv2d_int8.epilogue_launches
    assert {k: after[k] - before[k] for k in after} == {
        e: int(e == epilogue) for e in pc.EPILOGUES}
    np.testing.assert_array_equal(
        out.numpy(), pc.conv2d_int8_plain(x, wq, ws, 0.02, None, 1, 1, epilogue).numpy())
    taps, log = [], []
    with tq.capture_act_scales(taps, shape_log=log):
        assert route(x, wq, ws, None, 1, 1, lambda: "float") == "float"
    assert log == [("conv", tuple(x_shape))] and len(taps) == 1


@pytest.mark.parametrize("mode,case", [
    ("mxu", "random"), ("mxu", "past_2_24"), ("halo", "random"), ("halo", "past_2_24")])
def test_conv2d_layer_matches_the_jax_route(mode, case, monkeypatch):
    """A Conv2d under quant="mxu" or "halo" (its cached int8 weight, its
    route, its bias) against the JAX route (int8_conv_mxu, int8_conv_halo)
    jitted as the bench's forward runs it, with its Pallas kernel in
    interpret mode, on the same weights and replayed scale: bit-equal. Past
    2^24 the other TPU order differs, so the mode's own order is needed."""
    x, wt, scale = _operands(2, 7, 11, 64, 40) if case == "random" else _saturated(512, 16)
    cin, cout = wt.shape[2], wt.shape[3]
    bias = randn(14, cout, scale=0.1)
    module, name = (jax_conv2d, "conv3x3_flat") if mode == "mxu" else (jax_halo, "conv3x3_halo")
    monkeypatch.setattr(module, name, functools.partial(getattr(module, name), interpret=True))
    route = jq.int8_conv_mxu if mode == "mxu" else jq.int8_conv_halo
    with jq.replay_act_scales([scale]):
        ref = np.asarray(jax.jit(lambda a, b: route(
            a, b, (1, 1), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC")))(
                jnp.asarray(x), jnp.asarray(wt))) + bias  # Flax adds the bias after
    conv = Conv2d(cin, cout, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(wt).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(bias))
    conv.quant = mode
    epilogue, other = ("tpu", "halo") if mode == "mxu" else ("halo", "tpu")
    before = dict(pc.conv2d_int8.epilogue_launches)
    with torch.no_grad(), tq.replay_act_scales([scale]):
        out = conv(torch.from_numpy(x)).numpy()
    after = pc.conv2d_int8.epilogue_launches
    assert {k: after[k] - before[k] for k in after} == {e: int(e == epilogue) for e in after}
    np.testing.assert_array_equal(out, ref)
    if case == "past_2_24":
        wq, ws = tq.quantize_weight(torch.from_numpy(wt).permute(3, 0, 1, 2))
        alt = pc.conv2d_int8_plain(torch.from_numpy(x), wq, ws, scale, torch.from_numpy(bias),
                                   1, 1, other)
        assert (alt.numpy() != ref).any()


@pytest.mark.parametrize("case", ["fp32_x", "fp32_w", "cin_48", "cout_odd", "fp32_out"])
def test_bf16_cuda_checks_refuse_what_the_kernel_cannot_take(case):
    """The checks a CUDA call of the bf16 conv meets before the launch."""
    cin, cout = (48 if case == "cin_48" else 64), (33 if case == "cout_odd" else 64)
    x = torch.zeros(1, 4, 4, cin, dtype=torch.float32 if case == "fp32_x" else torch.bfloat16)
    w = torch.zeros(cout, 3, 3, cin, dtype=torch.float32 if case == "fp32_w" else torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        pc._check_cuda_bf16(x, w, torch.float32 if case == "fp32_out" else None)
    pc._check_cuda_bf16(torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16),
                        torch.zeros(64, 3, 3, 64, dtype=torch.bfloat16), None)


def test_int8_cuda_checks_take_fp32_outputs_without_bias_only():
    x = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16)
    wq, ws = torch.zeros(64, 3, 3, 64, dtype=torch.int8), torch.ones(64)
    pc._check_cuda(x, wq, ws, None, torch.float32)
    with pytest.raises(TypeError):
        pc._check_cuda(x, wq, ws, torch.zeros(64, dtype=torch.bfloat16), torch.float32)
    with pytest.raises(ValueError):
        pc.conv2d_int8(x, wq, ws, 0.1, epilogue="rowtap")


def test_weight_scales_as_jax_computes_them_under_jit():
    """The weight scales of every int8 layer and entry point are absmax *
    fp32(1/127), which is what XLA makes of the JAX wrappers' division by the
    constant 127 under jit; an eager JAX call divides and differs here."""
    wt = randn(12, 3, 3, 64, 96, scale=0.05)
    ref = np.asarray(jax.jit(lambda w: jq.absmax_scale(w.reshape(-1, 96), axes=(0,)))(
        jnp.asarray(wt)))[0]
    _, ws = tq.quantize_weight(torch.from_numpy(wt).permute(3, 0, 1, 2))
    np.testing.assert_array_equal(ws.numpy(), ref)
    eager = np.asarray(jq.absmax_scale(jnp.asarray(wt).reshape(-1, 96), axes=(0,)))[0]
    assert (eager != ref).any()
