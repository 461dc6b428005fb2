"""The port's int8 convolution wrapper (on the CPU: its plain version)
against the JAX package: the Pallas conv3x3_flat kernel (quant="static") in
interpret mode at stride 1, through the wrapper's "tpu" epilogue, and the XLA
static int8 conv that quant="static" runs at the other sites (UNet stride 2,
VAE (0, 1)-padded stride 2, 1x1) through its "xla" epilogue."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from d3roma_tpu.ops import quant as jq
from d3roma_tpu.ops.pallas import conv2d as jax_conv2d
from d3roma_tpu_torch.ops import quant as tq
from d3roma_tpu_torch.ops.kernels import conv2d as port_conv2d
from torch_port_utils import randn

# fp32 outputs against the jitted XLA static conv: the int32 sums and the
# weight scales are equal, and the dequantization's fp32 products round as
# XLA's fused elementwise code rounds them
TOL = 1e-6


def _operands(b, h, w, cin, cout, k, seed=0):
    x = randn(seed, b, h, w, cin)
    wt = randn(seed + 1, k, k, cin, cout, scale=(k * k * cin) ** -0.5)  # HWIO
    scale = float(np.float32(np.abs(x).max() / 127 * 1.25))
    wq, ws = tq.quantize_weight(torch.from_numpy(wt).permute(3, 0, 1, 2))
    return x, wt, scale, wq, ws


@pytest.mark.parametrize("cin,cout", [(32, 48), (64, 130)])
def test_matches_conv3x3_flat_kernel(cin, cout):
    """Bit-equal through the "tpu" epilogue, acc * (act_scale * ws), with the
    weight scales the TPU wrapper computes under jit."""
    x, wt, scale, _, _ = _operands(2, 9, 13, cin, cout, 3)
    wq, ws = tq.quantize_weight(torch.from_numpy(wt).permute(3, 0, 1, 2))
    ref = np.asarray(jax_conv2d.conv3x3_flat(jnp.asarray(x), jnp.asarray(wt), quant="static",
                                             act_scale=scale, interpret=True))
    before = port_conv2d.conv2d_int8.launches
    out = port_conv2d.conv2d_int8(torch.from_numpy(x), wq, ws, scale, None, 1, 1, "tpu")
    assert port_conv2d.conv2d_int8.launches == before + 1
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


# (name, input HW, kernel, stride, padding as the port's layers pass it,
#  padding as the JAX package's Flax convs pass it, pre-pad of the VAE)
SITES = {
    "unet_3x3": ((9, 13), 3, 1, 1, ((1, 1), (1, 1)), False),
    "unet_stride2": ((9, 13), 3, 2, 1, ((1, 1), (1, 1)), False),
    "vae_stride2": ((9, 13), 3, 2, 0, "VALID", True),
    "shortcut_1x1": ((9, 13), 1, 1, 0, ((0, 0), (0, 0)), False),
}


@pytest.mark.parametrize("site", list(SITES))
def test_matches_xla_static_conv(site):
    (h, w), k, stride, pad, jax_pad, vae_prepad = SITES[site]
    x, wt, scale, wq, ws = _operands(2, h, w, 32, 64, k, seed=3)
    if vae_prepad:  # Downsample2D(asymmetric_padding=True) pads (0, 1) first
        x = np.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)))
    bias = randn(9, 64, scale=0.1)
    with jq.replay_act_scales([scale]):
        ref = np.asarray(jax.jit(lambda a, b: jq.int8_conv_general_dilated_static(
            a, b, (stride, stride), jax_pad, dimension_numbers=("NHWC", "HWIO", "NHWC")))(
                jnp.asarray(x), jnp.asarray(wt))) + bias
    rs = jax.jit(lambda a: jq.absmax_scale(a, axes=(0, 1, 2)))(jnp.asarray(wt))
    acc_ref = np.asarray(jq.lax.conv_general_dilated(
        jq.quantize_int8(jnp.asarray(x), jnp.float32(scale)), jq.quantize_int8(jnp.asarray(wt), rs),
        (stride, stride), jax_pad, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    xq = tq.quantize_int8(torch.from_numpy(x), scale)
    acc = port_conv2d.conv2d_int8_acc_plain(xq, wq, stride, pad)
    np.testing.assert_array_equal(acc.numpy(), acc_ref)
    out = port_conv2d.conv2d_int8(torch.from_numpy(x), wq, ws, scale, torch.from_numpy(bias),
                                  stride, pad)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL * np.abs(ref).max())


def test_plain_conv_is_exact_past_fp32():
    """127^2 * 3 * 3 * 2560 > 2^24: an fp32 sum would round, float64 does not."""
    xq = torch.full((1, 3, 3, 2560), 127, dtype=torch.int8)
    wq = torch.full((1, 3, 3, 2560), 127, dtype=torch.int8)
    wq[0, 0, 0, 0] = 126
    acc = port_conv2d.conv2d_int8_acc_plain(xq, wq, 1, 0)
    assert acc.item() == 127 * 127 * 9 * 2560 - 127


@pytest.mark.parametrize("case", ["fp32_x", "cin_48", "cout_odd", "fp32_bias"])
def test_cuda_checks_refuse_what_the_kernel_cannot_take(case):
    """The checks a CUDA call meets before the launch (dtype, shape,
    contiguity; CPU tensors exercise them here)."""
    cin, cout = (48 if case == "cin_48" else 64), (33 if case == "cout_odd" else 64)
    x = torch.zeros(1, 4, 4, cin, dtype=torch.float32 if case == "fp32_x" else torch.bfloat16)
    wq = torch.zeros(cout, 3, 3, cin, dtype=torch.int8)
    ws = torch.ones(cout)
    bias = torch.zeros(cout, dtype=torch.float32 if case == "fp32_bias" else torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        port_conv2d._check_cuda(x, wq, ws, bias)
    port_conv2d._check_cuda(torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16),
                            torch.zeros(64, 3, 3, 64, dtype=torch.int8), torch.ones(64),
                            torch.zeros(64, dtype=torch.bfloat16))


def test_layer_conv_routes_through_the_wrapper():
    """A quant="static" Conv2d takes one tap and calls the int8 wrapper with
    the weight laid out [Cout, KH, KW, Cin]."""
    from d3roma_tpu_torch.models.layers import Conv2d

    conv = Conv2d(32, 16, 3, stride=2, padding=1)
    conv.quant = "static"
    x = torch.from_numpy(randn(5, 1, 7, 9, 32))
    before = port_conv2d.conv2d_int8.launches
    with tq.replay_act_scales([0.03]):
        out = conv(x)
    assert port_conv2d.conv2d_int8.launches == before + 1
    wq, ws = tq.quantize_weight(conv.weight.permute(0, 2, 3, 1))
    ref = port_conv2d.conv2d_int8_plain(x, wq, ws, 0.03, conv.bias, 2, 1)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    plain = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, 2, 1).permute(0, 2, 3, 1)
    assert (out - plain).abs().max() < 0.05 * plain.abs().max()
