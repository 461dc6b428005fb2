"""The port's fused GEGLU wrapper (on the CPU: its plain version) against the
JAX Pallas kernel (bf16 path) run in interpret mode, on the same numpy
inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops.pallas import geglu as jax_geglu
from d3roma_tpu_torch.ops.kernels import geglu as port_geglu
from torch_port_utils import randn

# fp32: the same products and fp32 sums in another order (the TPU kernel
# accumulates per 512-row sub-chunk and F chunk); bf16: both round the
# gated product and the output to bf16
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _inputs(c, f, rows=(2, 150)):
    # 300 rows: not a multiple of the TPU kernel's 2048-row block
    x = randn(0, *rows, c)
    w1h, w1g = randn(1, c, f, scale=c ** -0.5), randn(2, c, f, scale=c ** -0.5)
    w2 = randn(3, f, c, scale=f ** -0.5)
    b1h, b1g, b2 = randn(4, f, scale=0.1), randn(5, f, scale=0.1), randn(6, c, scale=0.1)
    return x, w1h, w1g, w2, b1h, b1g, b2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,f", [(32, 128), (64, 256)])
def test_matches_pallas_kernel(c, f, dtype):
    x, w1h, w1g, w2, b1h, b1g, b2 = _inputs(c, f)
    ref = jax_geglu.geglu_ff(
        *(jnp.asarray(a, dtype) for a in (x, w1h, w1g, w2)),
        *(jnp.asarray(a) for a in (b1h, b1g, b2)), interpret=True)
    tdt = getattr(torch, dtype)
    before = port_geglu.geglu_ff.launches
    out = port_geglu.geglu_ff(*(torch.from_numpy(a).to(tdt) for a in (x, w1h, w1g, w2)),
                              *(torch.from_numpy(a) for a in (b1h, b1g, b2)))
    assert port_geglu.geglu_ff.launches == before + 1
    assert out.dtype == tdt and tuple(out.shape) == x.shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_parity_would_catch_erf_gelu():
    """jax.nn.gelu defaults to the tanh approximation, PyTorch's F.gelu to
    the exact erf form. A GEGLU built on the erf form falls outside the fp32
    tolerance above, so test_matches_pallas_kernel catches that mistake."""
    x, w1h, w1g, w2, b1h, b1g, b2 = _inputs(64, 256)
    ref = np.asarray(jax_geglu.geglu_ff(*map(jnp.asarray, (x, w1h, w1g, w2, b1h, b1g, b2)),
                                        interpret=True))
    xf = torch.from_numpy(x.reshape(-1, 64))
    h = xf @ torch.from_numpy(w1h) + torch.from_numpy(b1h)
    g = xf @ torch.from_numpy(w1g) + torch.from_numpy(b1g)
    erf = (h * torch.nn.functional.gelu(g)) @ torch.from_numpy(w2) + torch.from_numpy(b2)
    assert not np.allclose(erf.numpy().reshape(ref.shape), ref,
                           atol=TOL["float32"], rtol=TOL["float32"])


def test_gate_matches_jax():
    for c in (24, 32, 320, 640, 1280, 2048, 2049):
        for f in (96, 128, 1280, 2560, 5120, 8192, 8320):
            assert port_geglu.geglu_supported(c, f) == jax_geglu.geglu_supported(c, f)
    assert all(port_geglu.geglu_supported(c, 4 * c) for c in (320, 640, 1280))


def _cuda_check_operands(c, f):
    """Operands the CUDA checks accept: bf16 x, K-major bf16 weights (the
    transposes of contiguous tensors), fp32 biases."""
    bf = torch.bfloat16
    x = torch.zeros(1, 4, c, dtype=bf)
    w1h, w1g = torch.zeros(f, c, dtype=bf).t(), torch.zeros(f, c, dtype=bf).t()
    w2 = torch.zeros(c, f, dtype=bf).t()
    return x, w1h, w1g, w2, [torch.zeros(f), torch.zeros(f), torch.zeros(c)]


@pytest.mark.parametrize("case", ["fp32_x", "bf16_bias", "c_24", "f_96", "strided_w"])
def test_cuda_checks_refuse_what_the_kernel_cannot_take(case):
    """The checks a CUDA call meets before the launch (dtype, shape, the
    weights' K-major layout; CPU tensors exercise them here)."""
    c, f = (24 if case == "c_24" else 32), (96 if case == "f_96" else 128)
    x, w1h, w1g, w2, biases = _cuda_check_operands(c, f)
    err = ValueError
    if case == "fp32_x":
        x, err = x.float(), TypeError
    elif case == "bf16_bias":
        biases[2], err = biases[2].to(torch.bfloat16), TypeError
    elif case == "strided_w":
        w1h = w1h.contiguous()  # the JAX layout in memory: F contiguous, not C
    with pytest.raises(err):
        port_geglu._check_cuda(x, w1h, w1g, w2, biases)


def test_cuda_checks_take_k_major_operands():
    port_geglu._check_cuda(*_cuda_check_operands(32, 128))
    port_geglu._check_cuda(*_cuda_check_operands(1280, 5120))


# (rows, C, F) of the four UNet levels at batch 2 and at the benchmark's
# batch 16 -> the bf16 and the int8 plan (out_cols, splits, workspace
# bytes) on a card of 132 SMs; the widths and splits are the
# fastest of those timed on the H100 at each shape
_PLANS = {
    (7200, 320, 1280): ((128, 1, 7200 * 1280 * 2), (128, 1, 7200 * 1280 + 15 * 2 * 4)),
    (1840, 640, 2560): ((128, 1, 1840 * 2560 * 2), (128, 1, 1840 * 2560 + 4 * 4 * 4)),
    (480, 1280, 5120): ((128, 5, 480 * 5120 * 2 + 5 * 480 * 1280 * 4),
                        (64, 1, 480 * 5120 + 2 * 5 * 4)),
    (120, 1280, 5120): ((64, 5, 120 * 5120 * 2 + 5 * 120 * 1280 * 4),
                        (64, 5, 120 * 5120 + 5 * 120 * 1280 * 4 + 1 * 5 * 4)),
    (57600, 320, 1280): ((128, 1, 57600 * 1280 * 2),
                         (128, 1, 57600 * 1280 + 113 * 2 * 4)),
    (14720, 640, 2560): ((128, 1, 14720 * 2560 * 2),
                         (128, 1, 14720 * 2560 + 29 * 4 * 4)),
    (3840, 1280, 5120): ((128, 1, 3840 * 5120 * 2), (128, 1, 3840 * 5120 + 15 * 5 * 4)),
    (960, 1280, 5120): ((128, 1, 960 * 5120 * 2), (128, 1, 960 * 5120 + 4 * 5 * 4)),
}


@pytest.mark.parametrize("shape", list(_PLANS))
def test_plan_at_flagship_shapes(shape):
    """The host-side plan of a call: tile widths, splits of the second
    product (only at the TPU kernel's blk_cols chunks, 5 at F = 5120) and
    the scratch bytes the wrappers allocate (y or yq, the split partial
    sums, the int8 scale table), for both kernels."""
    rows, c, f = shape
    for int8, expected in zip((False, True), _PLANS[shape]):
        plan = port_geglu.geglu_plan(rows, c, f, int8)
        assert plan == port_geglu.GegluPlan(*expected)
        assert plan.splits in (1, f // port_geglu.pick_cols(f))


def _int8_operands(c, f, rows, padded_dominates=False):
    """Numpy-seeded operands of the int8 GEGLU, as JAX takes them and as the
    port takes them. With padded_dominates, the zero-padded rows' y =
    b1h * gelu(b1g) = 6 gelu(6) ~ 36 is far above every real row's (x is
    positive and W1g pulls the real rows' gate down to ~6 - 5)."""
    from d3roma_tpu_torch.ops.quant import quantize_weight

    x, w1h, w1g, w2, b1h, b1g, b2 = _inputs(c, f, rows)
    if padded_dominates:
        x = np.abs(x)
        w1h = w1h * 0.01
        w1g = np.full_like(w1g, -5.0 / (0.8 * c))
        b1h = b1g = np.full_like(b1h, 6.0)
    (w1hq, s1h), (w1gq, s1g), (w2q, s2) = (quantize_weight(torch.from_numpy(w).t())
                                           for w in (w1h, w1g, w2))
    port_ops = (w1hq, w1gq, w2q, s1h, s1g, s2, *map(torch.from_numpy, (b1h, b1g, b2)))
    return x, (w1h, w1g, w2, b1h, b1g, b2), port_ops


# int8: the same integers on both sides and the TPU kernel's scale grid; tanh
# differs between XLA and PyTorch in the last place, which can move one
# re-quantized y by one quantum (1/127 of its tile's absmax)
INT8_TOL = 2e-3


@pytest.mark.parametrize("c,f,rows,padded_dominates", [
    (32, 128, (2, 150), False),   # 300 rows: not a multiple of the 512-row sub-chunk
    (64, 256, (1, 700), False),   # two sub-chunk tiles, the second one padded
    (640, 2560, (1, 20), False),  # two blk_cols chunks of 640 (the 920-token level's F)
    (64, 256, (1, 30), True),     # padded rows' b1h * gelu(b1g) set the tile's absmax
])
def test_int8_matches_pallas_kernel(c, f, rows, padded_dominates):
    x, jax_ops, port_ops = _int8_operands(c, f, rows, padded_dominates)
    act = float(np.float32(np.abs(x).max() / 127 * 1.25))
    ref = np.asarray(jax_geglu.geglu_ff(*map(jnp.asarray, (x, *jax_ops)), quant="static",
                                        act_scale=act, interpret=True))
    before = port_geglu.geglu_ff_int8.launches
    out = port_geglu.geglu_ff_int8(torch.from_numpy(x), *port_ops, act)
    assert port_geglu.geglu_ff_int8.launches == before + 1
    assert tuple(out.shape) == x.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=INT8_TOL * np.abs(ref).max(), rtol=0)


def test_int8_padded_rows_reach_the_tile_absmax(monkeypatch):
    """When the zero-padded rows' y = b1h * gelu(b1g) exceed every real
    row's, they set the tile's scale: a grid whose tile ends at the last real
    row (no padded rows) gives another result. The padded_dominates case
    above holds the padded-row result against the TPU kernel."""
    x, _, port_ops = _int8_operands(64, 256, (1, 30), padded_dominates=True)
    act = float(np.float32(np.abs(x).max() / 127 * 1.25))
    padded = port_geglu.geglu_ff_int8_plain(torch.from_numpy(x), *port_ops, act)
    monkeypatch.setattr(port_geglu, "pick_rows", lambda c: (2048, 30))
    unpadded = port_geglu.geglu_ff_int8_plain(torch.from_numpy(x), *port_ops, act)
    assert not torch.equal(padded, unpadded)


def test_int8_scale_grid_matches_jax():
    for c in (32, 320, 640, 1280):
        assert port_geglu.pick_rows(c) == jax_geglu._pick_rows(c)
    for f in (128, 256, 1280, 2560, 5120, 7680):
        assert port_geglu.pick_cols(f) == jax_geglu._pick_cols(f)
    # the second product splits F only at the scale grid's column chunks,
    # so each split's sums take one chunk's scale and stay bit-equal
    for rows in (16, 120, 480, 7200):
        for c, f in ((320, 1280), (640, 2560), (1280, 5120), (1920, 7680)):
            plan = port_geglu.geglu_plan(rows, c, f, True)
            assert plan.splits in (1, f // port_geglu.pick_cols(f))


def test_feedforward_operands_hold_the_jax_named_weights():
    """FeedForward's bf16 operands are the JAX-named W1h, W1g [C, F] and W2
    [F, C] with their values, laid out K-major (each the transpose of a
    contiguous tensor, as the kernel reads it) and sharing the parameters'
    memory (no copy)."""
    from d3roma_tpu_torch.models.layers import FeedForward

    torch.manual_seed(0)
    ff = FeedForward(32).to(torch.bfloat16)
    proj, out = ff.net[0].proj, ff.net[2]
    w1h, w1g, w2, b1h, b1g, b2 = ff._make_operands(*ff._weights())
    f = ff.hidden
    assert torch.equal(w1h, proj.weight.t()[:, :f]) and torch.equal(w1g, proj.weight.t()[:, f:])
    assert torch.equal(w2, out.weight.t())
    assert tuple(w1h.shape) == (32, f) and tuple(w2.shape) == (f, 32)
    for w in (w1h, w1g, w2):
        assert w.t().is_contiguous()
    assert w1h.data_ptr() == proj.weight.data_ptr() and w2.data_ptr() == out.weight.data_ptr()
    assert torch.equal(b1h, proj.bias[:f].float()) and torch.equal(b2, out.bias.float())
    port_geglu._check_cuda(torch.zeros(1, 4, 32, dtype=torch.bfloat16), w1h, w1g, w2,
                           (b1h, b1g, b2))
