"""The port's static int8 module (ops/quant.py) against the JAX package's:
the quantization itself, the int8 dense, the capture of activation taps
and the replay of a scale table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from d3roma_tpu.ops import quant as jq
from d3roma_tpu_torch.models import layers as tl
from d3roma_tpu_torch.ops import quant as tq
from torch_port_utils import randn


def test_quantize_bit_equal_with_ties():
    """Halves (x / scale exactly k + 0.5) round to even in both; values past
    127 clip; per-channel and scalar scales."""
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127.5, 300.0, -0.0],
                    np.float32)
    x = np.concatenate([ties * 0.25, randn(0, 4000) * 3.0]).astype(np.float32)
    for scale in (0.25, 3.0 / 127, 1e-8):
        ref = np.asarray(jq.quantize_int8(jnp.asarray(x), jnp.float32(scale)))
        np.testing.assert_array_equal(tq.quantize_int8(torch.from_numpy(x), scale).numpy(), ref)
    w = randn(1, 96, 40)
    # the weight scales as the JAX package's jitted forward computes them
    ref_s = np.asarray(jax.jit(lambda a: jq.absmax_scale(a, axes=(0,)))(jnp.asarray(w)))
    ref_q = np.asarray(jq.quantize_int8(jnp.asarray(w), jnp.asarray(ref_s)))
    wq, ws = tq.quantize_weight(torch.from_numpy(w).t())
    np.testing.assert_array_equal(wq.numpy().T, ref_q)
    np.testing.assert_array_equal(ws.numpy(), ref_s.reshape(-1))


@pytest.mark.parametrize("rows", [5, 37])
def test_static_dense_matches_jax(rows):
    """int8_linear against int8_dot_general_static under the same replayed
    scale: the int32 sums exactly, the fp32 outputs to one rounding."""
    x, w = randn(2, 3, rows, 48), randn(3, 48, 24, scale=0.2)
    scale = float(np.abs(x).max() / 127 * 1.25)
    with jq.replay_act_scales([scale]):
        ref = np.asarray(jax.jit(lambda a, b: jq.int8_dot_general_static(
            a, b, (((2,), (0,)), ((), ()))))(jnp.asarray(x), jnp.asarray(w)))
    rs = jax.jit(lambda a: jq.absmax_scale(a, axes=(0,)))(jnp.asarray(w))
    acc_ref = np.asarray(lax.dot_general(
        jq.quantize_int8(jnp.asarray(x), jnp.float32(scale)), jq.quantize_int8(jnp.asarray(w), rs),
        (((2,), (0,)), ((), ())), preferred_element_type=jnp.int32))
    wq, ws = tq.quantize_weight(torch.from_numpy(w).t())
    xq = tq.quantize_int8(torch.from_numpy(x).reshape(-1, 48), scale)
    acc = tq._int_matmul_plain(xq, wq.t()).reshape(acc_ref.shape)
    np.testing.assert_array_equal(acc.numpy(), acc_ref)
    out = tq.int8_linear(torch.from_numpy(x), wq, ws, scale)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def _linear(quant="static"):
    lin = tl.Linear(16, 8)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(randn(4, 8, 16, scale=0.25)))
        lin.bias.copy_(torch.from_numpy(randn(5, 8, scale=0.1)))
    lin.quant = quant
    return lin


def test_capture_records_taps_and_runs_float():
    lin, x = _linear(), torch.from_numpy(randn(6, 3, 16))
    taps, log = [], []
    with tq.capture_act_scales(taps, shape_log=log):
        out = lin(x)
        lin(2 * x)
    assert log == [("dot", (3, 16)), ("dot", (3, 16))]
    np.testing.assert_allclose(tq.stack_taps(taps), np.abs(x.numpy()).max() / 127 * np.array([1, 2]),
                               rtol=1e-7)
    torch.testing.assert_close(out, torch.nn.functional.linear(x, lin.weight, lin.bias),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n_scales", [1, 3])
def test_replay_raises_on_short_or_long_table(n_scales):
    lin, x = _linear(), torch.from_numpy(randn(7, 3, 16))
    with pytest.raises(RuntimeError, match="replay"):
        with tq.replay_act_scales([0.05] * n_scales):
            lin(x)
            lin(x)
    assert tq.act_ctx_mode() is None  # the context is cleared after the error


def test_pins_run_float_and_consume_their_index():
    lin, x = _linear(), torch.from_numpy(randn(8, 3, 16))
    with tq.replay_act_scales([0.05, 0.04], pins=[0]):
        pinned = lin(x)
        quantized = lin(x)
    torch.testing.assert_close(pinned, torch.nn.functional.linear(x, lin.weight, lin.bias),
                               rtol=0, atol=0)
    wq, ws = tq.quantize_weight(lin.weight)
    torch.testing.assert_close(quantized, tq.int8_linear(x, wq, ws, 0.04, lin.bias),
                               rtol=0, atol=0)


def test_uncalibrated_sites_take_the_static_scale():
    assert tq.STATIC_ACT_SCALE == jq.STATIC_ACT_SCALE
    lin, x = _linear(), torch.from_numpy(randn(9, 3, 16))
    wq, ws = tq.quantize_weight(lin.weight)
    torch.testing.assert_close(lin(x), tq.int8_linear(x, wq, ws, tq.STATIC_ACT_SCALE, lin.bias),
                               rtol=0, atol=0)


def test_nested_contexts_refused():
    with tq.capture_act_scales([]):
        with pytest.raises(RuntimeError, match="nested"):
            with tq.replay_act_scales([1.0]):
                pass
