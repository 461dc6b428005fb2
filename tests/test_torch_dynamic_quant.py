"""The dynamic int8 ops of quant=True / "all" / "dense" (the port's
`int8_linear_dynamic` and `int8_conv_dynamic`, whose CPU path is the plain
version of the dynamic int8 conv kernel) against the JAX package's jitted
`int8_dot_general` and `int8_conv_general_dilated` (XLA's int8 dot and
convolution): per-row and per-batch-item activation scales
max(absmax * fp32(1/127), 1e-8), per-output-channel weight scales, exact
int32 sums, (acc * s) * ws in fp32. Bit-equal, in fp32 and in bf16, with
rows and items of different absmax and an all-zero item."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops import quant as jq
from d3roma_tpu_torch.ops.kernels import conv2d_int8_dynamic
from d3roma_tpu_torch.ops.kernels.quantize import dynamic_scale_plain
from d3roma_tpu_torch.ops.quant import int8_conv_dynamic, int8_linear_dynamic, quantize_weight
from torch_port_utils import randn

DTYPES = {"fp32": (np.float32, torch.float32, jnp.float32),
          "bf16": (np.float32, torch.bfloat16, jnp.bfloat16)}


def _items(x: np.ndarray, zero_last: bool) -> np.ndarray:
    """Scale item i of x by 1 + i (each item its own absmax); zero the last."""
    x = x * np.arange(1, x.shape[0] + 1, dtype=np.float32).reshape((-1,) + (1,) * (x.ndim - 1))
    if zero_last:
        x[-1] = 0.0
    return x.astype(np.float32)


def _pair(a: np.ndarray, dtype: str):
    _, tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def test_dynamic_scale_is_the_jitted_jax_form():
    """absmax * fp32(1/127), not absmax / 127: the jitted JAX scale (XLA
    turns the division by a constant into that product), bit for bit, at
    100k absmax values and at 0 (the 1e-8 floor)."""
    m = np.concatenate([np.random.RandomState(0).rand(100_000).astype(np.float32) * 10,
                        np.zeros(3, np.float32)])
    ref = np.asarray(jax.jit(lambda a: jq.absmax_scale(a, axes=(1,)))(jnp.asarray(m[:, None])))
    got = dynamic_scale_plain(torch.from_numpy(m[:, None]), (1,)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got[:-3, 0], np.maximum(m[:-3] / np.float32(127), 1e-8))


CONV_CASES = {
    "3x3 stride 1": ((3, 9, 11, 32), 48, 3, 1, 1),
    "3x3 stride 2": ((2, 10, 12, 64), 40, 3, 2, 1),
    "3x3 stride 2 valid": ((2, 11, 13, 32), 24, 3, 2, 0),
    "1x1": ((2, 7, 9, 32), 24, 1, 1, 0),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_dynamic_conv_matches_jax(case, dtype):
    """int8_conv_dynamic (NHWC x, weight [Cout, KH, KW, Cin]) against the
    jitted int8_conv_general_dilated (HWIO): bit-equal, the last batch item
    all zeros; and the wrapper counts its call."""
    shape, cout, k, stride, pad = CONV_CASES[case]
    x = _items(randn(1, *shape), zero_last=True)
    w = randn(2, k, k, shape[-1], cout, scale=(k * k * shape[-1]) ** -0.5)
    xt, xj = _pair(x, dtype)
    wt, wj = _pair(w, dtype)
    ref = jax.jit(lambda a, b: jq.int8_conv_general_dilated(
        a, b, (stride, stride), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")))(xj, wj)
    wq, ws = quantize_weight(wt.permute(3, 0, 1, 2))
    before = conv2d_int8_dynamic.launches
    got = int8_conv_dynamic(xt, wq, ws, None, stride, pad)
    assert conv2d_int8_dynamic.launches == before + 1
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    assert np.abs(np.asarray(ref, np.float32)[-1]).max() == 0.0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rows", [4, 37])
def test_dynamic_dense_matches_jax(rows, dtype):
    """int8_linear_dynamic against the jitted int8_dot_general (flax
    Dense's pattern), one scale a row: bit-equal at 4 rows (the
    cross-attention's key and value projections of a 2-token context at
    batch 2) and 37, one row all zeros; the bias added after the cast, as
    Flax adds it."""
    x = _items(randn(3, rows, 96), zero_last=True).reshape(1, rows, 96)
    w, b = randn(4, 96, 40, scale=0.1), randn(5, 40, scale=0.1)
    xt, xj = _pair(x, dtype)
    wt, wj = _pair(w, dtype)
    bt, bj = _pair(b, dtype)
    ref = jax.jit(lambda a, k: jq.int8_dot_general(a, k, (((2,), (0,)), ((), ()))))(xj, wj) + bj
    wq, ws = quantize_weight(wt.t())
    got = int8_linear_dynamic(xt, wq, ws, bt)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
