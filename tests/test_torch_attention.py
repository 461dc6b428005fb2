"""The port's whole-row attention wrapper (on the CPU: its plain version)
against the JAX Pallas kernel run in interpret mode, on the same numpy
inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops.pallas import attention as jax_attention
from d3roma_tpu_torch.ops.kernels import attention as port_attention
from torch_port_utils import randn

SHAPES = {
    # N = M = 600 is ragged against the TPU kernel's 128-key padding and
    # its 256-row query blocks
    "self600": (2, 600, 600, 2, 64),
    "cross300x77": (2, 300, 77, 2, 64),
}
# fp32: as tests/test_pallas_attention.py holds the TPU kernel against XLA;
# bf16: both round P and the output to bf16 (2^-8 relative), from sums
# taken in a different order
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_matches_pallas_kernel(shape, dtype):
    b, n, m, h, d = SHAPES[shape]
    q, k, v = (randn(seed, b, length, h, d) for seed, length in ((0, n), (1, m), (2, m)))
    ref = jax_attention.mha_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                                      interpret=True)
    tdt = getattr(torch, dtype)
    before = port_attention.mha_attention.launches
    out = port_attention.mha_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert port_attention.mha_attention.launches == before + 1
    assert out.dtype == tdt and tuple(out.shape) == (b, n, h, d)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_gate_matches_jax():
    """Same thresholds, so the same sites take the kernel in both packages:
    the flagship sites (3600 and 920 tokens, head dim 64), the VAE's wide
    head (int8 only), and off-menu lengths and widths."""
    for n_kv in (60, 240, 511, 512, 920, 3600, 6144, 6145, 9000):
        for head_dim in (32, 64, 128, 129, 256, 512, 640):
            for itemsize in (1, 2, 4):
                assert (port_attention.mha_supported(n_kv, head_dim, itemsize)
                        == jax_attention.mha_supported(n_kv, head_dim, itemsize))
    assert port_attention.mha_supported(3600, 64) and port_attention.mha_supported(920, 64)
    assert not port_attention.mha_supported(3600, 512)


def test_rejects_bad_inputs():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError):
        port_attention.mha_attention(q, torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64))
    with pytest.raises(TypeError):
        port_attention.mha_attention(q, q.double(), q)
    # a tensor that is neither on CUDA nor on the CPU is refused, never
    # routed to the plain version
    meta = torch.zeros(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError):
        port_attention.mha_attention(meta, meta, meta)


@pytest.mark.parametrize("case", ["fp32", "head_dim_24", "head_dim_144", "strided_d"])
def test_cuda_checks_refuse_what_the_kernel_cannot_take(case):
    """The checks a CUDA tensor meets before the launch (they read only
    dtype, shape and strides, so CPU tensors exercise them here)."""
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    if case == "fp32":
        q, err = q.float(), TypeError
    elif case.startswith("head_dim"):
        q, err = torch.zeros(1, 8, 2, int(case.split("_")[-1]), dtype=torch.bfloat16), ValueError
    else:
        q, err = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)[..., ::2], ValueError
    with pytest.raises(err):
        port_attention._check_cuda(q, q, q)
    port_attention._check_cuda(*(torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16),) * 3)


# int8: both sides quantize q, k, v per (batch, head) alike and sum exactly;
# exp differs between XLA and PyTorch in the last place, which can move
# round(127 p) by one quantum for a few keys (a change of ~1/127 of one
# key's weight in the output row)
INT8_SHAPES = {
    "self600_d64": (2, 600, 600, 2, 64),
    "cross300x77_d64": (2, 300, 77, 2, 64),
    # the VAE's one wide head (head_dim 512), ragged against 128 keys
    "wide_head_d512": (1, 520, 520, 1, 512),
}
INT8_TOL = 2e-3


@pytest.mark.parametrize("shape", list(INT8_SHAPES))
def test_int8_matches_pallas_kernel(shape):
    b, n, m, h, d = INT8_SHAPES[shape]
    q, k, v = (randn(seed, b, length, h, d) for seed, length in ((3, n), (4, m), (5, m)))
    ref = np.asarray(jax_attention.mha_attention(*map(jnp.asarray, (q, k, v)), quant="int8",
                                                 interpret=True))
    before = port_attention.mha_attention_int8.launches
    out = port_attention.mha_attention_int8(*map(torch.from_numpy, (q, k, v)))
    assert port_attention.mha_attention_int8.launches == before + 1
    assert tuple(out.shape) == (b, n, h, d)
    np.testing.assert_allclose(out.numpy(), ref, atol=INT8_TOL * np.abs(ref).max(), rtol=0)
    # and the int8 result is an int8 result: the float kernel differs from it
    # by far more than the tolerance
    f32 = np.asarray(jax_attention.mha_attention(*map(jnp.asarray, (q, k, v)), interpret=True))
    assert np.abs(f32 - ref).max() > 5 * INT8_TOL * np.abs(ref).max()


def test_int8_quantization_matches_the_tpu_wrapper():
    """Per-(batch, head) scales max(absmax, 1e-6) / 127 and rounding with no
    clip, as attention.py's wrapper (_absmax_bh) computes them."""
    x = randn(6, 2, 40, 3, 64)
    xs = jnp.swapaxes(jnp.asarray(x), 1, 2)
    s_ref = jax_attention._absmax_bh(xs)
    q_ref = np.asarray(jnp.round(xs.astype(jnp.float32) / s_ref).astype(jnp.int8))
    q, s = port_attention.quantize_per_head(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref)[..., 0, 0])
    np.testing.assert_array_equal(q.transpose(1, 2).numpy(), q_ref)


@pytest.mark.parametrize("case", ["fp32", "head_dim_48", "head_dim_640"])
def test_int8_cuda_checks_refuse_what_the_kernel_cannot_take(case):
    if case == "fp32":
        q, err = torch.zeros(1, 8, 2, 64), TypeError
    else:
        q, err = torch.zeros(1, 8, 1, int(case.split("_")[-1]), dtype=torch.bfloat16), ValueError
    with pytest.raises(err):
        port_attention._check_cuda_int8(q)
    for d in port_attention.INT8_HEAD_DIMS:
        port_attention._check_cuda_int8(torch.zeros(1, 8, 1, d, dtype=torch.bfloat16))
