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
