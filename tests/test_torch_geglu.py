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


@pytest.mark.parametrize("case", ["fp32_x", "bf16_bias", "c_24", "f_96", "strided_w"])
def test_cuda_checks_refuse_what_the_kernel_cannot_take(case):
    """The checks a CUDA call meets before the launch (dtype, shape,
    contiguity; CPU tensors exercise them here)."""
    c, f = (24 if case == "c_24" else 32), (96 if case == "f_96" else 128)
    bf = torch.bfloat16
    x = torch.zeros(1, 4, c, dtype=bf)
    w1h, w1g, w2 = torch.zeros(c, f, dtype=bf), torch.zeros(c, f, dtype=bf), torch.zeros(f, c, dtype=bf)
    biases = [torch.zeros(f), torch.zeros(f), torch.zeros(c)]
    err = ValueError
    if case == "fp32_x":
        x, err = x.float(), TypeError
    elif case == "bf16_bias":
        biases[2], err = biases[2].to(bf), TypeError
    elif case == "strided_w":
        w1h = torch.zeros(f, c, dtype=bf).t()
    with pytest.raises(err):
        port_geglu._check_cuda(x, w1h, w1g, w2, biases)


def test_output_chunk_fits_shared_memory():
    """The CUDA launcher's column chunk: all of C up to 640, else the widest
    multiple of 16 dividing C (1280 -> 640, so two chunks)."""
    assert [port_geglu._output_chunk(c) for c in (32, 320, 640, 1280, 1920, 2048)] == [
        32, 320, 640, 640, 640, 512]
