"""The port's fused GroupNorm + SiLU (on the CPU: its plain version) against
the JAX Pallas kernel in interpret mode; its gate against the JAX gate; and
GroupNormSiLU's unfused branch, which a shape over the gate takes, against
the JAX module's XLA composition."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.models.layers import GroupNormSiLU as JaxGroupNormSiLU
from d3roma_tpu.ops.pallas import groupnorm as jax_gn
from d3roma_tpu_torch.models.layers import GroupNormSiLU
from d3roma_tpu_torch.ops.kernels import groupnorm as port_gn
from torch_port_utils import randn

# fp32: the same sums in another order (the TPU kernel sums rows, then folds
# channels to groups by a one-hot product); bf16 outputs: one bf16 ulp (at
# most 2^-7 of the value) where the fp32 values straddle a rounding boundary
FP32_TOL = 1e-5
BF16_ULP = 2.0 ** -7


def _inputs(shape, groups):
    c = shape[-1]
    x = randn(0, *shape) * 2.0 + 0.5
    gamma = 1.0 + 0.1 * randn(1, c)
    beta = 0.1 * randn(2, c)
    return x, gamma, beta


@pytest.mark.parametrize("shape,groups,silu", [
    ((2, 6, 10, 64), 32, True),
    ((1, 5, 7, 96), 8, True),     # odd H and W, 12 channels per group
    ((2, 4, 4, 32), 4, False),    # the GroupNorm alone
])
def test_plain_matches_pallas_kernel_fp32(shape, groups, silu):
    x, gamma, beta = _inputs(shape, groups)
    ref = jax_gn.fused_group_norm_silu(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                                       groups, 1e-5, silu, interpret=True)
    before = port_gn.group_norm_silu.launches
    out = port_gn.group_norm_silu(torch.from_numpy(x), torch.from_numpy(gamma),
                                  torch.from_numpy(beta), groups, 1e-5, silu)
    assert port_gn.group_norm_silu.launches == before + 1
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL, rtol=FP32_TOL)


def test_plain_matches_pallas_kernel_bf16():
    x, gamma, beta = _inputs((2, 9, 12, 64), 32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax_gn.fused_group_norm_silu(xb, jnp.asarray(gamma), jnp.asarray(beta),
                                                  32, 1e-5, True, interpret=True), np.float32)
    out = port_gn.group_norm_silu(torch.from_numpy(np.array(xb.astype(jnp.float32)))
                                  .to(torch.bfloat16), torch.from_numpy(gamma),
                                  torch.from_numpy(beta), 32, 1e-5, True)
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref)
    assert np.all(err <= BF16_ULP * np.abs(ref) + 1e-6), err.max()


@pytest.mark.parametrize("shape,dtype", [
    ((2, 45, 80, 320), "bfloat16"), ((2, 23, 40, 1920), "bfloat16"),
    ((2, 12, 20, 1280), "bfloat16"), ((4, 45, 80, 512), "bfloat16"),
    ((4, 90, 160, 512), "bfloat16"), ((2, 45, 80, 320), "float32"),
    ((1, 64, 64, 256), "bfloat16"), ((1, 64, 64, 257), "bfloat16"),
    ((1, 64, 64, 128), "float32"), ((1, 64, 65, 128), "float32"), ((64, 64), "float32"),
])
def test_gate_matches_jax(shape, dtype):
    assert port_gn.group_norm_silu_supported(shape, getattr(torch, dtype)) == \
        jax_gn.group_norm_silu_supported(shape, getattr(jnp, dtype))


def test_fallback_over_the_gate_matches_jax_xla_branch():
    """A [H, W, C] slab just over 4 MiB in fp32 takes the unfused branch
    even with `fused` set, in both packages (the JAX module is off the TPU,
    so it takes its XLA branch anyway): the same arithmetic in fp32."""
    shape = (1, 32, 64, 544)  # 32 * 64 * 544 * 4 bytes > 4 MiB
    assert not port_gn.group_norm_silu_supported(shape, torch.float32)
    x, gamma, beta = _inputs(shape, 32)
    mod = GroupNormSiLU(shape[-1], 32, 1e-5)
    mod.fused = True
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(gamma))
        mod.bias.copy_(torch.from_numpy(beta))
    before = port_gn.group_norm_silu.launches
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    assert port_gn.group_norm_silu.launches == before
    jmod = JaxGroupNormSiLU(32, 1e-5, fused=True)
    ref = jmod.apply({"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}},
                     jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    assert jax.default_backend() != "tpu"
