"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version, its applicability gate and its launch counter.

- `attention.mha_attention`  <- d3roma_tpu/ops/pallas/attention.py::mha_attention
- `geglu.geglu_ff`           <- d3roma_tpu/ops/pallas/geglu.py::geglu_ff

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from d3roma_tpu_torch.ops.kernels.attention import (  # noqa: F401
    mha_attention,
    mha_attention_plain,
    mha_supported,
)
from d3roma_tpu_torch.ops.kernels.geglu import (  # noqa: F401
    geglu_ff,
    geglu_ff_plain,
    geglu_supported,
)

KERNEL_SOURCES = ("attention", "geglu")
