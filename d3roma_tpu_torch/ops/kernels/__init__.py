"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version, its applicability gate and its launch counter.

- `attention.mha_attention`       <- d3roma_tpu/ops/pallas/attention.py::mha_attention (bf16)
- `attention.mha_attention_int8`  <- the same, quant="int8"
- `geglu.geglu_ff`                <- d3roma_tpu/ops/pallas/geglu.py::geglu_ff (bf16)
- `geglu.geglu_ff_int8`           <- the same, quant="static"
- `conv2d.conv2d_int8`            <- d3roma_tpu/ops/pallas/conv2d.py::conv3x3_flat
                                     (quant="static"), conv3x3_rowtap and
                                     conv2d_halo.py::conv3x3_halo (int8), at
                                     every static int8 conv (epilogues "xla",
                                     "tpu", "halo")
- `conv2d.conv2d_int8_dynamic`    <- no Pallas kernel: the XLA int8 convolution and dot of
                                     the dynamic modes (d3roma_tpu/ops/quant.py::
                                     int8_conv_general_dilated, int8_dot_general)
- `conv2d.conv2d_bf16`            <- the same conv3x3_flat and conv3x3_halo, bf16
- `conv2d.conv3x3_flat`, `conv3x3_rowtap`, `conv3x3_halo`
                                  <- the JAX entry points of those kernels
- `quantize.quantize_int8_scalar` <- the XLA quantization in front of the int8 ops
- `groupnorm.group_norm_silu`     <- d3roma_tpu/ops/pallas/groupnorm.py::fused_group_norm_silu
- `winograd.conv3x3_winograd`     <- d3roma_tpu/ops/pallas/winograd_fused.py::conv3x3_wino_fused
- `attention_fused.fused_self_attention_int8`
                                  <- d3roma_tpu/ops/pallas/attention_fused.py::fused_self_attention
                                     (quant="static")
- `attention_fused.fused_self_attention_bf16`
                                  <- the same, quant=None

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from d3roma_tpu_torch.ops.kernels.attention_fused import (  # noqa: F401
    fused_attention_supported,
    fused_self_attention_bf16,
    fused_self_attention_bf16_plain,
    fused_self_attention_int8,
    fused_self_attention_int8_plain,
)
from d3roma_tpu_torch.ops.kernels.attention import (  # noqa: F401
    mha_attention,
    mha_attention_int8,
    mha_attention_int8_plain,
    mha_attention_plain,
    mha_supported,
)
from d3roma_tpu_torch.ops.kernels.conv2d import (  # noqa: F401
    conv2d_bf16,
    conv2d_bf16_plain,
    conv2d_int8,
    conv2d_int8_dynamic,
    conv2d_int8_dynamic_plain,
    conv2d_int8_plain,
    conv3x3_flat,
    conv3x3_halo,
    conv3x3_rowtap,
    conv3x3_rowtap_supported,
    conv3x3_supported,
    halo_conv_supported,
)
from d3roma_tpu_torch.ops.kernels.geglu import (  # noqa: F401
    geglu_ff,
    geglu_ff_int8,
    geglu_ff_int8_plain,
    geglu_ff_plain,
    geglu_supported,
)
from d3roma_tpu_torch.ops.kernels.groupnorm import (  # noqa: F401
    group_norm_silu,
    group_norm_silu_plain,
    group_norm_silu_supported,
)
from d3roma_tpu_torch.ops.kernels.quantize import (  # noqa: F401
    quantize_int8_plain,
    quantize_int8_scalar,
)
from d3roma_tpu_torch.ops.kernels.winograd import (  # noqa: F401
    conv3x3_winograd,
    conv3x3_winograd_plain,
    winograd_weight,
)

KERNEL_SOURCES = ("attention", "geglu", "attention_int8", "geglu_int8", "conv2d_int8",
                  "quantize", "groupnorm_silu", "winograd_fused", "attention_fused_int8",
                  "conv2d_bf16", "attention_fused_bf16")
