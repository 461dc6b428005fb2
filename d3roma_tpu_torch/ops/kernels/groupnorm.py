"""Fused GroupNorm + affine + SiLU: the CUDA kernel, its plain PyTorch
version, its gate and its launch counter.

Port of `d3roma_tpu/ops/pallas/groupnorm.py::fused_group_norm_silu` (kernel
body `_gn_silu_kernel`): fp32 statistics with the variance as
E[x^2] - E[x]^2 (no clamp), the normalize, the affine and the SiLU in fp32,
the output in x's type. The kernel is `csrc/groupnorm_silu.cu`; its source
note says what bounds it on the H100 and how it is built around that.
"""

from __future__ import annotations

import ctypes

import torch

from d3roma_tpu_torch.ops.kernels import _build
from d3roma_tpu_torch.ops.kernels.quantize import fp32

# the TPU kernel's VMEM limit on one batch item's [H, W, C] slab; the gate
# keeps it so the same sites take the kernel in both packages
_MAX_SLAB_BYTES = 4 * 1024 * 1024
# pixels per block of the statistics and normalize passes: about 16K
# elements a block
_CHUNK_ELEMS = 16384


def group_norm_silu_supported(shape, dtype) -> bool:
    """The JAX package's gate, unchanged: 4-d x whose [H, W, C] slab of one
    batch item is at most 4 MiB in x's own dtype."""
    if len(shape) != 4:
        return False
    _, h, w, c = shape
    return h * w * c * torch.empty((), dtype=dtype).element_size() <= _MAX_SLAB_BYTES


def group_norm_silu_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                          groups: int = 32, eps: float = 1e-5,
                          apply_silu: bool = True) -> torch.Tensor:
    """The TPU kernel's arithmetic in PyTorch: per-(batch, group) fp32 sums of
    x and x^2 times 1 / n, var = E[x^2] - mean^2, scale = rsqrt(var + eps)
    * gamma, shift = beta - mean * scale, y = x * scale + shift in fp32,
    y * sigmoid(y), cast to x's type. x [B, H, W, C]; gamma, beta [C]."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, groups, c // groups)
    inv_n = fp32(1.0 / (h * w * (c // groups)))
    mean = xf.sum(dim=(1, 3)) * inv_n                      # [B, G]
    ex2 = xf.square().sum(dim=(1, 3)) * inv_n
    var = ex2 - mean * mean
    scale = torch.rsqrt(var + fp32(eps))[..., None] * gamma.float().view(groups, -1)
    shift = beta.float().view(groups, -1) - mean[..., None] * scale
    y = x.float() * scale.reshape(b, 1, 1, c) + shift.reshape(b, 1, 1, c)
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load("groupnorm_silu")
    fn = lib.d3r_group_norm_silu
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5,
                    apply_silu: bool = True) -> torch.Tensor:
    """silu(groupnorm(x)) (or the GroupNorm alone), x [B, H, W, C] -> x's type.

    CUDA tensors go to the Hopper kernel (bf16 or fp32 x, C % 8 == 0) or
    raise; CPU tensors take the plain version. `group_norm_silu.launches`
    counts the calls."""
    if x.ndim != 4 or x.shape[-1] % groups:
        raise ValueError(f"group_norm_silu takes NHWC x with C % groups == 0, got "
                         f"{tuple(x.shape)} and {groups} groups")
    if x.device.type == "cpu":
        group_norm_silu.launches += 1
        return group_norm_silu_plain(x, gamma, beta, groups, eps, apply_silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu runs on CUDA or the CPU, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA GroupNorm kernel takes bf16 or fp32, got {x.dtype}")
    b, h, w, c = x.shape
    if c % 8:
        raise ValueError(f"the CUDA GroupNorm kernel takes C % 8 == 0, got {c}")
    x = x.contiguous()
    p = h * w
    chunk = max(1, min(p, _CHUNK_ELEMS // c))
    chunks = -(-p // chunk)
    dev = x.device
    gamma32, beta32 = (t.to(device=dev, dtype=torch.float32).contiguous() for t in (gamma, beta))
    part = torch.empty((b, chunks, 2, c), dtype=torch.float32, device=dev)
    ss = torch.empty((b, 2, c), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = _library().d3r_group_norm_silu(
            x.data_ptr(), gamma32.data_ptr(), beta32.data_ptr(), part.data_ptr(),
            ss.data_ptr(), out.data_ptr(), b, p, c, groups, chunk,
            fp32(1.0 / (p * (c // groups))), fp32(eps), int(apply_silu),
            int(x.dtype == torch.bfloat16), _build.current_stream(dev))
    _build.check(err, "group_norm_silu")
    group_norm_silu.launches += 1
    return out


group_norm_silu.launches = 0
