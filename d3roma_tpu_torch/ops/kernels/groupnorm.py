"""Fused GroupNorm + affine + SiLU: the CUDA kernel, its plain PyTorch
version, its gate, the host plan of a call and its launch counter.

Port of `d3roma_tpu/ops/pallas/groupnorm.py::fused_group_norm_silu` (kernel
body `_gn_silu_kernel`): fp32 statistics with the variance as
E[x^2] - E[x]^2 (no clamp), the normalize, the affine and the SiLU in fp32,
the output in x's type. The kernel is `csrc/groupnorm_silu.cu`, one launch on
thread block clusters; its source note says what bounds it on the H100 and
how it is built around that. `gn_plan` cuts a call into clusters (one batch
item and a band of whole groups each) and CTAs (a share of the band's
pixels each).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from d3roma_tpu_torch.ops.kernels import _build
from d3roma_tpu_torch.ops.kernels.geglu import H100_SMS
from d3roma_tpu_torch.ops.kernels.quantize import fp32

# the TPU kernel's VMEM limit on one batch item's [H, W, C] slab; the gate
# keeps it so the same sites take the kernel in both packages
_MAX_SLAB_BYTES = 4 * 1024 * 1024

# threads of a CTA, the dynamic shared memory a CTA may have (227 KB on the
# H100), the cluster sizes the kernel takes (above 8 only with the
# non-portable attribute, which the kernel sets)
GN_THREADS = 512
MAX_SMEM_BYTES = 232448
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MAX_PORTABLE_CLUSTER = 8


@dataclass(frozen=True)
class GnPlan:
    """How the CUDA kernel cuts one call. A cluster of `cluster` CTAs owns
    one batch item and a band of `k` whole groups (`band` channels, a
    multiple of 8); there are `bands` bands; a CTA takes `per` pixels (the
    last may have fewer). resident: the CTA's [per, band] tile of x stays in
    shared memory between the statistics and the normalize (x read from
    HBM once), else the normalize reads x again (from L2). smem_bytes: the
    dynamic shared memory of a CTA; ctas: all of them, B * bands * cluster."""
    k: int
    band: int
    bands: int
    cluster: int
    per: int
    resident: bool
    smem_bytes: int
    ctas: int


def gn_rows(band: int) -> int:
    """Thread rows of the kernel's statistics: each row's threads own 8
    channels each and walk every rows-th pixel (one row where a band has
    more than GN_THREADS slots of 8)."""
    slots = band // 8
    return 1 if slots >= GN_THREADS else GN_THREADS // slots


def gn_smem_bytes(per: int, band: int, k: int, itemsize: int, resident: bool) -> int:
    """A CTA's dynamic shared memory (csrc/groupnorm_silu.cu::Layout): the
    tile [per, band] in x's type (resident only, rounded up to 16 bytes), the
    rows' sums [rows, 2, band], the group partials [2, k], every rank's
    partials [16, 2, k], gamma and beta [2, band], the groups' mean and
    rsqrt(var + eps) [2, k] and the scale and shift [2, band], fp32."""
    tile = -(-per * band * itemsize // 16) * 16 if resident else 0
    return tile + 4 * (gn_rows(band) * 2 * band + 2 * k + CLUSTER_SIZES[-1] * 2 * k
                       + 2 * band + 2 * k + 2 * band)


@functools.lru_cache(maxsize=512)
def gn_plan(b: int, p: int, c: int, groups: int, itemsize: int, sms: int = H100_SMS) -> GnPlan:
    """The clusters of one call on a card with `sms` SMs, over x [b, p, c]
    (p pixels) of `itemsize` bytes an element: the band (in groups: the
    fewest that make a multiple of 8 channels, or a multiple of that), the
    cluster size and the pixels a CTA, with the least modelled time. The
    model: a CTA's time is the bytes of x it reads (its tile, twice where it
    is not resident), by waves of one CTA an SM (on the H100, more CTAs than
    SMs, though two fit an SM, ran slower: scripts/probe_groupnorm.py); a
    plan that keeps the tile resident beats one that does not, and a
    cluster of 16 (non-portable) is taken only where it holds the tiles and
    no cluster of at most 8 does. Ties go to pixel rows of at least 64 bytes
    of a band, then to smaller clusters and wider bands."""
    if c % groups or c % 8:
        raise ValueError(f"gn_plan takes C % groups == 0 and C % 8 == 0, got C={c}, "
                         f"groups={groups}")
    cg = c // groups
    k0 = 8 // math.gcd(cg, 8)  # divides groups, since groups * cg % 8 == 0
    options = []
    for k in range(k0, groups + 1, k0):
        if groups % k:
            continue
        band, bands = k * cg, groups // k
        for cs in CLUSTER_SIZES:
            per = -(-p // cs)
            if (cs - 1) * per >= p:
                continue  # a CTA would have no pixel
            for resident in (True, False):
                smem = gn_smem_bytes(per, band, k, itemsize, resident)
                if smem > MAX_SMEM_BYTES:
                    continue
                ctas = b * bands * cs
                cost = -(-ctas // sms) * per * band * itemsize * (1 if resident else 2)
                options.append((GnPlan(k, band, bands, cs, per, resident, smem, ctas),
                                (cost, -min(band * itemsize, 64), cs, -band)))
    portable = any(o.resident and o.cluster <= MAX_PORTABLE_CLUSTER for o, _ in options)
    options = [(o, key) for o, key in options
               if o.cluster <= MAX_PORTABLE_CLUSTER or (o.resident and not portable)]
    if not options:
        raise ValueError(f"no GroupNorm plan fits [{b}, {p}, {c}] in {groups} groups")
    if any(o.resident for o, _ in options):
        options = [(o, key) for o, key in options if o.resident]
    return min(options, key=lambda ok: ok[1])[0]


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
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=512)
def _launch_args(b, p, c, groups, itemsize, silu, x_bf16, gb_bf16, eps, device_index):
    """A call's plan as the int array the C entry point takes, with inv_n and
    eps as fp32: built once per call signature."""
    plan = gn_plan(b, p, c, groups, itemsize, _build.sm_count(device_index))
    values = (b, p, c, groups, plan.k, plan.cluster, plan.per, int(plan.resident), int(silu),
              int(x_bf16), int(gb_bf16))
    return (ctypes.c_int * len(values))(*values), fp32(1.0 / (p * (c // groups))), fp32(eps)


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5,
                    apply_silu: bool = True) -> torch.Tensor:
    """silu(groupnorm(x)) (or the GroupNorm alone), x [B, H, W, C] -> x's type.

    CUDA tensors go to the Hopper kernel (bf16 or fp32 x, C % 8 == 0, gamma
    and beta [C] in one type, bf16 or fp32, read as they are) or raise; CPU
    tensors take the plain version. `group_norm_silu.launches` counts the
    calls. The kernel has no gradient: CUDA inputs that need one raise."""
    if x.ndim != 4 or x.shape[-1] % groups:
        raise ValueError(f"group_norm_silu takes NHWC x with C % groups == 0, got "
                         f"{tuple(x.shape)} and {groups} groups")
    if x.device.type == "cpu":
        group_norm_silu.launches += 1
        return group_norm_silu_plain(x, gamma, beta, groups, eps, apply_silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu runs on CUDA or the CPU, got {x.device}")
    _build.refuse_grad("group_norm_silu", x, gamma, beta)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA GroupNorm kernel takes bf16 or fp32, got {x.dtype}")
    b, h, w, c = x.shape
    if c % 8:
        raise ValueError(f"the CUDA GroupNorm kernel takes C % 8 == 0, got {c}")
    if gamma.dtype != beta.dtype or gamma.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA GroupNorm kernel takes gamma and beta in one type, bf16 or "
                        f"fp32, got {gamma.dtype} and {beta.dtype}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.device != x.device or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{c}] tensor on {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    dev = x.device
    ints, inv_n, eps32 = _launch_args(b, h * w, c, groups, x.element_size(), bool(apply_silu),
                                      x.dtype == torch.bfloat16, gamma.dtype == torch.bfloat16,
                                      float(eps), dev.index)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = _library().d3r_group_norm_silu(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), ints, inv_n, eps32,
            _build.current_stream(dev))
    _build.check(err, "group_norm_silu")
    group_norm_silu.launches += 1
    return out


group_norm_silu.launches = 0
