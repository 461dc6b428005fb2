"""The Winograd routing of convolutions. "wino_static": Winograd F(2x2, 3x3)
where the JAX package's fused TPU kernel would take the shape, the static
int8 conv everywhere else. "wino": Winograd at every stride-1 SAME 3x3 conv
inside the liveness cap, the float conv outside it. On the card both run
the Winograd kernel at every Winograd site (`winograd_conv`).

Port of `d3roma_tpu/ops/winograd.py`: `winograd_supported`,
`winograd_conv3x3`, `_wino_eligible` (the batch-dependent liveness cap,
with `D3ROMA_WINO_SLAB_MB` and `D3ROMA_WINO_CHUNK`), `_wino_dispatch`,
`_wino_or_fallback`, `wino_conv_general_dilated` and
`wino_static_conv_general_dilated`. The routing is
shape arithmetic only, the same in capture and replay and on every device,
so a Winograd site consumes no activation scale in either package and the
calibrated tables keep the JAX call order. A chunked site (D3ROMA_WINO_CHUNK=1
and a batch over the cap) runs as a loop over batch chunks, one kernel call
each, as the JAX package maps over them.

`D3ROMA_WINO_FUSED` has no counterpart here: on the TPU it chooses between
two implementations of the same arithmetic (the fused Pallas kernel and an
XLA formulation); on CUDA the port has one, the Winograd kernel. On the CPU
its plain version and the XLA formulation split the sites as the JAX
package's CPU run does, so the tests can hold one against the other.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch

from d3roma_tpu_torch.ops.kernels.winograd import (
    conv3x3_winograd,
    conv3x3_winograd_plain,
    pick_config,
)
from d3roma_tpu_torch.ops.quant import act_ctx_mode

# estimated V + M liveness, MB, of the JAX package's XLA formulation
_WINO_LIVENESS_CAP_MB = 3072


def winograd_supported(lhs_shape, rhs_shape, window_strides, padding) -> bool:
    """Stride-1 SAME 3x3 (rhs in HWIO order)."""
    if tuple(window_strides) != (1, 1):
        return False
    if tuple(rhs_shape[:2]) != (3, 3):
        return False
    if isinstance(padding, str):
        return padding.upper() == "SAME"
    return tuple(map(tuple, padding)) == ((1, 1), (1, 1))


def wino_eligible(lhs_shape: Sequence[int], rhs_shape: Sequence[int], window_strides,
                  padding) -> Optional[int]:
    """The batch chunk to run Winograd with, or None: B when the estimated
    liveness of B items fits the cap (D3ROMA_WINO_SLAB_MB, MB); with
    D3ROMA_WINO_CHUNK=1 the largest smaller divisor of B that fits; else
    None. NHWC lhs, HWIO rhs."""
    if not winograd_supported(lhs_shape, rhs_shape, window_strides, padding):
        return None
    B, H, W, C = lhs_shape
    cp = -(-C // 128) * 128
    op = -(-rhs_shape[3] // 128) * 128
    cap = float(os.environ.get("D3ROMA_WINO_SLAB_MB", _WINO_LIVENESS_CAP_MB))

    def fits(bc):
        return bc * H * W * (8 * cp + 16 * op) / 2**20 <= cap

    if fits(B):
        return B
    if os.environ.get("D3ROMA_WINO_CHUNK", "0") != "1":
        return None
    for bc in range(B - 1, 0, -1):
        if B % bc == 0 and fits(bc):
            return bc
    return None


def wino_static_route(lhs_shape: Sequence[int], rhs_shape: Sequence[int], window_strides,
                      padding) -> Optional[int]:
    """`_wino_or_fallback(require_fused=True)`'s decision: the batch chunk of
    a Winograd site, or None for the static int8 conv."""
    bc = wino_eligible(lhs_shape, rhs_shape, window_strides, padding)
    if bc is not None and pick_config((bc,) + tuple(lhs_shape[1:])) is None:
        return None
    return bc


def conv_hwio_shape(weight: torch.Tensor) -> Tuple[int, int, int, int]:
    """A [O, C, KH, KW] weight's shape in the JAX package's HWIO order."""
    o, c, kh, kw = weight.shape
    return (kh, kw, c, o)


def winograd_conv3x3(x: torch.Tensor, u: torch.Tensor, out_dtype: torch.dtype,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's XLA formulation of Winograd F(2x2, 3x3), as plain
    torch ops (the JAX package leaves it to XLA): x in fp32 as it is, V in
    fp32 rounded to bf16, U = winograd_weight(w) in bf16, the 16 tap
    products with fp32 sums, the output transform in fp32, one cast to
    `out_dtype`; `bias` added in that type."""
    return conv3x3_winograd_plain(x, u, out_dtype, bias, round_x=False)


def winograd_conv(x: torch.Tensor, u: torch.Tensor, out_dtype: torch.dtype,
                  bias: Optional[torch.Tensor], chunk: int) -> torch.Tensor:
    """The Winograd conv of a routed site ("wino_static" or "wino"), over
    batch chunks of `chunk`. CUDA tensors take the Winograd kernel at every
    site. Elsewhere the JAX package's own split is kept: on the CPU the
    kernel's plain version where `pick_config` admits the chunk's shape (the
    fused TPU kernel's sites) outside a calibration capture, the XLA
    formulation at the other sites, under a capture and on the meta device
    (quant_call_map's trace). The two differ only in rounding x to bf16,
    which a bf16 model's x already is."""
    if x.device.type == "cuda":
        conv = conv3x3_winograd
    elif (x.device.type == "cpu" and act_ctx_mode() != "capture"
          and pick_config((chunk,) + tuple(x.shape[1:])) is not None):
        conv = conv3x3_winograd
    else:
        conv = winograd_conv3x3
    if chunk >= x.shape[0]:
        return conv(x, u, out_dtype, bias)
    return torch.cat([conv(xc, u, out_dtype, bias) for xc in x.split(chunk)], dim=0)
