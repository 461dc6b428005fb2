"""Divisibility padding for arbitrary input sizes.

Port of `d3roma_tpu/ops/padding.py`: the channel-last equivalent of the
reference's `InputPadder` (reference: utils_d3roma/utils.py:297-325) on
NHWC torch tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class InputPadder:
    """Pads [B, H, W, C] images so H and W are divisible by `divis_by`."""

    def __init__(self, dims, mode: str = "sintel", divis_by: int = 8):
        # dims may be a full NHWC shape or a bare (H, W)
        if len(dims) >= 3:
            self.ht, self.wd = int(dims[-3]), int(dims[-2])
        else:
            self.ht, self.wd = int(dims[0]), int(dims[1])
        pad_ht = (((self.ht // divis_by) + 1) * divis_by - self.ht) % divis_by
        pad_wd = (((self.wd // divis_by) + 1) * divis_by - self.wd) % divis_by
        if mode == "sintel":
            # (left, right, top, bottom)
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2)
        else:
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht)

    @property
    def padded_size(self):
        return (
            self._pad[2] + self._pad[3] + self.ht,
            self._pad[0] + self._pad[1] + self.wd,
        )

    def _apply(self, inputs, mode: str):
        out = []
        for x in inputs:
            if x is None:
                out.append(None)
                continue
            if x.ndim != 4:
                raise ValueError("expected B,H,W,C")
            if not any(self._pad):
                out.append(x)
                continue
            # F.pad pads the last dims first: NHWC -> NCHW for H and W
            y = F.pad(x.permute(0, 3, 1, 2), self._pad, mode=mode)
            out.append(y.permute(0, 2, 3, 1))
        return out

    def pad(self, *inputs):
        """Replicate-pad NHWC tensors (None passthrough)."""
        return self._apply(inputs, "replicate")

    def pad_zero(self, *inputs):
        return self._apply(inputs, "constant")

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 4:
            raise ValueError("expected B,H,W,C")
        ht, wd = x.shape[1], x.shape[2]
        l, r, t, b = self._pad
        return x[:, t: ht - b, l: wd - r, :]
