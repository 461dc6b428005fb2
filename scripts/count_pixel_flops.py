#!/usr/bin/env python3
"""Count the pixel UNet2D's operations and parameters at the bench's input.

    python3 scripts/count_pixel_flops.py [--height 368] [--width 640]

Builds `d3roma_tpu_torch.models.UNet2D` at its default full widths on the
meta device (no memory, no card) and runs one forward with hooks that add
up the multiply-adds of every convolution, dense layer and self-attention
(2 x output elements x contraction length; attention 2 x 2 x B x N^2 x C),
one image. Prints one JSON line: TFLOP a forward by kind, their sum, and
the parameter count. A measurement aid for PERF.md: the bench's pixel line
carries no FLOP count, as the JAX package's carries none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=368)
    ap.add_argument("--width", type=int, default=640)
    args = ap.parse_args()
    import torch

    from d3roma_tpu_torch.models import UNet2D, pixel_in_channels
    from d3roma_tpu_torch.models.layers import Conv2d, Linear, SelfAttention2D

    unet = UNet2D(pixel_in_channels("rgb+raw", 1), 1, device="meta")
    flops = {"conv": 0, "dense": 0, "attention": 0}

    def conv(m, a, out):
        flops["conv"] += 2 * out.numel() * a[0].shape[-1] * m.kernel_size[0] * m.kernel_size[1]

    def dense(m, a, out):
        flops["dense"] += 2 * out.numel() * m.in_features

    def attention(m, a, out):
        b, h, w, c = a[0].shape
        flops["attention"] += 2 * 2 * b * (h * w) ** 2 * c

    for mod in unet.modules():
        for cls, hook in ((Conv2d, conv), (Linear, dense), (SelfAttention2D, attention)):
            if isinstance(mod, cls):
                mod.register_forward_hook(hook)
    x = torch.empty(1, args.height, args.width, unet.in_channels, device="meta")
    with torch.no_grad():
        unet(x, torch.zeros(1, dtype=torch.long, device="meta"))
    print(json.dumps({"height": args.height, "width": args.width,
                      "tflop_per_image_forward": {k: v / 1e12 for k, v in flops.items()},
                      "tflop_total": sum(flops.values()) / 1e12,
                      "params_millions": sum(p.numel() for p in unet.parameters()) / 1e6}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
