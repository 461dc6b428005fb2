#!/usr/bin/env python3
"""Time the port's PNG decoder (d3roma_tpu_torch/utils/png.py) on the host.

    python3 scripts/time_png_decode.py [--reps N] [PNG ...]

Decodes each file N times (default: assets/examples/0000_rgb.png, a
640x360 RGB frame written by OpenCV's cv2.imwrite, which chose the Sub
filter for every row), then the same pixels re-encoded by the port with
each of the five row filters forced, so that the Average and Paeth rows
(reconstructed over the image's anti-diagonals) are timed on any machine.
Prints one JSON line: the median ms of each decode, the filters each file
uses, and the host's CPU count. Imports numpy and zlib only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from d3roma_tpu_torch.utils import png  # noqa: E402

DEFAULT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "assets", "examples", "0000_rgb.png")
FILTERS = ("none", "sub", "up", "average", "paeth")


def _median_ms(data: bytes, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        png.decode_png(data)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("files", nargs="*", default=[DEFAULT])
    args = parser.parse_args(argv)
    rows = {}
    for path in args.files:
        with open(path, "rb") as f:
            data = f.read()
        img = png.decode_png(data)
        used = np.bincount(png.row_filters(data), minlength=5)
        rows[os.path.relpath(path)] = {
            "shape": list(img.shape), "filters": {FILTERS[i]: int(n) for i, n in enumerate(used)
                                                  if n},
            "ms": _median_ms(data, args.reps)}
        for i, name in enumerate(FILTERS):
            forced = png.encode_png(img if img.ndim == 2 or img.shape[2] == 3 else img[..., :3], i)
            rows[f"{os.path.basename(path)} re-encoded, {name}"] = {
                "ms": _median_ms(forced, args.reps)}
    print(json.dumps({"png_decode_ms": rows, "reps": args.reps, "cpus": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
