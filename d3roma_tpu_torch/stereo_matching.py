"""Offline "sim depth" generation over a dataset tree.

    python -m d3roma_tpu_torch.stereo_matching ROOT [--fx 446.31] [--baseline 0.055]
        [--min-disp 10] [--max-disp 110] [--block 11] [--beta 100] [--batch 4]
        [--overwrite] [--device cpu]

Port of `scripts/stereo_matching.py` (reference: scripts/stereo_matching.py:
521-618): walks ROOT for `*_ir_l.png` / `*_ir_r.png` pairs, runs the NCC
block matcher (`ops/stereo.py`) on `--batch` frames at a time, and writes
`*_simDepthImage.exr` (metric depth, 0 where invalid) and
`*_simDispImage.png` (disparity clipped to 0..255, uint8) next to the
inputs; a pair whose depth file exists is skipped unless `--overwrite`.
Defaults are the reference HISS run's: fx=446.31, baseline=0.055,
maxDisp=110, block=11. The IR frames must be 8-bit gray PNGs (the port's
IR files are); a colour or 16-bit file is refused, since OpenCV's
grayscale conversion is not reproduced. Runs on CUDA unless `--device`
names another device.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np


def read_ir(path: str) -> np.ndarray:
    """An 8-bit gray PNG as float32 in [0, 1] (`cv2.IMREAD_GRAYSCALE` / 255
    for such a file)."""
    from d3roma_tpu_torch.utils.png import read_png

    img = read_png(path)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"{path}: an 8-bit gray PNG is required, got {img.dtype} of shape "
                         f"{img.shape}")
    return img.astype(np.float32) / 255.0


def find_pairs(root: str, overwrite: bool):
    """(left, right, depth out) paths of every pair still to process."""
    pairs = []
    for lf in sorted(glob.glob(os.path.join(root, "**/*_ir_l.png"), recursive=True)):
        rf = lf.replace("_ir_l.png", "_ir_r.png")
        out = lf.replace("_ir_l.png", "_simDepthImage.exr")
        if os.path.exists(rf) and (overwrite or not os.path.exists(out)):
            pairs.append((lf, rf, out))
    return pairs


def main(argv=None) -> int:
    import torch

    from d3roma_tpu_torch.device import resolve_device
    from d3roma_tpu_torch.ops.stereo import stereo_match
    from d3roma_tpu_torch.utils.exr import write_exr
    from d3roma_tpu_torch.utils.png import write_png

    p = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.stereo_matching")
    p.add_argument("root", help="dataset tree containing *_ir_l.png pairs")
    p.add_argument("--fx", type=float, default=446.31)
    p.add_argument("--baseline", type=float, default=0.055)
    p.add_argument("--min-disp", type=int, default=10)
    p.add_argument("--max-disp", type=int, default=110)
    p.add_argument("--block", type=int, default=11)
    p.add_argument("--beta", type=float, default=100.0)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    pairs = find_pairs(args.root, args.overwrite)
    print(f"{len(pairs)} pairs to process", flush=True)
    fxb = args.fx * args.baseline
    t0 = time.perf_counter()
    for i in range(0, len(pairs), args.batch):
        chunk = pairs[i: i + args.batch]
        L = torch.from_numpy(np.stack([read_ir(lf) for lf, _, _ in chunk]))[..., None]
        R = torch.from_numpy(np.stack([read_ir(rf) for _, rf, _ in chunk]))[..., None]
        out = stereo_match(L.to(device), R.to(device), fxb, args.min_disp, args.max_disp,
                           args.block, args.beta)
        depth = out.depth.cpu().numpy()
        disp = out.disp.cpu().numpy()
        for j, (_, _, out_path) in enumerate(chunk):
            write_exr(out_path, depth[j].astype(np.float32))
            write_png(out_path.replace("_simDepthImage.exr", "_simDispImage.png"),
                      np.clip(disp[j], 0, 255).astype(np.uint8))
        print(f"[{i + len(chunk)}/{len(pairs)}] wrote {len(chunk)} sim depth maps", flush=True)
    if pairs:
        print(f"{(time.perf_counter() - t0) / len(pairs):.4f} s/frame", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
