"""Dataset-quality check by photometric re-warping.

    python -m d3roma_tpu_torch.check_stereo [--dataset HISS] [--split train] [--out bad_his.txt] [--ratio 2.0] [--limit N] [--device cpu]

Port of `scripts/check_stereo.py` (reference: scripts/check_stereo.py:
104-187): for each sample, warp the right image into the left view by the
GT disparity and by the sim disparity (`ops/warp.py::warp_right_to_left`),
compare their L1 photometric losses over the GT-valid pixels, and write
the `bad_his.txt` exclusion list of the samples whose sim loss exceeds
`ratio` times the GT's. The dataset is read from its own root
(`datasets/<name>` under the working directory), as the JAX script reads
it (its `--root` flag is unused, and the port has none). Runs on CUDA
unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def check(dataset, out_file: str, ratio: float = 2.0, limit=None, device=None):
    """Returns the list of bad sample paths and writes them to out_file."""
    import torch

    from d3roma_tpu_torch.device import resolve_device
    from d3roma_tpu_torch.ops.warp import warp_right_to_left

    device = resolve_device(device)
    bad = []
    n = len(dataset) if limit is None else min(limit, len(dataset))
    for i in range(n):
        item = dataset[i]
        right = torch.from_numpy(np.asarray(item["right"], np.float32)).to(device)[None] / 255.0
        disp_gt = torch.from_numpy(np.asarray(item["disp"][..., 0], np.float32)).to(device)[None]
        valid = np.asarray(item["valid"][..., 0]) > 0

        fxb = float(item["fxb"])
        raw_depth = np.asarray(item["raw_depth"][..., 0])
        disp_sim = np.where(raw_depth > 0, fxb / np.maximum(raw_depth, 1e-6), 0.0)
        disp_sim = torch.from_numpy(disp_sim.astype(np.float32)).to(device)[None]

        w_gt = warp_right_to_left(right, disp_gt)[0].cpu().numpy()
        w_sim = warp_right_to_left(right, disp_sim)[0].cpu().numpy()
        left = np.asarray(item["left"], np.float32) / np.float32(255.0)

        loss_gt = np.abs(left - w_gt)[valid].mean() if valid.any() else 0.0
        loss_sim = np.abs(left - w_sim)[valid].mean() if valid.any() else 0.0
        print(f"[{i}] photometric L1 gt={loss_gt:.4f} sim={loss_sim:.4f} {item['path']}")
        if loss_gt > 0 and loss_sim > ratio * loss_gt:
            bad.append(item["path"])

    with open(out_file, "w") as f:
        f.write("\n".join(bad))
    print(f"{len(bad)} bad samples -> {out_file}")
    return bad


def main(argv=None) -> int:
    from d3roma_tpu_torch.config import TrainingConfig
    from d3roma_tpu_torch.data import create_dataset

    p = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.check_stereo")
    p.add_argument("--dataset", default="HISS")
    p.add_argument("--split", default="train")
    p.add_argument("--out", default="bad_his.txt")
    p.add_argument("--ratio", type=float, default=2.0)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    cfg = TrainingConfig(camera_resolution="480x270", image_size=(270, 480))
    ds = create_dataset(cfg, args.dataset, args.split)
    check(ds, args.out, args.ratio, args.limit, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
