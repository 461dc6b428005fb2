"""SceneFlow raw-disparity quality filter.

    python -m d3roma_tpu_torch.check_sceneflow [--root datasets/SceneFlow]
        [--dstype frames_cleanpass] [--out bad_his.txt] [--threshold 0.2] [--limit N]

Port of `scripts/check_sceneflow.py` (reference: scripts/check_sceneflow.py:
54-86): per frame, the precision (the fraction of valid raw pixels within
1 px of GT) and recall (the fraction of GT pixels covered by valid raw) of
the precomputed SGM disparity against ground truth; frames with precision
under the threshold go into the `bad_his.txt` exclusion list read at
dataset load. Host numpy only: no device work.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np


def check(pairs, out_file: str, precision_threshold: float = 0.2, px: float = 1.0):
    """pairs: list of (left_png_path, gt_disp, sim_disp) arrays or paths."""
    from d3roma_tpu_torch.utils import frame_utils

    bad = []
    for item in pairs:
        path, gt, sim = item
        if isinstance(gt, str):
            gt = np.asarray(frame_utils.read_gen(gt), np.float32)
        if isinstance(sim, str):
            sim = np.asarray(frame_utils.read_gen(sim), np.float32)
        valid_sim = (sim > 0) & np.isfinite(sim)
        valid_gt = (gt > 0) & np.isfinite(gt)
        close = np.abs(sim - gt) < px
        tp = (valid_sim & valid_gt & close).sum()
        precision = tp / max(1, valid_sim.sum())
        recall = tp / max(1, valid_gt.sum())
        print(f"precision={precision:.3f} recall={recall:.3f} {path}")
        if precision < precision_threshold:
            bad.append(path)
    with open(out_file, "w") as f:
        f.write("\n".join(bad))
    print(f"{len(bad)} bad frames -> {out_file}")
    return bad


def find_pairs(root: str, dstype: str, limit=None):
    """(left png, GT disparity pfm, raw disparity pfm) of every frame under
    root whose two disparity files exist."""
    lefts = sorted(glob.glob(os.path.join(root, "**", dstype, "**/left/*.png"), recursive=True))
    if limit:
        lefts = lefts[:limit]
    pairs = []
    for lf in lefts:
        gt = lf.replace(dstype, "disparity").replace(".png", ".pfm")
        sim = lf.replace(dstype, dstype.replace("frames", "raw")).replace(".png", ".pfm")
        if os.path.exists(gt) and os.path.exists(sim):
            pairs.append((lf, gt, sim))
    return pairs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.check_sceneflow")
    p.add_argument("--root", default="datasets/SceneFlow")
    p.add_argument("--dstype", default="frames_cleanpass")
    p.add_argument("--out", default="bad_his.txt")
    p.add_argument("--threshold", type=float, default=0.2)
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    check(find_pairs(args.root, args.dstype, args.limit), args.out, args.threshold)
    return 0


if __name__ == "__main__":
    sys.exit(main())
