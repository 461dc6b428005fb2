"""Single-frame inference demo of the port (the counterpart of the
repository's inference.py).

    python -m d3roma_tpu_torch.demo [--variant rgb+raw|left+right+raw]
        [--assets DIR] [--pretrained DIR] [--device D] [overrides...]

Runs `D3RoMa` on the bundled example frame (`assets/examples/0000_*`, made
procedurally when missing) and writes, under `_outputs.<variant>/`,
`pred.png` (Spectral colour map), `pred.ply` and `raw.ply`, and for rgb+raw
`raw_aligned.png`, the raw depth moved into the colour frame (reference:
inference.py:253-322). The demo's defaults (the variant's eval preset,
360x640, 10 steps) come before the caller's overrides, so those win. Runs on
CUDA unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

logger = logging.getLogger("d3roma_tpu_torch.demo")

_REPO_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "assets", "examples")
DEFAULT_ASSET_DIRS = ("assets/examples", _REPO_ASSETS)


def find_assets(explicit=None) -> str:
    """The first directory holding `0000_rgb.png`: `explicit`, then
    ./assets/examples, then the repository's; else a procedural frame is
    written to the repository's."""
    for d in ([explicit] if explicit else []) + list(DEFAULT_ASSET_DIRS):
        if d and os.path.exists(os.path.join(d, "0000_rgb.png")):
            return d
    from d3roma_tpu_torch.synthetic import generate_example_assets

    logger.info("generating procedural demo assets -> %s", _REPO_ASSETS)
    return generate_example_assets(_REPO_ASSETS)


def _read_gray(path: str) -> np.ndarray:
    from d3roma_tpu_torch.utils.png import read_png

    img = read_png(path)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"{path}: an IR frame is a one-channel 8-bit PNG, got "
                         f"{img.dtype} {img.shape}")
    return img


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.demo")
    p.add_argument("--variant", default="rgb+raw", choices=["rgb+raw", "left+right+raw"])
    p.add_argument("--assets", default=None)
    p.add_argument("--pretrained", default=None,
                   help="pipeline directory (task.resume_pretrained)")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("overrides", nargs="*", default=[])
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from d3roma_tpu_torch.inference import D3RoMa
    from d3roma_tpu_torch.streaming.sources import read_depth_png, read_rgb
    from d3roma_tpu_torch.utils.camera import Realsense
    from d3roma_tpu_torch.utils.pointcloud import backproject_depth, write_ply
    from d3roma_tpu_torch.utils.resize import INTER_LINEAR, INTER_NEAREST, resize
    from d3roma_tpu_torch.utils.viz import save_colorized

    camera = Realsense.default_real("fxm")
    preset = "task=eval_ldm_mixed_rgb+raw" if args.variant == "rgb+raw" else "task=eval_ldm_mixed"
    overrides = [preset, "task.image_size=[360,640]",
                 "task.num_inference_timesteps=10"] + list(args.overrides)
    if args.pretrained:
        overrides.append(f"task.resume_pretrained={args.pretrained}")
    droma = D3RoMa(overrides, camera, variant=args.variant, device=args.device)

    assets = find_assets(args.assets)
    rgb = read_rgb(os.path.join(assets, "0000_rgb.png"))
    depth_m = read_depth_png(os.path.join(assets, "0000_depth.png"))
    out_dir = droma.eval_output_dir
    if args.variant == "rgb+raw":
        # the raw depth moved into the colour frame (reference: inference.py:290-298)
        raw_src = camera.transform_depth_to_rgb_frame(depth_m)
        save_colorized(os.path.join(out_dir, "raw_aligned.png"), raw_src)
        pred_depth = droma.infer_with_rgb_raw(rgb, raw_src)
    else:
        raw_src = depth_m
        pred_depth = droma.infer(_read_gray(os.path.join(assets, "0000_ir_l.png")),
                                 _read_gray(os.path.join(assets, "0000_ir_r.png")),
                                 raw_depth=depth_m, rgb=rgb)
    save_colorized(os.path.join(out_dir, "pred.png"), pred_depth)

    # both clouds with the colour intrinsics, from what the model consumed
    K = camera.K.arr
    size = camera.resolution[::-1]
    rgb_resized = resize(rgb, size, interpolation=INTER_LINEAR)
    raw_resized = resize(raw_src, size, interpolation=INTER_NEAREST)
    write_ply(os.path.join(out_dir, "raw.ply"), *backproject_depth(raw_resized, K, rgb_resized))
    write_ply(os.path.join(out_dir, "pred.ply"), *backproject_depth(pred_depth, K, rgb_resized))
    logger.info("wrote %s/{pred.png, pred.ply, raw.ply}", out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
