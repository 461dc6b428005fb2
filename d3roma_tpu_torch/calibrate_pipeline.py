"""Calibrate a pipeline directory's static-int8 activation scales.

    python -m d3roma_tpu_torch.calibrate_pipeline PIPELINE_DIR \
        [--frames 4] [--image-size 360x640] [--steps 10] [--batches 2] \
        [--cond-channels rgb+raw] [--margin 1.25] [--seed 0] [--out DIR] [--device cpu]

Port of `scripts/calibrate_pipeline.py`: runs the capture passes
(`GuidedLatentDiffusionPipeline.calibrate`) on procedural frames from
`--seed`, the raw condition normalized with the pipeline's own normalizer
(the input range the serving path feeds), and writes `act_scales.json`
(tables "unet", "unet_cached", "vae_encode", "vae_decode") into the
pipeline directory or `--out`. `from_pretrained`, and so `serve`, `demo`
and `evaluate` on that directory, replay the per-layer scales under
`fast_inference("throughput")`.

One difference from the JAX script, which calibrates the pipeline as
loaded: the capture runs under `fast_inference("throughput")`, the
configuration that replays the tables. A directory saved without the
fused feed-forward (a training export) visits two dense sites where the
fused GEGLU takes one scale, so the as-loaded tables do not fit the
throughput call (the port's replay refuses them; the JAX replay would
misassign every later scale). For a directory saved in that configuration
the two captures visit the same sites. The initial noise of each batch
comes from one torch generator seeded with `--seed` on the device. Runs on
CUDA unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

import numpy as np


def calibration_batches(pipe, height: int, width: int, frames: int, batches: int,
                        seed: int) -> List[dict]:
    """`batches` batches of max(1, frames // batches) procedural frames: rgb in
    [-1, 1] and the raw disparity through `pipe.normalizer`, on the
    pipeline's device."""
    import torch

    from d3roma_tpu_torch.synthetic.procedural import ProceduralSceneRenderer, SceneConfig

    renderer = ProceduralSceneRenderer(SceneConfig(height=height, width=width), seed=seed)
    per_batch = max(1, frames // batches)
    out = []
    for _ in range(batches):
        rgbs, raws = [], []
        for _ in range(per_batch):
            f = renderer.render()
            rgbs.append((f["rgb"].astype(np.float32) / 255.0 - 0.5) * 2.0)
            disp = np.where(f["sim_depth"] > 0,
                            f["fxb"] / np.maximum(f["sim_depth"], 1e-6), 0.0)
            raws.append(disp[..., None].astype(np.float32))
        disp_b = torch.from_numpy(np.stack(raws)).to(pipe.device)
        normalized, _, _ = pipe.normalizer.normalize(disp_b, disp_b > 0)
        out.append(dict(rgb_images=torch.from_numpy(np.stack(rgbs)).to(pipe.device),
                        sim_disp=normalized))
    return out


def main(argv=None) -> int:
    import torch

    from d3roma_tpu_torch.device import resolve_device
    from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline

    p = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.calibrate_pipeline")
    p.add_argument("pipeline_dir")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--batches", type=int, default=2)
    p.add_argument("--image-size", default="360x640", help="HxW")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--cond-channels", default="rgb+raw")
    p.add_argument("--margin", type=float, default=1.25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    H, W = (int(v) for v in args.image_size.split("x"))
    pipe = GuidedLatentDiffusionPipeline.from_pretrained(args.pipeline_dir, device=device)
    pipe.fast_inference("throughput")
    batches = calibration_batches(pipe, H, W, args.frames, args.batches, args.seed)
    pipe.calibrate(torch.Generator(device=device).manual_seed(args.seed), batches,
                   cond_channels=args.cond_channels, num_inference_steps=args.steps,
                   margin=args.margin)
    path = os.path.join(args.out or args.pipeline_dir, "act_scales.json")
    with open(path, "w") as f:
        json.dump(pipe.act_scales, f)
    sizes = {k: len(v) for k, v in pipe.act_scales.items()}
    print(f"wrote {path} ({sizes})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
