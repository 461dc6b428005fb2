"""Per-stage golden dump/compare for checkpoint-parity forensics.

Port of `d3roma_tpu/evaluation/golden.py`, with the same files: `dump()`
saves deterministic per-stage intermediates of a latent pipeline (the VAE
condition latents, the UNet's output at a fixed t, one DDIM step, the
decoded x̂₀ and the text embedding) as `golden_stages.npz` with a
`golden_manifest.json`; `compare()` recomputes them and reports per-stage
max-abs / rel deltas in pipeline order, so the first failing stage
localizes a divergence.

The JAX package draws the probe inputs (rgb, raw, x_t) from
`jax.random`, which the port cannot reproduce. The dump holds them, so
`compare` takes them from the dump and recomputes every later stage from
there: a dump either package wrote is compared by either package. `dump`
draws its inputs from a `torch.Generator` seeded with `seed` (on the
CPU): other numbers than the JAX package's for the same seed, in the same
layout and ranges.

Stage semantics mirror the deployed pipeline (no act-scale replay, as in
the JAX package):
- vae encode = `encode_image_to_latent`'s scaled latents (0.18215),
- unet out at mid-trajectory t on [x_t, cond latents] channel concat,
- one ddim_step at (t -> t_prev) incl. pred_original_sample,
- vae decode of pred x̂₀, channel-mean.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from d3roma_tpu_torch.models.vae import decode_latent, encode_image_to_latent
from d3roma_tpu_torch.ops.scheduler_step import ddim_step

STAGES = ("rgb", "raw", "lat_rgb", "lat_raw", "x_t", "unet_out",
          "sched_prev", "sched_x0", "decoded", "text_embed")


def _probe_ts(pipe):
    """Probe (t, t_prev) at mid-trajectory, valid for any schedule length."""
    T = int(pipe.spec.schedule.num_train_timesteps)
    t = T // 2
    return t, max(t - max(1, T // 10), 0)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def stage_outputs(pipe, rgb: np.ndarray, raw: np.ndarray, x_t: np.ndarray,
                  cond_channels: str = "rgb+raw") -> Dict[str, np.ndarray]:
    """Per-stage intermediates of `pipe` from the probe inputs rgb [1,H,W,3],
    raw [1,H,W,1] (in [-1, 1]) and x_t [1,H/8,W/8,4]. Keys: STAGES."""
    if cond_channels != "rgb+raw":
        raise ValueError("golden probe currently covers the flagship rgb+raw variant")
    t, t_prev = _probe_ts(pipe)
    dev = pipe.device
    rgb_t = torch.as_tensor(rgb, dtype=torch.float32).to(dev)
    raw_t = torch.as_tensor(raw, dtype=torch.float32).to(dev)
    x = torch.as_tensor(x_t, dtype=torch.float32).to(dev)
    unet_dtype = next(pipe.unet.parameters()).dtype
    with torch.no_grad():
        lat_rgb = encode_image_to_latent(pipe.vae, rgb_t)
        lat_raw = encode_image_to_latent(pipe.vae, raw_t.repeat(1, 1, 1, 3))
        model_input = torch.cat([x, lat_rgb.float(), lat_raw.float()], dim=-1).to(unet_dtype)
        ctx = pipe.text_embed.to(unet_dtype)
        unet_out = pipe.unet(model_input, torch.full((1,), t, device=dev), ctx)
        s = ddim_step(pipe._tables, pipe.spec.schedule, unet_out.float(), t, t_prev, x)
        decoded = decode_latent(pipe.vae, s.pred_original_sample)
    return {
        "rgb": np.asarray(rgb, np.float32), "raw": np.asarray(raw, np.float32),
        "lat_rgb": _host(lat_rgb), "lat_raw": _host(lat_raw), "x_t": np.asarray(x_t, np.float32),
        "unet_out": _host(unet_out), "sched_prev": _host(s.prev_sample),
        "sched_x0": _host(s.pred_original_sample), "decoded": _host(decoded),
        "text_embed": _host(pipe.text_embed),
    }


def probe_inputs(H: int, W: int, seed: int, factor: int = 8):
    """(rgb, raw, x_t) drawn from a CPU torch.Generator seeded with `seed`,
    in the JAX probe's ranges: rgb uniform in [-1, 1), raw in [-0.9, 0.9),
    x_t standard normal at the latent size (the VAE downsamples by
    `factor`)."""
    g = torch.Generator().manual_seed(seed)
    rgb = (torch.rand((1, H, W, 3), generator=g) - 0.5) * 2.0
    raw = (torch.rand((1, H, W, 1), generator=g) - 0.5) * 1.8
    x_t = torch.randn((1, H // factor, W // factor, 4), generator=g)
    return rgb.numpy(), raw.numpy(), x_t.numpy()


def dump(pipe, out_dir: str, H: int = 64, W: int = 96, seed: int = 0,
         cond_channels: str = "rgb+raw", inputs=None) -> str:
    """Save the stage outputs + a manifest under `out_dir`; returns the
    npz path. `inputs` (rgb, raw, x_t) replaces the seeded draw: the JAX
    package's compare accepts a dump only on its own probe inputs for the
    manifest's seed, which it draws again."""
    os.makedirs(out_dir, exist_ok=True)
    if inputs is None:
        inputs = probe_inputs(H, W, seed, factor=2 ** (len(pipe.vae.block_out_channels) - 1))
    outs = stage_outputs(pipe, *inputs, cond_channels=cond_channels)
    t, t_prev = _probe_ts(pipe)
    npz = os.path.join(out_dir, "golden_stages.npz")
    np.savez_compressed(npz, **outs)
    with open(os.path.join(out_dir, "golden_manifest.json"), "w") as f:
        json.dump({
            "H": H, "W": W, "seed": seed, "t": t, "t_prev": t_prev,
            "cond_channels": cond_channels,
            "stages": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in outs.items()},
        }, f, indent=2)
    return npz


def compare(pipe, dump_dir: str, atol: float = 5e-2) -> Dict[str, dict]:
    """Recompute the stages with `pipe` from the dump's own inputs and diff
    against the dump under `dump_dir`. Returns {stage: {max_abs, rel, ok}}
    ordered by pipeline stage. `atol` is relative to each stage's max |ref|
    and loose by default (bf16 pipelines vs f32 dumps)."""
    with open(os.path.join(dump_dir, "golden_manifest.json")) as f:
        man = json.load(f)
    ref = dict(np.load(os.path.join(dump_dir, "golden_stages.npz")))
    outs = stage_outputs(pipe, ref["rgb"], ref["raw"], ref["x_t"], man["cond_channels"])
    report = {}
    for k in STAGES:
        a, b = outs[k], ref[k]
        if a.shape != b.shape:
            report[k] = {"ok": False, "error": f"shape {list(a.shape)} vs {list(b.shape)}"}
            continue
        d = np.abs(a - b)
        scale = max(float(np.abs(b).max()), 1e-6)
        report[k] = {"max_abs": float(d.max()), "rel": float(d.max() / scale),
                     "ok": bool(d.max() <= atol * scale)}
    return report
