"""Synthetic stereo-IR/depth generation launcher.

    python -m d3roma_tpu_torch.render_synthetic [--config conf/synthetic/hssd.yaml]
        [--backend auto|omni|sim] [key=value ...]

Port of `scripts/render_synthetic.py` (reference: isaacsim/render.py:17-48):
one command turns a YAML config into a training-ready HISS-layout tree
(color/ir_l/ir_r PNGs, depth EXRs, `meta_{seq}.json`) through the
backend-agnostic replication protocol (`synthetic/isaac/replicator.py`).
The config is read with `utils/yaml_lite.py` (PyYAML is not on the machine
with the card); overrides are dotted paths whose values are parsed the same
way, e.g. `writer_config.output_dir=/tmp/hiss seed=3`.

Backend selection (`backend:` key or --backend):
  auto  OmniBackend when Isaac Sim imports, else the procedural SimBackend;
  omni  require Isaac Sim; fail loudly when it is absent;
  sim   force the procedural renderer.

A negative seed (the committed default, -1) draws a fresh one from the OS.
After the JAX launcher's "wrote N frames" line the port prints the render's
seconds a frame.
The renderer is numpy on the host, as the JAX package's is, so the same
seed writes the same frames.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from d3roma_tpu_torch.config import CONF_DIR
from d3roma_tpu_torch.utils import yaml_lite

DEFAULT_CONFIG = os.path.join(CONF_DIR, "synthetic", "hssd.yaml")


def apply_overrides(cfg: dict, overrides) -> dict:
    """``a.b.c=value`` dotted-path overrides, values parsed as YAML
    (the launcher analog of the reference's Hydra override list,
    isaacsim/render.py:19)."""
    for item in overrides:
        if "=" not in item:
            raise SystemExit(f"override must be key=value, got {item!r}")
        path, raw = item.split("=", 1)
        node = cfg
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise SystemExit(f"cannot override through non-dict {k!r}")
        node[keys[-1]] = yaml_lite.loads(raw) if raw != "" else None
    return cfg


def build_replicator(cfg: dict, backend: str = None):
    """cfg dict -> (IsaacReplicator, seed). Free of side effects other than
    the backend's construction."""
    from d3roma_tpu_torch.synthetic.isaac import IsaacReplicator, ReplicatorConfig

    sensor = cfg.get("depth_sensor", {})
    cam = cfg.get("camera_sampling", {})
    writer = cfg.get("writer_config", {})
    scene = cfg.get("scene", {})
    layout = cfg.get("layout", {})
    W, H = sensor.get("resolution", [640, 360])
    rc = ReplicatorConfig(
        scene_usd=scene.get("usd") or "",
        cad_root=layout.get("cad_model_dir") or "",
        out_root=writer.get("output_dir", "datasets/HISS/train"),
        frames_per_surface=int(cfg.get("num_frames_per_surface", 3)),
        rt_subframes=int(cfg.get("rt_subframes", 8)),
        resolution=(W, H),
        fov_deg=float(sensor.get("fov", 71.28)),
        baseline=float(sensor.get("baseline", 0.055)),
        hemisphere_radius=tuple(cam.get("radius", (0.6, 1.4))),
        hemisphere_elevation=tuple(cam.get("elevation_deg", (20.0, 70.0))),
        material_probs=tuple(cfg.get("materials", {}).get("probs", (0.4, 0.3, 0.3))),
        max_objects=int(layout.get("max_objects", 12)),
        render_disparity=bool(writer.get("disparity", False)),
        renderer=cfg.get("launch_config", {}).get("renderer", "RayTracedLighting"),
        hide_prim_names=tuple(scene.get("hide_prims", ("ceiling", "ceilings", "wall"))),
    )

    seed = int(cfg.get("seed", -1))
    if seed < 0:  # ref :50 — negative seed = fresh randomization
        seed = int.from_bytes(os.urandom(4), "little")

    choice = backend or cfg.get("backend", "auto")
    if choice not in ("auto", "omni", "sim"):
        raise SystemExit(f"unknown backend {choice!r} (auto|omni|sim)")
    b = None
    if choice in ("auto", "omni"):
        try:
            from d3roma_tpu_torch.synthetic.isaac.backend import OmniBackend

            b = OmniBackend(
                headless=bool(cfg.get("launch_config", {}).get("headless", True)),
                rt_subframes=rc.rt_subframes,
                cad_root=rc.cad_root or None)
        except ImportError:
            if choice == "omni":
                raise
            print("# Isaac Sim not available — using the procedural SimBackend",
                  file=sys.stderr)
    if b is None:
        from d3roma_tpu_torch.synthetic.isaac.backend import SimBackend
        from d3roma_tpu_torch.synthetic.procedural import SceneConfig

        b = SimBackend(SceneConfig(height=H, width=W, fov_deg=rc.fov_deg,
                                   baseline=rc.baseline), seed=seed)
    return IsaacReplicator(rc, seed=seed, backend=b), seed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.render_synthetic",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--backend", choices=("auto", "omni", "sim"))
    ap.add_argument("overrides", nargs="*", metavar="key=value")
    args = ap.parse_args(argv)

    cfg = yaml_lite.load_file(args.config) or {}
    apply_overrides(cfg, args.overrides)

    rep, seed = build_replicator(cfg, backend=args.backend)
    max_surfaces = cfg.get("max_surfaces")
    t0 = time.perf_counter()
    n = rep.start(max_surfaces=None if max_surfaces in (None, "") else int(max_surfaces))
    print(f"wrote {n} frames (seed {seed}) -> {rep.cfg.out_root}")
    if n:
        print(f"{(time.perf_counter() - t0) / n:.4f} s/frame", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
