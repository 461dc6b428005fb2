"""Port of `d3roma_tpu/synthetic/isaac/replicator.py`: the same seed and
configuration write the same files and `meta_{seq}.json`.

Isaac replicator orchestration (backend-agnostic).

Full rebuild of the reference's scene replication protocol
(reference: isaacsim/render.py:17-48, isaacsim/replicator.py:38-153,
isaacsim/replicate/scene_replicator.py:137-433,
isaacsim/replicate/std_object.py:18-322):

per support surface —
  1. spawn randomized objects and settle physics until quiet,
  2. sample DREDS materials (diffuse/specular/transparent),
  3. sample hemisphere camera poses around the surface's OBB top face,
  4. write meta_{seq}.json with the model list + domain randomization,
  5. GT pass: opaque bindings, 2 frames per step ticked "gt" (the GtWriter
     suppresses the duplicate), depth (+optional disparity) EXRs,
  6. photo pass: randomized materials, alternating "rgb"/"ir" ticks with
     the IR projector toggled off/on, color PNG + grayscale stereo-IR PNGs.

All omni.* interaction lives behind the backend (backend.py); with
SimBackend the whole protocol executes hermetically and produces actual
HISS-layout files.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from d3roma_tpu_torch.synthetic.isaac.geometry import (
    camera_orbit_poses,
    surface_center_from_obb,
)
from d3roma_tpu_torch.synthetic.isaac.dreds_protocol import (
    dreds_select_models,
    sample_lighting,
    tick_intensities,
)
from d3roma_tpu_torch.synthetic.isaac.materials import (
    sample_material_spec,
    sample_scene_materials,
)
from d3roma_tpu_torch.synthetic.isaac.writers import (
    ColorWriter,
    FileBackend,
    FrameTicker,
    GtWriter,
    IRWriter,
)


@dataclasses.dataclass
class ReplicatorConfig:
    """(analog of isaacsim/config/hssd.yaml)"""

    scene_usd: str = ""
    cad_root: str = ""  # DREDS CAD models
    out_root: str = "datasets/HISS/train"
    frames_per_surface: int = 16
    rt_subframes: int = 32
    resolution: Tuple[int, int] = (640, 360)  # (W, H)
    fov_deg: float = 71.28
    baseline: float = 0.055
    hemisphere_radius: Tuple[float, float] = (0.6, 1.4)
    hemisphere_elevation: Tuple[float, float] = (20.0, 70.0)
    material_probs: Tuple[float, float, float] = (0.4, 0.3, 0.3)  # diffuse/specular/transparent
    max_objects: int = 12
    # model selection: "uniform" = n iid draws from the catalog;
    # "dreds" = the DREDS per-scene class-structured protocol
    # (dreds_protocol.dreds_select_models: guaranteed transparent-capable
    # instances, 1-4 named, 1-3 distractors, per-class scale ranges and
    # the mixed-mode material draw)
    selection: str = "dreds"
    # scene-light DR: candidate light types, each with its own
    # geometry/intensity tables (dreds_protocol.LIGHT_TABLES; the
    # reference config enables Sphere)
    light_types: Tuple[str, ...] = ("Sphere",)
    render_disparity: bool = False
    renderer: str = "RayTracedLighting"  # or "PathTracing" for the photo pass
    hide_prim_names: Tuple[str, ...] = ("ceiling", "ceilings", "wall")

    @property
    def depth_sensor_cfg(self) -> dict:
        return {
            "fov": self.fov_deg,
            "resolution": list(self.resolution),
            "clipping_range": [0.1, 10.0],
            "placement": {"rgb_to_left_ir": -self.baseline / 2,
                          "rgb_to_right_ir": self.baseline / 2},
        }


class IsaacReplicator:
    """Backend-agnostic replicator. With no backend given, constructs the
    real OmniBackend — which fails cleanly when Isaac Sim is absent."""

    def __init__(self, cfg: ReplicatorConfig, seed: int = 0, backend=None):
        if backend is None:
            from d3roma_tpu_torch.synthetic.isaac.backend import OmniBackend

            backend = OmniBackend(rt_subframes=cfg.rt_subframes)
        self.cfg = cfg
        self.backend = backend
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------ #
    def start(self, max_surfaces: Optional[int] = None) -> int:
        """Run the full replication protocol; returns frames written."""
        cfg, b = self.cfg, self.backend
        if cfg.scene_usd:
            b.load_stage(cfg.scene_usd)
        b.hide_prims(cfg.hide_prim_names)
        b.create_stereo_rig(cfg.depth_sensor_cfg)

        surfaces = b.find_surfaces()
        if max_surfaces is not None:
            surfaces = surfaces[:max_surfaces]

        os.makedirs(cfg.out_root, exist_ok=True)
        files = FileBackend(cfg.out_root)
        next_seq = 0
        for surface in surfaces:
            next_seq = self._replicate_surface(surface, files, next_seq)
        b.close()
        return next_seq

    # ------------------------------------------------------------------ #
    def _replicate_surface(self, surface, files: FileBackend, next_seq: int) -> int:
        cfg, b, rng = self.cfg, self.backend, self.rng
        centroid, axes, half_extent, category = surface
        anchor, obb_meta = surface_center_from_obb(centroid, axes, half_extent)

        models = None
        if cfg.selection == "dreds":
            from d3roma_tpu_torch.synthetic.isaac.assets import scan_cad_catalog

            catalog = scan_cad_catalog(cfg.cad_root)
            if catalog:
                models = dreds_select_models(rng, catalog)
        if models is not None:
            objects = b.spawn_objects(surface, len(models), rng,
                                      models=models)
            # material classes come from the protocol draw; only the
            # per-material parameter DR remains to sample
            specs = [sample_material_spec(rng, m["material_type"])
                     for m in models]
        else:
            n_obj = int(rng.integers(1, cfg.max_objects + 1))
            objects = b.spawn_objects(surface, n_obj, rng)
            specs = sample_scene_materials(rng, len(objects),
                                           cfg.material_probs)
        b.settle_physics(objects)

        # per-scene lighting DR (std_object.py:25-55); the per-tick
        # intensity sequences follow scene_replicator.py:319-326
        lighting = sample_lighting(rng, cfg.light_types)
        if hasattr(b, "create_scene_light"):
            b.create_scene_light(lighting, anchor)
        scene_seq, env_seq = tick_intensities(lighting,
                                              cfg.frames_per_surface)
        poses = camera_orbit_poses(
            rng, anchor, cfg.frames_per_surface,
            cfg.hemisphere_radius, cfg.hemisphere_elevation,
        )

        # meta_{seq}.json: model list + DR params (std_object.py:221-227)
        files.write_json(f"meta_{next_seq}.json", {
            "surface": {"category": category,
                        "position": [float(x) for x in anchor]},
            "models": [{"name": str(o), "material": s["class"], "spec": _jsonable(s)}
                       for o, s in zip(objects, specs)],
            "domain_randomization": {
                "selection": cfg.selection if models is not None else "uniform",
                "material_probs": list(cfg.material_probs),
                "hemisphere_radius": list(cfg.hemisphere_radius),
                "hemisphere_elevation": list(cfg.hemisphere_elevation),
                "lighting": lighting,
            },
        })

        ticker = FrameTicker()
        gt_writer = GtWriter(
            files, ticker, start_sequence_id=next_seq,
            render_disparity=cfg.render_disparity,
            depth_sensor_cfg=cfg.depth_sensor_cfg if cfg.render_disparity else None,
        )
        color_writer = ColorWriter(files, ticker, start_sequence_id=next_seq)
        ir_writer = IRWriter(files, ticker, start_sequence_id=next_seq)

        # ---- GT pass: opaque bindings; 2 ticks per step (std_object.py:278-283)
        b.bind_materials(objects, specs, opaque=True)
        b.set_renderer_mode("RayTracedLighting")
        ticker.phase = "gt"
        for i in range(2 * cfg.frames_per_surface):
            if i % 2 == 0:
                ticker.step += 1
                b.set_camera_pose(*poses[i // 2])
            gt_writer.write(b.render("gt"))

        # ---- photo pass: randomized materials, rgb (projector off) then
        # ir (projector on) per step (std_object.py:296-319)
        b.bind_materials(objects, specs, opaque=False)
        b.set_renderer_mode(cfg.renderer)
        for i in range(2 * cfg.frames_per_surface):
            if hasattr(b, "set_scene_light_tick"):
                b.set_scene_light_tick(scene_seq[i], env_seq[i])
            if i % 2 == 0:
                ticker.phase = "rgb"
                b.set_projector(False)
                b.set_camera_pose(*poses[i // 2])
                color_writer.write(b.render("rgb"))
            else:
                ticker.phase = "ir"
                b.set_projector(True)
                ticker.step += 1
                ir_writer.write(b.render("ir"))

        return next_seq + cfg.frames_per_surface


def _jsonable(spec: dict) -> dict:
    return {k: (list(v) if isinstance(v, tuple) else v) for k, v in spec.items()}
