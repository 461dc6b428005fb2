"""Port of `d3roma_tpu/synthetic/isaac/backend.py`. `SimBackend` renders
through the port's `synthetic/procedural.py` (the same seed gives the same
frames); `OmniBackend` is copied with its imports inside its methods.

Rendering backends for the Isaac replicator.

The orchestration in replicator.py is written against this small interface
so that everything except the actual omni.* calls is executable and
testable anywhere:

- OmniBackend  — the real Isaac Sim implementation (import-gated; mirrors
  reference isaacsim/replicator.py:38-153, scene_replicator.py:231-431).
- SimBackend   — an in-repo implementation on top of the procedural
  renderer (synthetic/procedural.py). It honors the same protocol —
  surfaces, physics settle, material binding semantics (transparent objects
  vanish from the photo-pass raw sensor, GT pass binds opaque), stereo rig,
  projector toggling — so `IsaacReplicator.start()` runs end-to-end in CI
  and produces real HISS-layout files.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class SurfaceOBB(Tuple):
    """(centroid [3], axes [3,3], half_extent [3], category str)."""


def strip_alpha(img: np.ndarray) -> np.ndarray:
    """RGBA annotator output -> RGB (replicator's rgb annotator returns
    HxWx4 uint8; the writers store 3-channel PNGs —
    reference custom_writer.py:52-58 via BasicWriter.write_image)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 4:
        return img[..., :3]
    return img


class OmniBackend:
    """Isaac-Sim-backed implementation. Construction fails cleanly without
    an Isaac install.

    Driven immediate-mode: the orchestration (replicator.py) calls
    set_camera_pose/set_projector/render per step, so poses are applied
    directly instead of pre-registered `rep.distribution.sequence` tables
    (the reference pre-registers the whole sweep under
    `rep.trigger.on_frame`, scene_replicator.py:334-362 — same omni
    surface, stepwise control). All pose/intrinsics/material math lives in
    the pure helpers (geometry.py, materials.py, assets.py) and is
    unit-tested without Isaac.
    """

    def __init__(self, headless: bool = True, rt_subframes: int = 32,
                 cad_root: Optional[str] = None,
                 pattern_path: Optional[str] = None,
                 projector_intensity: float = 3000.0):
        try:
            from isaacsim import SimulationApp  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "Isaac Sim is not installed; use SimBackend (procedural "
                "renderer) or d3roma_tpu_torch.synthetic.procedural.generate_dataset"
            ) from e
        from isaacsim import SimulationApp

        self._app = SimulationApp({"headless": headless})
        import omni.replicator.core as rep
        from omni.isaac.core import World

        self._rep = rep
        self._world = World()
        self._rt_subframes = rt_subframes
        rep.settings.carb_settings("/omni/replicator/RTSubframes", rt_subframes)
        self._cad_root = cad_root
        self._pattern_path = pattern_path or os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "pattern.png")
        self._projector_intensity = projector_intensity
        self._placement = None
        self._cams = {}
        self._annotators = {}
        self._projector = None
        self._spawned: Dict[str, tuple] = {}  # name -> (prim, rigid, model)
        self._original_materials: Dict[str, list] = {}

    # -- scene ----------------------------------------------------- #
    def load_stage(self, usd_path: str) -> None:  # pragma: no cover - Isaac only
        from omni.isaac.core.utils.stage import open_stage

        open_stage(usd_path)

    def hide_prims(self, name_substrings: Sequence[str]) -> None:  # pragma: no cover
        """Hide ceilings/walls etc. (reference: isaacsim/replicator.py:126-153)."""
        import omni.usd
        from pxr import UsdGeom

        stage = omni.usd.get_context().get_stage()
        for prim in stage.Traverse():
            name = prim.GetName().lower()
            if any(s in name for s in name_substrings):
                UsdGeom.Imageable(prim).MakeInvisible()

    def find_surfaces(self) -> List[tuple]:  # pragma: no cover - Isaac only
        """Support surfaces as OBB tuples (reference computes OBBs with
        omni.isaac.core.utils.bounds; the top-face math lives in
        geometry.surface_center_from_obb)."""
        import omni.usd
        from omni.isaac.core.utils.bounds import compute_obb, create_bbox_cache

        stage = omni.usd.get_context().get_stage()
        bb_cache = create_bbox_cache()
        out = []
        for prim in stage.Traverse():
            name = prim.GetName().lower()
            if any(k in name for k in ("table", "desk", "counter", "shelf")):
                centroid, axes, half_extent = compute_obb(bb_cache, prim.GetPrimPath())
                out.append((centroid, axes, half_extent, name))
        return out

    def spawn_objects(self, surface, n: int, rng,
                      models=None) -> List[str]:  # pragma: no cover
        """Drop CAD models above the surface with physics enabled
        (reference: std_object.py:118-143 — create_prim from the instance
        USD with a per-class scale, wrap in RigidPrim scattered around the
        surface anchor, enable rigid body + collision, register with the
        scene). `models` (a dreds_protocol.dreds_select_models list)
        overrides the uniform per-object sampling."""
        import omni.usd
        from omni.isaac.core.prims.rigid_prim import RigidPrim
        from omni.isaac.core.utils import prims
        from omni.isaac.core.utils.rotations import euler_angles_to_quat
        from pxr import Sdf, UsdPhysics, UsdShade

        from d3roma_tpu_torch.synthetic.isaac.assets import sample_cad_models
        from d3roma_tpu_torch.synthetic.isaac.dreds_protocol import sample_placement
        from d3roma_tpu_torch.synthetic.isaac.geometry import surface_center_from_obb

        centroid, axes, half_extent = surface[0], surface[1], surface[2]
        anchor, _ = surface_center_from_obb(centroid, axes, half_extent)
        if models is None:
            models = sample_cad_models(rng, self._cad_root, n)
        if not models:
            raise RuntimeError(
                f"no CAD assets found under cad_root={self._cad_root!r} "
                "(DREDS layout: <root>/<class>/<instance>/*.usd)")
        names = []
        for model in models:
            # globally-unique spawn ordinal: instance_id restarts at 0
            # per spawn call, so prim paths would collide across calls
            self._spawn_seq = getattr(self, "_spawn_seq", 0) + 1
            prim_name = f"model_{self._spawn_seq}_{model['class_name']}"
            prim = prims.create_prim(
                prim_path=f"/World/{model['class_name']}_{self._spawn_seq}",
                usd_path=f"file://{model['instance_path']}",
                semantic_label=prim_name,
                scale=[model["scale"]] * 3,
            )
            pos, euler = sample_placement(rng, anchor,
                                          model["instance_id"])
            rigid = RigidPrim(
                prim_path=str(prim.GetPrimPath()),
                name=model["instance_name"],
                position=pos,
                orientation=euler_angles_to_quat(list(euler)),
            )
            rigid.enable_rigid_body_physics()
            UsdPhysics.CollisionAPI.Apply(prim)
            self._world.scene.add(rigid)
            # disable shader opacity so the GT depth pass sees full
            # geometry (std_object.py:145-151)
            for mesh in self._child_meshes(prim):
                mat, _ = UsdShade.MaterialBindingAPI(mesh).ComputeBoundMaterial()
                shader = UsdShade.Shader(
                    omni.usd.get_shader_from_material(mat, get_prim=True))
                shader.CreateInput("enable_opacity", Sdf.ValueTypeNames.Bool)
                shader.GetInput("enable_opacity").Set(False)
            self._spawned[model["instance_name"]] = (prim, rigid, model)
            names.append(model["instance_name"])
        return names

    @staticmethod
    def _child_meshes(prim):  # pragma: no cover - Isaac only
        """All Mesh prims under `prim` (reference:
        utils_func.get_all_child_mesh, isaacsim/utils_func.py:9-40)."""
        from pxr import UsdGeom

        out = []
        stack = [prim]
        while stack:
            p = stack.pop()
            if p.IsA(UsdGeom.Mesh):
                out.append(p)
            stack.extend(p.GetChildren())
        return out

    def settle_physics(self, objects, max_rounds: int = 10, steps: int = 250,
                       vel_eps: float = 1e-3) -> bool:  # pragma: no cover
        """Step physics until every spawned rigid body is quiet
        (reference: std_object.py:244-259 — the spawn-time RigidPrim
        handles are polled for linear velocity)."""
        rigids = [self._spawned[o][1] for o in objects if o in self._spawned]
        for _ in range(max_rounds):
            for _ in range(steps):
                self._world.step(render=False)
            if all(np.linalg.norm(r.get_linear_velocity()) <= vel_eps
                   for r in rigids):
                return True
        return False

    def bind_materials(self, objects, specs, opaque: bool) -> None:  # pragma: no cover
        """OmniPBR/OmniGlass binding per DREDS spec (reference:
        std_object.py:154-213). opaque=True restores the original
        bindings so the GT depth pass sees every object."""
        import omni.usd
        from pxr import Sdf, UsdShade

        stage = self._world.stage
        if opaque:
            for name, bindings in self._original_materials.items():
                prim = self._spawned[name][0]
                for mesh, mat in bindings:
                    UsdShade.MaterialBindingAPI(mesh).Bind(
                        mat, UsdShade.Tokens.strongerThanDescendants)
            self._original_materials.clear()
            return

        for name, spec in zip(objects, specs):
            prim = self._spawned[name][0]
            meshes = self._child_meshes(prim)
            if spec["class"] == "transparent":
                # bind a fresh OmniGlass material (std_object.py:155-166),
                # remembering the originals for the next GT pass
                saved = []
                for mesh in meshes:
                    mat, _ = UsdShade.MaterialBindingAPI(mesh).ComputeBoundMaterial()
                    saved.append((mesh, mat))
                self._original_materials[name] = saved
                mtl_path = omni.usd.get_stage_next_free_path(
                    stage, "/World/Looks/OmniGlass", False)
                glass = self._create_mdl_material("OmniGlass.mdl", "OmniGlass",
                                                  mtl_path)
                shader = UsdShade.Shader(
                    omni.usd.get_shader_from_material(glass, get_prim=True))
                for key, vt in (("glass_ior", Sdf.ValueTypeNames.Float),
                                ("thin_walled", Sdf.ValueTypeNames.Bool)):
                    if key in spec:
                        shader.CreateInput(key, vt)
                        shader.GetInput(key).Set(spec[key])
                for mesh in meshes:
                    UsdShade.MaterialBindingAPI(mesh).Bind(
                        glass, UsdShade.Tokens.strongerThanDescendants)
            elif spec["class"] == "specular":
                # tune the bound material's metallic/roughness inputs
                # in-place (std_object.py:167-210)
                for mesh in meshes:
                    mat, _ = UsdShade.MaterialBindingAPI(mesh).ComputeBoundMaterial()
                    shader = UsdShade.Shader(
                        omni.usd.get_shader_from_material(mat, get_prim=True))
                    for key in ("metallic_constant",
                                "reflection_roughness_constant"):
                        shader.CreateInput(key, Sdf.ValueTypeNames.Float)
                        shader.GetInput(key).Set(spec[key])
                    UsdShade.MaterialBindingAPI(mesh).Bind(
                        mat, UsdShade.Tokens.strongerThanDescendants)
            # diffuse: keep the asset's own material (std_object.py:211-213)

    def _create_mdl_material(self, mdl_url: str, mtl_name: str,
                             mtl_path: str):  # pragma: no cover - Isaac only
        """CreateMdlMaterialPrim (reference: scene_replicator.py:231-247)."""
        import omni.kit.commands
        from pxr import UsdShade

        omni.kit.commands.execute(
            "CreateMdlMaterialPrim", mtl_url=mdl_url, mtl_name=mtl_name,
            mtl_path=mtl_path)
        return UsdShade.Material(self._world.stage.GetPrimAtPath(mtl_path))

    def create_stereo_rig(self, sensor_cfg: dict) -> None:  # pragma: no cover
        """RGB + left/right IR cameras (shared intrinsics incl. the
        vertical-aperture hack), per-camera render products + annotators,
        and the IR pattern-projector rect light
        (reference: scene_replicator.py:364-431)."""
        import omni.kit.commands
        from pxr import Sdf, UsdGeom

        from d3roma_tpu_torch.synthetic.isaac.geometry import stereo_rig_camera_params

        rep = self._rep
        self._placement = sensor_cfg["placement"]
        p = stereo_rig_camera_params(sensor_cfg)
        cam_kwargs = dict(focal_length=p["focal_length"],
                          clipping_range=p["clipping_range"],
                          horizontal_aperture=p["horizontal_aperture"])
        self._cams = {
            "rgb": rep.create.camera(name="CameraRGB", **cam_kwargs),
            "left": rep.create.camera(name="Camera01", **cam_kwargs),
            "right": rep.create.camera(name="Camera02", **cam_kwargs),
        }
        # vertical-aperture hack (scene_replicator.py:387-394)
        for prim_name in ("CameraRGB", "Camera01", "Camera02"):
            prim = self._world.stage.GetPrimAtPath(
                f"/Replicator/{prim_name}_Xform/{prim_name}")
            prim.GetAttribute("verticalAperture").Set(p["vertical_aperture"])

        rps = {k: rep.create.render_product(c, p["resolution"])
               for k, c in self._cams.items()}
        ann = rep.AnnotatorRegistry
        self._annotators = {
            "rgb": ann.get_annotator("rgb"),
            "left": ann.get_annotator("rgb"),
            "right": ann.get_annotator("rgb"),
            "depth": ann.get_annotator("distance_to_image_plane"),
        }
        self._annotators["rgb"].attach([rps["rgb"]])
        self._annotators["left"].attach([rps["left"]])
        self._annotators["right"].attach([rps["right"]])
        self._annotators["depth"].attach([rps["rgb"]])

        # IR pattern projector: rect light + isProjector attribute
        # (scene_replicator.py:396-431)
        self._projector = rep.create.light(
            light_type="Rect", intensity=0, exposure=0.0, color=(1, 0, 0),
            position=(0.0, 0.0, 0.0), scale=(1, 1, 1), count=1,
            texture=f"file://{self._pattern_path}", name="RectLight",
        )
        prim_path = "/Replicator/RectLight_Xform/RectLight"
        rect = self._world.stage.GetPrimAtPath(prim_path)
        if not rect.GetAttribute("xformOp:scale"):
            UsdGeom.Xformable(rect).AddScaleOp()
        rect.GetAttribute("xformOp:scale").Set((1.532075471 * 1.1, 1.1 * 1.1, 1))
        if not rect.GetAttribute("isProjector"):
            omni.kit.commands.execute(
                "CreateUsdAttribute", prim=rect, attr_name="isProjector",
                attr_type=Sdf.ValueTypeNames.Bool, attr_value=True)
        omni.kit.commands.execute(
            "ChangeProperty", prop_path=Sdf.Path(prim_path + ".isProjector"),
            value=True, prev=False)

    def set_camera_pose(self, pos, quat) -> None:  # pragma: no cover
        """Apply one hemisphere pose to the whole rig: IR cameras and
        projector offset along the camera x-axis, Isaac prim-frame euler
        conversion in geometry.rig_pose_from_camera (reference:
        scene_replicator.py:283-331)."""
        from d3roma_tpu_torch.synthetic.isaac.geometry import rig_pose_from_camera

        rep = self._rep
        rig = rig_pose_from_camera(pos, quat, self._placement)
        for name in ("rgb", "left", "right"):
            with self._cams[name]:
                rep.modify.pose(
                    position=tuple(rig[name]["position"]),
                    rotation=tuple(rig[name]["euler_deg"]))
        with self._projector:
            rep.modify.pose(
                position=tuple(rig["projector"]["position"]),
                rotation=tuple(rig["projector"]["euler_deg"]))

    def set_projector(self, on: bool) -> None:  # pragma: no cover
        """Projector toggling — intensity sequence [0, I] in the reference
        (scene_replicator.py:319-339)."""
        with self._projector:
            self._rep.modify.attribute(
                "intensity", self._projector_intensity if on else 0)

    def create_scene_light(self, lighting: dict, anchor) -> None:  # pragma: no cover
        """Per-scene DR light `lighting.height` above the surface anchor
        + the distant environment light (reference: std_object.py:25-55,
        84-90; tables in dreds_protocol.LIGHT_TABLES)."""
        rep = self._rep
        lt = lighting["type"]
        self._scene_light = rep.create.light(
            light_type=lt, intensity=lighting["intensity"][0],
            color=(1.0, 1.0, 1.0),
            position=(float(anchor[0]), float(anchor[1]),
                      float(anchor[2]) + lighting.get("height", 2.0)),
            name=f"{lt}Light",
        )
        prim = self._world.stage.GetPrimAtPath(
            f"/Replicator/{lt}Light_Xform/{lt}Light")
        if "radius" in lighting and prim.GetAttribute("inputs:radius"):
            prim.GetAttribute("inputs:radius").Set(lighting["radius"])
        if lighting.get("treat_as_point") and prim.GetAttribute("treatAsPoint"):
            prim.GetAttribute("treatAsPoint").Set(True)
        self._env_light = rep.create.light(
            light_type="Distant", intensity=lighting["env_intensity"][0],
            name="DistantLight",
        )

    def set_scene_light_tick(self, scene_intensity: float,
                             env_intensity: float) -> None:  # pragma: no cover
        """Per-tick intensities: "on" for RGB ticks, dim "off" for IR
        ticks where the projector supplies the light
        (scene_replicator.py:319-326)."""
        if getattr(self, "_scene_light", None) is not None:
            with self._scene_light:
                self._rep.modify.attribute("intensity", scene_intensity)
        if getattr(self, "_env_light", None) is not None:
            with self._env_light:
                self._rep.modify.attribute("intensity", env_intensity)

    def set_renderer_mode(self, mode: str) -> None:  # pragma: no cover
        if mode == "PathTracing":
            self._rep.settings.set_render_pathtraced()
        else:
            self._rep.settings.set_render_rtx_realtime()

    def render(self, phase: str) -> Dict[str, np.ndarray]:  # pragma: no cover
        """Step the orchestrator and fetch annotator products, keyed as the
        writers expect (reference: custom_writer.py:18-247 — color from
        RenderProduct_CameraRGB, stereo IR from Camera01/Camera02, GT depth
        from distance_to_image_plane)."""
        self._rep.orchestrator.step(rt_subframes=self._rt_subframes,
                                    pause_timeline=True)
        ann = self._annotators
        if phase == "gt":
            return {"distance_to_image_plane":
                    np.asarray(ann["depth"].get_data())}
        if phase == "rgb":
            return {"rgb_RenderProduct_CameraRGB":
                    strip_alpha(ann["rgb"].get_data())}
        if phase == "ir":
            return {
                "rgb_Camera01": strip_alpha(ann["left"].get_data()),
                "rgb_Camera02": strip_alpha(ann["right"].get_data()),
            }
        raise ValueError(phase)

    def close(self) -> None:  # pragma: no cover
        self._app.close()


class SimBackend:
    """Procedural-renderer backend with the same protocol.

    One procedural frame is rendered per camera-pose step and served to all
    phases of that step, so color/ir/depth stay geometrically consistent.
    Material semantics honored: in the GT pass (opaque bindings) the depth
    annotator sees every object; in the photo pass, transparent objects
    drop out of the simulated raw sensor exactly as in procedural.py.
    """

    def __init__(self, scene_cfg=None, seed: int = 0):
        from d3roma_tpu_torch.synthetic.procedural import ProceduralSceneRenderer, SceneConfig

        self.cfg = scene_cfg or SceneConfig()
        self._renderer = ProceduralSceneRenderer(self.cfg, seed)
        self._frame: Optional[dict] = None
        self._pose_cache: dict = {}
        self._projector_on = False
        self._opaque = True
        self.renderer_mode = "RayTracedLighting"
        self.hidden: List[str] = []
        self.stage: Optional[str] = None

    # -- scene ----------------------------------------------------- #
    def load_stage(self, usd_path: str) -> None:
        self.stage = usd_path

    def hide_prims(self, name_substrings: Sequence[str]) -> None:
        self.hidden = list(name_substrings)

    def find_surfaces(self) -> List[tuple]:
        """Two synthetic support surfaces (a table and a counter)."""
        eye = np.eye(3)
        return [
            (np.array([0.0, 0.0, 0.4]), eye, np.array([0.5, 0.4, 0.4]), "table"),
            (np.array([1.2, 0.3, 0.5]), eye, np.array([0.6, 0.3, 0.5]), "counter"),
        ]

    def spawn_objects(self, surface, n: int, rng, models=None) -> List[str]:
        if models is not None:
            return [m["instance_name"] for m in models]
        return [f"obj_{i}" for i in range(n)]

    def settle_physics(self, objects, max_rounds: int = 10, steps: int = 250,
                       vel_eps: float = 1e-3) -> bool:
        return True  # procedural objects are placed at rest

    def bind_materials(self, objects, specs, opaque: bool) -> None:
        self._opaque = opaque

    def create_stereo_rig(self, sensor_cfg: dict) -> None:
        self.sensor_cfg = sensor_cfg

    def set_camera_pose(self, pos, quat) -> None:
        # one procedural frame per pose, cached so the GT pass and the
        # photo pass see the SAME geometry at the same index
        key = np.asarray(pos, np.float64).tobytes()
        if key not in self._pose_cache:
            self._pose_cache[key] = self._renderer.render()
        self._frame = self._pose_cache[key]

    def set_projector(self, on: bool) -> None:
        self._projector_on = on

    def create_scene_light(self, lighting: dict, anchor) -> None:
        self.lighting = dict(lighting)
        self._light_scale = 1.0

    def set_scene_light_tick(self, scene_intensity: float,
                             env_intensity: float) -> None:
        """Procedural analog of the per-tick light intensities: a
        brightness factor relative to the Sphere table's nominal "on"
        level, so the DR actually shows up in rendered pixels (CI can
        assert rgb frames dim when the protocol dims the light)."""
        self._light_scale = float(np.clip(
            (scene_intensity + 10.0 * env_intensity) / 10000.0, 0.05, 2.0))

    def set_renderer_mode(self, mode: str) -> None:
        self.renderer_mode = mode

    def render(self, phase: str) -> Dict[str, np.ndarray]:
        assert self._frame is not None, "set_camera_pose before render"
        f = self._frame
        if phase == "gt":
            # GT depth is rendered against opaque bindings: full geometry
            return {"distance_to_image_plane": f["depth"]}
        if phase == "rgb":
            assert not self._projector_on, "projector must be off for RGB frames"
            rgb = f["rgb"]
            scale = getattr(self, "_light_scale", 1.0)
            if scale != 1.0:
                rgb = np.clip(rgb.astype(np.float32) * scale, 0,
                              255).astype(rgb.dtype)
            return {"rgb_RenderProduct_CameraRGB": rgb}
        if phase == "ir":
            assert self._projector_on, "projector must be on for IR frames"
            gray = lambda x: np.stack([x] * 3, axis=-1)
            return {
                "rgb_Camera01": gray(f["ir_l"]),
                "rgb_Camera02": gray(f["ir_r"]),
            }
        raise ValueError(phase)

    def close(self) -> None:
        pass
