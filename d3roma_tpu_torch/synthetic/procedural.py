"""Procedural synthetic stereo-IR scene generator.

The reference generates its HISS training data with an Isaac Sim
replicator: randomized objects over surfaces, a stereo IR rig with a
projected speckle pattern, GT depth + RGB + IR writers (reference:
isaacsim/render.py:17-48, isaacsim/replicate/scene_replicator.py:364-431,
isaacsim/custom_writer.py:18-247). Isaac Sim is not available in a TPU
training environment, so this module provides a dependency-free procedural
renderer with the same *contract*: scenes of randomized spheres/boxes over
a tilted ground plane, perspective GT depth, RGB with randomized materials,
a projected-speckle stereo IR pair consistent with the depth, and writers
emitting the exact HISS file layout the data loaders consume. Useful both
as a data source and as the hermetic fixture generator for pipeline tests.

Port of `d3roma_tpu/synthetic/procedural.py`: the renderer's numpy stream
is the JAX package's, so the same seed gives the same frames; files are
written by `utils/png.py` (RGB files from RGB arrays) and `utils/exr.py`,
with no OpenCV.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from d3roma_tpu_torch.utils.exr import write_exr
from d3roma_tpu_torch.utils.png import write_png


@dataclasses.dataclass
class SceneConfig:
    """Domain-randomization ranges (analog of isaacsim/config/hssd.yaml +
    the DREDS material protocol, isaacsim/dreds_renderer.py:148-540)."""

    height: int = 360
    width: int = 640
    fov_deg: float = 71.28
    baseline: float = 0.055
    num_objects: Tuple[int, int] = (4, 10)
    depth_range: Tuple[float, float] = (0.4, 1.6)
    radius_range: Tuple[float, float] = (0.04, 0.18)
    ground_depth: float = 2.0
    ground_tilt: Tuple[float, float] = (-0.15, 0.15)
    speckle_density: float = 0.08
    ir_noise: float = 0.02
    specular_prob: float = 0.3
    transparent_prob: float = 0.2  # objects invisible to the raw sensor


class ProceduralSceneRenderer:
    def __init__(self, config: SceneConfig = SceneConfig(), seed: int = 0):
        self.cfg = config
        self.rng = np.random.default_rng(seed)
        H, W = config.height, config.width
        self.fx = W / (2 * np.tan(np.radians(config.fov_deg) / 2))
        self.fxb = self.fx * config.baseline
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        self.dir_x = (xs - (W / 2 - 0.5)) / self.fx
        self.dir_y = (ys - (H / 2 - 0.5)) / self.fx

    # -------------------------------------------------------------- #
    def render(self):
        """Render one randomized scene.

        Returns dict: depth (GT, m), rgb (uint8), ir_l/ir_r (uint8),
        sim_depth (sensor-like depth with transparent-object holes and
        speckle dropout), fxb.
        """
        cfg, rng = self.cfg, self.rng
        H, W = cfg.height, cfg.width

        # ground plane depth with random tilt
        tilt_x = rng.uniform(*cfg.ground_tilt)
        tilt_y = rng.uniform(*cfg.ground_tilt)
        depth = cfg.ground_depth * (1 + tilt_x * self.dir_x + tilt_y * self.dir_y)
        albedo = np.ones((H, W, 3), np.float32) * rng.uniform(0.3, 0.8, 3)
        sensor_visible = np.ones((H, W), bool)

        n_obj = rng.integers(*cfg.num_objects)
        for _ in range(n_obj):
            z = rng.uniform(*cfg.depth_range)
            r = rng.uniform(*cfg.radius_range)
            cx = rng.uniform(-0.4, 0.4) * z
            cy = rng.uniform(-0.25, 0.25) * z
            # perspective sphere: ray-sphere intersection along pinhole rays
            ox = self.dir_x * z - cx
            oy = self.dir_y * z - cy
            mask2d = ox**2 + oy**2 < r**2
            bulge = np.zeros((H, W), np.float32)
            bulge[mask2d] = np.sqrt(np.maximum(r**2 - (ox**2 + oy**2)[mask2d], 0))
            obj_depth = z - bulge
            closer = mask2d & (obj_depth < depth)
            depth = np.where(closer, obj_depth, depth)
            color = rng.uniform(0.1, 0.9, 3)
            albedo[closer] = color
            # material randomization per DREDS protocol
            mat = rng.random()
            if mat < cfg.transparent_prob:
                sensor_visible &= ~closer  # raw sensor sees through
            elif mat < cfg.transparent_prob + cfg.specular_prob:
                # specular: noisy raw depth
                sensor_visible &= ~(closer & (rng.random((H, W)) < 0.5))

        # shading: simple lambertian from depth gradients
        gy, gx = np.gradient(depth)
        shade = np.clip(1.0 - 4.0 * np.abs(gx) - 4.0 * np.abs(gy), 0.2, 1.0)
        rgb = np.clip(albedo * shade[..., None] * 255, 0, 255).astype(np.uint8)

        # stereo IR: projected speckle pattern attached to surfaces
        disp = self.fxb / depth
        pattern = (rng.random((H, W + 200)) < cfg.speckle_density).astype(np.float32)
        import scipy.ndimage as ndi

        pattern = ndi.gaussian_filter(pattern, 0.7)
        xs = np.arange(W, dtype=np.float32)[None, :].repeat(H, 0)
        ir_l = pattern[:, :W] * shade
        # right view: sample the left pattern at x + d (right-frame approx)
        coords_x = np.clip(xs + disp, 0, W + 199)
        ir_r = _bilinear_1d(pattern, coords_x) * shade
        noise = lambda: rng.normal(0, cfg.ir_noise, (H, W))
        ir_l = np.clip((ir_l * 0.8 + 0.1 + noise()) * 255, 0, 255).astype(np.uint8)
        ir_r = np.clip((ir_r * 0.8 + 0.1 + noise()) * 255, 0, 255).astype(np.uint8)

        # sensor-like raw depth: holes where invisible + quantization
        sim_depth = np.where(sensor_visible, depth, 0.0)
        sim_depth = np.round(sim_depth * 4000) / 4000  # quantize
        sim_depth *= rng.normal(1.0, 0.004, sim_depth.shape)  # multiplicative noise
        sim_depth = np.where(sensor_visible, np.maximum(sim_depth, 0), 0.0)

        return {
            "depth": depth.astype(np.float32),
            "sim_depth": sim_depth.astype(np.float32),
            "rgb": rgb,
            "ir_l": ir_l,
            "ir_r": ir_r,
            "fxb": float(self.fxb),
        }


def _bilinear_1d(img: np.ndarray, coords_x: np.ndarray) -> np.ndarray:
    x0 = np.floor(coords_x).astype(np.int64)
    x1 = np.minimum(x0 + 1, img.shape[1] - 1)
    w1 = coords_x - x0
    rows = np.arange(img.shape[0])[:, None]
    return img[rows, x0] * (1 - w1) + img[rows, x1] * w1


def write_hiss_frame(out_dir: str, index: int, frame: dict) -> None:
    """Emit the HISS file layout consumed by the data loaders
    (reference custom_writer.py:18-247: NNNN_color.png, NNNN_ir_l/r.png,
    GT depth exr, sim depth exr)."""
    os.makedirs(out_dir, exist_ok=True)
    p = os.path.join(out_dir, f"{index:04d}")
    write_png(p + "_color.png", frame["rgb"])
    write_png(p + "_ir_l.png", frame["ir_l"])
    write_png(p + "_ir_r.png", frame["ir_r"])
    write_exr(p + "_depth.exr", frame["depth"])
    write_exr(p + "_simDepthImage.exr", frame["sim_depth"])


def generate_dataset(
    out_root: str, num_frames: int, split: str = "train",
    config: Optional[SceneConfig] = None, seed: int = 0,
) -> str:
    """Generate a HISS-layout dataset tree; returns the split directory."""
    renderer = ProceduralSceneRenderer(config or SceneConfig(), seed)
    split_dir = os.path.join(out_root, split, "scene_0000")
    for i in range(num_frames):
        write_hiss_frame(split_dir, i, renderer.render())
    return split_dir


def _write_capture_frame(prefix: str, frame: dict) -> None:
    """The reference's bundled PNG frame format (assets/examples and
    datasets/Real both use it): rgb uint8, raw sensor depth as uint16
    millimeters, stereo IR pair."""
    write_png(prefix + "_rgb.png", frame["rgb"])
    depth_mm = np.clip(frame["sim_depth"] * 1000.0, 0, 65535)
    write_png(prefix + "_depth.png", depth_mm.astype(np.uint16))
    write_png(prefix + "_ir_l.png", frame["ir_l"])
    write_png(prefix + "_ir_r.png", frame["ir_r"])


def generate_example_assets(out_dir: str, seed: int = 7) -> str:
    """Write a demo frame set in the reference's bundled-example format
    (reference: assets/examples/0000_{rgb,depth,ir_l,ir_r}.png, consumed
    by inference.py:283-288). Lets the single-frame demo run in a bare
    checkout with no external assets. Returns out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    frame = ProceduralSceneRenderer(SceneConfig(), seed).render()
    _write_capture_frame(os.path.join(out_dir, "0000"), frame)
    return out_dir


def generate_real_capture(out_root: str, scene: str = "xiaomeng",
                          num_frames: int = 2, seed: int = 11) -> str:
    """Write a one-scene RealSense-style capture in the reference's
    bundled layout (reference: datasets/Real/xiaomeng/0000_{rgb,depth,
    ir_l,ir_r}.png + intrinsics.txt, consumed by the Real dataset via
    recursive substring globs, stereo_datasets.py:825-852). Keeps the
    `Real_<split>_<device>` eval path hermetic in a bare checkout. The
    reference's intrinsics.txt is an rs-enumerate-devices dump that no
    code parses; we write the procedural camera's actual parameters
    instead. Returns the scene directory."""
    cfg = SceneConfig()
    renderer = ProceduralSceneRenderer(cfg, seed)
    scene_dir = os.path.join(out_root, scene)
    os.makedirs(scene_dir, exist_ok=True)
    for i in range(num_frames):
        _write_capture_frame(os.path.join(scene_dir, f"{i:04d}"),
                             renderer.render())
    with open(os.path.join(scene_dir, "intrinsics.txt"), "w") as f:
        f.write("Procedural capture (d3roma_tpu_torch.synthetic); informational\n"
                f"resolution: {cfg.width}x{cfg.height}\n"
                f"fx = fy: {renderer.fx:.3f}\n"
                f"cx, cy: {cfg.width / 2 - 0.5}, {cfg.height / 2 - 0.5}\n"
                f"baseline_m: {cfg.baseline}\n"
                f"fxb: {renderer.fxb:.4f}\n")
    return scene_dir
