"""Ticker-gated frame writers for the Isaac replicator (HISS layout).

Port of `d3roma_tpu/synthetic/isaac/writers.py`. PNGs go through the
port's `utils/png.py` (the JAX package writes them with `cv2.imwrite`
after an RGB -> BGR swap; the port writes the RGB array as it is, so the
decoded pixels are the same), EXRs through `utils/exr.py`.

Rebuild of the reference's replicator writers
(reference: isaacsim/custom_writer.py:18-247) decoupled from
omni.replicator: each writer consumes a plain dict of numpy annotator
arrays and a shared FrameTicker, and writes through a small file backend
(png, exr and json). Because the renderer
interleaves phases (gt passes first, then alternating rgb/ir with the IR
projector toggled), every writer fires only on its own phase and keeps its
own sequence id:

- ColorWriter  -> NNNN_color.png            on "rgb" ticks
- IRWriter     -> NNNN_ir_l.png / _ir_r.png on "ir" ticks (grayscale)
- GtWriter     -> NNNN_depth.exr [+ NNNN_disp.exr via fxb]
                  [+ NNNN_mask.png/.json] [+ NNNN_normal.png] on "gt" ticks,
                  with duplicate-tick suppression (custom_writer.py:141-143)
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

import numpy as np


def rgb2gray(rgb: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma, as the reference's IR conversion
    (custom_writer.py:12-13)."""
    return np.dot(rgb[..., :3].astype(np.float64), [0.2989, 0.5870, 0.1140])


def colorize_normals(data: np.ndarray) -> np.ndarray:
    return ((data * 0.5 + 0.5) * 255).astype(np.uint8)


class FrameTicker:
    """Shared (phase, step) tick: the orchestrator sets the phase before
    each rendered frame; writers gate on it (reference keeps the pair as
    `(self._writer_tick, self._step_tick)`, scene_replicator.py:433-434)."""

    def __init__(self):
        self.phase = "gt"
        self.step = 0

    def __call__(self):
        return self.phase, self.step


class FileBackend:
    """Minimal dispatch backend (png/exr/json/npy) used by all writers."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.out_dir, name)

    def write_image(self, name: str, img: np.ndarray) -> None:
        from d3roma_tpu_torch.utils.png import write_png

        img = np.asarray(img)
        if img.ndim == 3 and img.shape[-1] >= 3:
            img = img[..., :3]  # RGB(A) -> RGB
        write_png(self.path(name), img)

    def write_exr(self, name: str, data: np.ndarray) -> None:
        from d3roma_tpu_torch.utils.exr import write_exr

        write_exr(self.path(name), np.asarray(data, np.float32))

    def write_json(self, name: str, obj) -> None:
        with open(self.path(name), "w") as f:
            json.dump(obj, f, indent=2, sort_keys=True)

    def write_array(self, name: str, arr: np.ndarray) -> None:
        np.save(self.path(name), arr)


class _TickedWriter:
    def __init__(self, backend: FileBackend, ticker: FrameTicker,
                 start_sequence_id: int = 0):
        assert start_sequence_id >= 0, "start_sequence_id must be >= 0"
        self.backend = backend
        self.ticker = ticker
        self._frame_id = 0
        self._sequence_id = start_sequence_id
        self._start_sequence_id = start_sequence_id

    def on_final_frame(self):
        self._frame_id = 0
        self._sequence_id = self._start_sequence_id


class ColorWriter(_TickedWriter):
    """NNNN_color.png from the RGB render product on "rgb" ticks."""

    def write(self, data: Dict[str, np.ndarray]) -> None:
        if self.ticker()[0] == "rgb":
            for annotator, val in data.items():
                if annotator.startswith("rgb"):
                    self.backend.write_image(f"{self._sequence_id:04d}_color.png", val)
            self._sequence_id += 1
        self._frame_id += 1


class IRWriter(_TickedWriter):
    """NNNN_ir_l.png / NNNN_ir_r.png grayscale from the stereo IR render
    products on "ir" ticks. Left/right told apart by the camera name
    ('01' = left, '02' = right — the reference's naming hack,
    custom_writer.py:232-234)."""

    def write(self, data: Dict[str, np.ndarray]) -> None:
        if self.ticker()[0] == "ir":
            for annotator, val in data.items():
                if annotator.startswith("rgb"):
                    ir_name = "ir_l" if "01" in annotator else "ir_r"
                    self.backend.write_image(
                        f"{self._sequence_id:04d}_{ir_name}.png",
                        rgb2gray(val).astype(np.uint8),
                    )
            self._sequence_id += 1
        self._frame_id += 1


class GtWriter(_TickedWriter):
    """GT depth (+disparity/semantics/normals) on "gt" ticks.

    `depth_sensor_cfg` carries fov/resolution/placement so the disparity
    toggle can derive fxb = focal * baseline exactly as the reference
    (custom_writer.py:107-118, asserting the 0.055 m HISS baseline).
    """

    def __init__(self, backend, ticker, start_sequence_id=0,
                 render_disparity: bool = False,
                 depth_sensor_cfg: Optional[dict] = None,
                 colorize_semantic_segmentation: bool = False):
        super().__init__(backend, ticker, start_sequence_id)
        self.render_disparity = render_disparity
        self.colorize_semantic_segmentation = colorize_semantic_segmentation
        self.fxb = None
        self._last_tick = None
        if render_disparity:
            assert depth_sensor_cfg is not None
            fov = math.radians(depth_sensor_cfg["fov"])
            w = depth_sensor_cfg["resolution"][0]
            focal = w / (2 * math.tan(fov / 2))
            placement = depth_sensor_cfg["placement"]
            baseline = placement["rgb_to_right_ir"] - placement["rgb_to_left_ir"]
            assert np.isclose(baseline, 0.055), "wrong baseline"
            self.fxb = focal * baseline

    def write(self, data: Dict[str, np.ndarray]) -> None:
        phase, step = self.ticker()
        if phase == "gt":
            if self._last_tick is not None and step == self._last_tick:
                return  # duplicate-frame suppression (custom_writer.py:141-143)
            for annotator, val in data.items():
                if annotator.startswith("distance_to_image_plane"):
                    self.backend.write_exr(f"{self._sequence_id:04d}_depth.exr", val)
                    if self.render_disparity:
                        disp = self.fxb / np.maximum(np.asarray(val, np.float64), 1e-9)
                        self.backend.write_exr(f"{self._sequence_id:04d}_disp.exr", disp)
                elif annotator.startswith("semantic_segmentation"):
                    seg = np.asarray(val["data"] if isinstance(val, dict) else val)
                    self.backend.write_image(
                        f"{self._sequence_id:04d}_mask.png", seg.astype(np.uint16)
                    )
                    labels = (val.get("idToLabels", {})
                              if isinstance(val, dict) else {})
                    self.backend.write_json(
                        f"{self._sequence_id:04d}_mask.json",
                        {str(k): v for k, v in labels.items()},
                    )
                elif annotator.startswith("normals"):
                    self.backend.write_image(
                        f"{self._sequence_id:04d}_normal.png", colorize_normals(val)
                    )
                elif annotator.startswith("pointcloud"):
                    self.backend.write_array(f"{self._sequence_id:04d}_pcd.npy", val)
            self._last_tick = step
            self._sequence_id += 1
        self._frame_id += 1
