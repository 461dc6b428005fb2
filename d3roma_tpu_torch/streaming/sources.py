"""Frame sources for the streaming pipeline.

Port of `d3roma_tpu/streaming/sources.py` (reference: utils_d3roma/
realsense.py:16-83, inference_pub_pcl.py:262-442). Capture sits behind the
small `FrameSource` protocol, so the same processor runs on live RealSense
frames, ROS image topics or a directory of recorded frames
(`FileReplaySource`, also the hermetic test source).

The recorded frames are read with `utils/png.py` (no OpenCV): its decode is
already RGB, so no channel swap follows; depth PNGs are 16-bit millimetres
read at their own depth (OpenCV's IMREAD_ANYDEPTH), then divided by 1000.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Iterator, Optional, Tuple

import numpy as np

from d3roma_tpu_torch.utils.png import read_png

Frame = Tuple[np.ndarray, np.ndarray]  # (rgb uint8 HxWx3, depth float32 m)


def read_rgb(path: str) -> np.ndarray:
    """A PNG as uint8 RGB [H,W,3], as OpenCV's IMREAD_COLOR + BGR2RGB give
    it: grey replicated to three channels, alpha dropped, 16 bits taken to
    their high byte."""
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_depth_png(path: str) -> np.ndarray:
    """A one-channel depth PNG (millimetres) as float32 meters."""
    d = read_png(path)
    if d.ndim != 2:
        raise ValueError(f"{path}: a depth PNG has one channel, got shape {d.shape}")
    return d.astype(np.float32) / 1000.0


class FrameSource:
    def frames(self) -> Iterator[Frame]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FileReplaySource(FrameSource):
    """Replays colour / `*_depth.png` (mm) pairs from a directory, in name
    order, optionally looping at a fixed rate. Takes both capture namings:
    `*_color.png`, else the bundled capture's `*_rgb.png` (reference naming,
    stereo_datasets.py:834)."""

    def __init__(self, root: str, fps: Optional[float] = None, loop: bool = False):
        self._color_tag = "_color.png"
        self.color_files = sorted(glob.glob(os.path.join(root, "*_color.png")))
        if not self.color_files:
            self._color_tag = "_rgb.png"
            self.color_files = sorted(glob.glob(os.path.join(root, "*_rgb.png")))
        if not self.color_files:
            raise FileNotFoundError(f"no *_color.png or *_rgb.png frames under {root}")
        self.fps = fps
        self.loop = loop

    def frames(self) -> Iterator[Frame]:
        while True:
            for cf in self.color_files:
                if not os.path.exists(cf):
                    raise FileNotFoundError(f"unreadable color frame: {cf}")
                rgb = read_rgb(cf)
                df = cf.replace(self._color_tag, "_depth.png")
                if not os.path.exists(df):
                    raise FileNotFoundError(f"missing/unreadable depth frame: {df}")
                yield rgb, read_depth_png(df)
                if self.fps:
                    time.sleep(1.0 / self.fps)
            if not self.loop:
                return


class RealSenseSource(FrameSource):
    """Live capture through RealSenseRGBDCamera (needs pyrealsense2)."""

    def __init__(self, serial: Optional[str] = None, frame_rate: int = 30):
        from d3roma_tpu_torch.streaming.realsense import RealSenseRGBDCamera

        self.cam = RealSenseRGBDCamera(serial=serial, frame_rate=frame_rate)

    def frames(self) -> Iterator[Frame]:
        while True:
            yield self.cam.get_rgbd_image()

    def close(self) -> None:
        self.cam.stop()
