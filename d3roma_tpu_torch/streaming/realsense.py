"""Live RealSense capture and point-cloud helpers.

Port of `d3roma_tpu/streaming/realsense.py` (reference: utils_d3roma/
realsense.py:12-300): the stream configuration with the L515's depth scale
and resolution, align-to-color, RGB-D frame fetch; RGB-D -> point cloud
with voxel downsampling and the extrinsic transform, the workspace crop,
and the packed xyz + rgb records of a ROS PointCloud2. pyrealsense2 is
imported only when a camera is opened; the point-cloud math is numpy
(`utils/pointcloud.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from d3roma_tpu_torch.utils.pointcloud import (
    backproject_depth,
    transform_points,
    voxel_downsample,
    write_ply,
)


class RealSenseRGBDCamera:
    """A RealSense RGB-D camera (needs pyrealsense2 when opened)."""

    def __init__(self, serial: Optional[str] = None, frame_rate: int = 30,
                 resolution: Tuple[int, int] = (640, 360), align: bool = True,
                 **kwargs):
        try:
            import pyrealsense2 as rs
        except ImportError as e:
            raise ImportError(
                "pyrealsense2 is required for live capture; use "
                "d3roma_tpu_torch.streaming.sources.FileReplaySource otherwise"
            ) from e

        self.pipeline = rs.pipeline()
        self.config = rs.config()
        self.serial = serial
        # an L515 (serial starting with a letter) has its own depth scale and
        # resolution (reference: realsense.py:40-47)
        self.is_radar = bool(serial) and serial[0].isalpha()
        depth_resolution = (1024, 768) if self.is_radar else resolution
        if self.is_radar:
            frame_rate = max(frame_rate, 30)
            self.depth_scale = 4000.0
        else:
            self.depth_scale = 1000.0
        if serial:
            self.config.enable_device(serial)
        self.config.enable_stream(rs.stream.depth, depth_resolution[0],
                                  depth_resolution[1], rs.format.z16, frame_rate)
        self.config.enable_stream(rs.stream.color, resolution[0], resolution[1],
                                  rs.format.rgb8, frame_rate)
        self.pipeline.start(self.config)
        self.align = rs.align(rs.stream.color)
        self.with_align = align

    def get_rgb_image(self) -> np.ndarray:
        frames = self.pipeline.wait_for_frames()
        return np.asanyarray(frames.get_color_frame().get_data()).astype(np.uint8)

    def get_depth_image(self) -> np.ndarray:
        frames = self.pipeline.wait_for_frames()
        return (np.asanyarray(frames.get_depth_frame().get_data()).astype(np.float32)
                / self.depth_scale)

    def get_rgbd_image(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rgb uint8 [H,W,3], depth float32 meters [H,W]), depth aligned to
        the colour frame unless `align=False`."""
        frameset = self.pipeline.wait_for_frames()
        if self.with_align:
            frameset = self.align.process(frameset)
        rgb = np.asanyarray(frameset.get_color_frame().get_data()).astype(np.uint8)
        depth = (np.asanyarray(frameset.get_depth_frame().get_data()).astype(np.float32)
                 / self.depth_scale)
        return rgb, depth

    def stop(self):
        self.pipeline.stop()


def rgbd_to_pointcloud(
    color: np.ndarray,
    depth: np.ndarray,
    intrinsic: np.ndarray,
    extrinsic: np.ndarray = np.eye(4),
    voxel_size: float = 0.005,
    fname: Optional[str] = None,
    min_depth: float = 0.0,
    max_depth: float = np.inf,
):
    """The pixels with min_depth < depth < max_depth back-projected,
    voxel-downsampled and moved by `extrinsic`; written to `fname` as PLY
    when given (reference: realsense.py:85-127). Returns (points [N,3],
    colors [N,3])."""
    mask = (depth > min_depth) & (depth < max_depth)
    pts, cols = backproject_depth(depth, intrinsic, color, mask)
    pts, cols = voxel_downsample(pts, cols, voxel_size)
    pts = transform_points(pts, extrinsic)
    if fname is not None:
        write_ply(fname, pts, cols)
    return pts, cols


def crop_workspace(
    pts: np.ndarray,
    colors: Optional[np.ndarray],
    bounds_min=(-0.5, -0.5, 0.0),
    bounds_max=(0.5, 0.5, 1.0),
):
    """The points (and colours) inside an axis-aligned box, bounds
    included (reference: realsense.py:162-248)."""
    lo = np.asarray(bounds_min)
    hi = np.asarray(bounds_max)
    keep = np.all((pts >= lo) & (pts <= hi), axis=1)
    return pts[keep], None if colors is None else colors[keep]


def merge_xyz_rgb(xyz: np.ndarray, rgb: np.ndarray) -> np.ndarray:
    """xyz float32 + rgb uint8 packed into PointCloud2's structured layout
    (x, y, z float32; rgb uint32 0x00RRGGBB) (reference: realsense.py:
    271-300, d3roma_processor.py:155-183)."""
    rgb = rgb.astype(np.uint32)
    packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    out = np.empty(len(xyz), np.dtype([("x", np.float32), ("y", np.float32),
                                       ("z", np.float32), ("rgb", np.uint32)]))
    out["x"], out["y"], out["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    out["rgb"] = packed
    return out
