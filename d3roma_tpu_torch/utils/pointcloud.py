"""Point-cloud construction and .ply export, on the host.

Port of `d3roma_tpu/utils/pointcloud.py` (reference: utils_d3roma/utils.py:
753-775, camera.py:142-178, realsense.py:85-127). Numpy only, as there:
back-projection is plain math, the PLY writer is a binary little-endian
file with optional uint8 colours (`write_ply` writes the same bytes as the
JAX package's), and voxel downsampling averages the points (and colours)
of each occupied voxel, as Open3D's `voxel_down_sample` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def backproject_depth(
    depth: np.ndarray, K: np.ndarray, rgb: Optional[np.ndarray] = None,
    mask: Optional[np.ndarray] = None,
):
    """depth [H,W] (meters) + intrinsics -> points [N,3] (+ colors [N,3]),
    the pixels with depth > 0 (and `mask`), row-major. Open3D's
    create_from_rgbd_image with depth_scale=1 (reference: camera.py:160-178)."""
    H, W = depth.shape[:2]
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    z = depth.astype(np.float32)
    valid = z > 0
    if mask is not None:
        valid &= mask.astype(bool)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x = (xs - cx) * z / fx
    y = (ys - cy) * z / fy
    pts = np.stack([x[valid], y[valid], z[valid]], axis=1)
    if rgb is not None:
        cols = rgb.reshape(H * W, -1)[valid.ravel()]
        return pts, cols
    return pts, None


def transform_points(pts: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Points [N,3] through the 4x4 rigid transform T."""
    return pts @ T[:3, :3].T + T[:3, 3]


def voxel_downsample(
    pts: np.ndarray, colors: Optional[np.ndarray], voxel_size: float
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The mean point (and colour, float64) of each occupied voxel, the
    voxels in lexicographic order of their integer coordinates."""
    if len(pts) == 0:
        return pts, colors
    keys = np.floor(pts / voxel_size).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    n = counts.shape[0]
    out = np.zeros((n, 3), np.float64)
    np.add.at(out, inv, pts)
    out /= counts[:, None]
    out_c = None
    if colors is not None:
        out_c = np.zeros((n, colors.shape[1]), np.float64)
        np.add.at(out_c, inv, colors)
        out_c /= counts[:, None]
    return out.astype(np.float32), out_c


def write_ply(path: str, pts: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY: float32 x, y, z and, with `colors`, uchar
    red, green, blue (float colours in [0, 1] are scaled by 255, others
    clipped to [0, 255] and truncated)."""
    n = len(pts)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is None:
            pts.astype(np.float32).tofile(f)
            return
        c = colors
        if c.dtype != np.uint8:
            # an empty cloud has no max: its file is the header alone
            scale = 255.0 if (c.size and c.max() <= 1.0 + 1e-6) else 1.0
            c = np.clip(c * scale, 0, 255).astype(np.uint8)
        rec = np.empty(n, np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)]))
        rec["xyz"] = pts.astype(np.float32)
        rec["rgb"] = c[:, :3]
        rec.tofile(f)


def read_ply(path: str):
    """Read a file `write_ply` wrote: (points [N,3] float32, colors [N,3]
    uint8 or None)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = int(next(h.split()[-1] for h in header if h.startswith("element vertex")))
        if any("uchar red" in h for h in header):
            rec = np.fromfile(f, np.dtype([("xyz", np.float32, 3), ("rgb", np.uint8, 3)]), n)
            return rec["xyz"].copy(), rec["rgb"].copy()
        return np.fromfile(f, np.float32, n * 3).reshape(n, 3), None


def viz_cropped_pointcloud(
    K: np.ndarray, rgb: np.ndarray, depth: np.ndarray, fname: str,
    mask: Optional[np.ndarray] = None,
) -> None:
    """Depth + RGB -> .ply on disk (reference: utils_d3roma/utils.py:753-775)."""
    pts, cols = backproject_depth(depth, K, rgb, mask)
    write_ply(fname, pts, cols)
