"""Port of `d3roma_tpu/synthetic/isaac/geometry.py` (numpy, unchanged arithmetic).

Pure-numpy scene geometry for the Isaac replicator.

OBB corner/surface math and hemisphere camera-pose sampling, rebuilt from
the reference's omni-coupled versions so they are unit-testable without an
Isaac install (reference: isaacsim/replicate/scene_replicator.py:184-222
surface-center-from-OBB; :283-362 + isaacsim/dreds_renderer.py:148-240
hemisphere look-at sampling).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def obb_corners(centroid: np.ndarray, axes: np.ndarray,
                half_extent: np.ndarray) -> np.ndarray:
    """8 corners of an oriented bounding box. `axes` rows are the box axes
    (the convention omni.isaac.core.utils.bounds.get_obb_corners uses);
    corner order matches it: index bit k flips axis k's sign, so corners
    2,3,6,7 share +axis1 ... the reference picks [2,3,6,7] as the top face
    (scene_replicator.py:199-208)."""
    centroid = np.asarray(centroid, np.float64)
    axes = np.asarray(axes, np.float64)
    he = np.asarray(half_extent, np.float64)
    corners = []
    for i in (-1, 1):
        for j in (-1, 1):
            for k in (-1, 1):
                corners.append(centroid + i * he[0] * axes[0]
                               + j * he[1] * axes[1] + k * he[2] * axes[2])
    return np.stack(corners)


def mesh_center_from_obb(centroid, axes, half_extent) -> np.ndarray:
    """Mean of all 8 OBB corners (reference: calc_mesh_center,
    scene_replicator.py:185-191)."""
    return obb_corners(centroid, axes, half_extent).mean(axis=0)


def surface_center_from_obb(centroid, axes, half_extent):
    """Support-surface anchor: mean of the top-face corners, plus the OBB
    summary dict the replicator stores (reference: calc_surface_center,
    scene_replicator.py:193-221)."""
    corners = obb_corners(centroid, axes, half_extent)
    top = corners[[2, 3, 6, 7]]
    position = top.mean(axis=0)
    return position, {
        "centroid": np.asarray(centroid, np.float64),
        "axes": np.asarray(axes, np.float64),
        "half_extent": np.asarray(half_extent, np.float64),
        "position": position,
        "orientation": mat2quat(np.asarray(axes, np.float64).T),
    }


def mat2quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix (columns = world axes) -> unit quaternion [w,x,y,z]."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1e-12, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def look_at_quaternion(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera orientation quaternion [w,x,y,z] with -z forward toward
    `target` and world-z up (USD camera convention)."""
    fwd = np.asarray(target, np.float64) - np.asarray(position, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    n = np.linalg.norm(right)
    if n < 1e-9:  # looking straight down: pick x as right
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / n
    true_up = np.cross(right, fwd)
    R = np.stack([right, true_up, -fwd], axis=1)
    return mat2quat(R)


def camera_orbit_poses(
    rng: np.random.Generator,
    center: np.ndarray,
    n: int,
    radius_range: Tuple[float, float] = (0.6, 1.4),
    elevation_range_deg: Tuple[float, float] = (20.0, 70.0),
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Sample look-at camera poses on a hemisphere around a surface center.
    Returns [(position, quaternion_wxyz)] (reference:
    scene_replicator.py:283-362, dreds_renderer.py:148-240)."""
    poses = []
    center = np.asarray(center, np.float64)
    for _ in range(n):
        r = rng.uniform(*radius_range)
        elev = np.radians(rng.uniform(*elevation_range_deg))
        azim = rng.uniform(0, 2 * np.pi)
        pos = center + r * np.array(
            [np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)]
        )
        poses.append((pos, look_at_quaternion(pos, center)))
    return poses


def quat2mat(q: np.ndarray) -> np.ndarray:
    """Unit quaternion [w,x,y,z] -> rotation matrix."""
    w, x, y, z = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def mat2euler_sxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> extrinsic static-xyz Euler angles (radians), the
    convention the reference feeds omni `rep.modify.pose(rotation=...)`
    with (scene_replicator.py:300-306, transforms3d 'sxyz')."""
    R = np.asarray(R, np.float64)
    cy = np.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    if cy > 1e-8:
        ax = np.arctan2(R[2, 1], R[2, 2])
        ay = np.arctan2(-R[2, 0], cy)
        az = np.arctan2(R[1, 0], R[0, 0])
    else:
        ax = np.arctan2(-R[1, 2], R[1, 1])
        ay = np.arctan2(-R[2, 0], cy)
        az = 0.0
    return np.array([ax, ay, az])


# Isaac camera-prim frame vs the OpenCV-style camera frame the pose
# sampler produces: observed from the GUI as euler (pi/2, 0, pi/2)
# (reference: scene_replicator.py:293-298).
RPC = np.array([[0.0, 0.0, 1.0],
                [1.0, 0.0, 0.0],
                [0.0, 1.0, 0.0]])


def rig_pose_from_camera(pos: np.ndarray, quat_wxyz: np.ndarray,
                         placement: dict) -> dict:
    """Per-prim world poses for one stereo-rig step.

    Mirrors the reference's pose math (scene_replicator.py:283-331): the
    left/right IR cameras and the projector sit along the camera's +x
    axis at the configured offsets; camera prims get the Rwc @ RPC^T
    orientation (Isaac prim convention), the projector rect light gets
    Rwc. Returns positions [3] and extrinsic-sxyz euler DEGREES per prim.
    """
    pos = np.asarray(pos, np.float64)
    Rwc = quat2mat(quat_wxyz)
    Rwp = Rwc @ RPC.T
    cam_euler = np.rad2deg(mat2euler_sxyz(Rwp))
    proj_euler = np.rad2deg(mat2euler_sxyz(Rwc))
    x_axis = Rwc[:, 0]
    return {
        "rgb": {"position": pos, "euler_deg": cam_euler},
        "left": {"position": pos + x_axis * placement["rgb_to_left_ir"],
                 "euler_deg": cam_euler},
        "right": {"position": pos + x_axis * placement["rgb_to_right_ir"],
                  "euler_deg": cam_euler},
        "projector": {
            "position": pos + x_axis * placement.get("rgb_to_projector", 0.0),
            "euler_deg": proj_euler,
        },
    }


def stereo_rig_camera_params(sensor_cfg: dict, focal_length: float = 24.0) -> dict:
    """USD camera attributes reproducing the sensor FOV: h = 2 f tan(FOV/2),
    vertical aperture scaled by the image aspect (reference:
    scene_replicator.py:364-398 incl. the vertical-aperture hack)."""
    import math

    W, H = sensor_cfg["resolution"]
    fov = math.radians(sensor_cfg["fov"])
    h = 2.0 * focal_length * math.tan(fov / 2.0)
    return {
        "focal_length": focal_length,
        "horizontal_aperture": h,
        "vertical_aperture": h * H / W,
        "clipping_range": tuple(sensor_cfg.get("clipping_range", (0.1, 10.0))),
        "resolution": (W, H),
    }
