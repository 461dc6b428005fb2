"""Camera models, disparity/depth geometry, and depth reprojection.

API-compatible rebuild of the reference camera zoo
(reference: utils_d3roma/camera.py:12-780): `K` intrinsics with scaling,
`DepthCamera` resolution management and disparity bounds from the depth
range, `RGBDCamera` (NYU/ClearPose/SynTODD with pseudo-baselines chosen so
fxb matches a RealSense), and `Realsense` with per-device measured
calibrations. Calibration numbers are measurement data reproduced for
parity. The depth->RGB-frame reprojection is a vectorized scatter (with the
reference's aggressive 4-corner fill).

Port of `d3roma_tpu/utils/camera.py`; its two `cv2.resize` calls go
through `utils/resize.py`, which has OpenCV's INTER_NEAREST semantics.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from d3roma_tpu_torch.utils.resize import INTER_NEAREST, resize


def normalize_disp(disp, min_disp, max_disp, shift=0.0):
    """disp -> [0, 1] over the camera's disparity window
    (reference: utils_d3roma/camera.py:771-780)."""
    return (disp - shift - min_disp) / (max_disp - min_disp)


def unnormalize_disp(ndisp, min_disp, max_disp, shift=0.0):
    return ndisp * (max_disp - min_disp) + min_disp + shift


class K:
    """Pinhole intrinsics with uniform scaling (reference: camera.py:12-38)."""

    def __init__(self, fx, fy, cx, cy):
        self.fx, self.fy, self.cx, self.cy = float(fx), float(fy), float(cx), float(cy)

    @property
    def vec(self) -> np.ndarray:
        return np.array([self.fx, self.fy, self.cx, self.cy])

    @property
    def arr(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]]
        )

    @property
    def inv(self) -> np.ndarray:
        return np.linalg.inv(self.arr)

    def __mul__(self, scale):
        return K(self.fx * scale, self.fy * scale, self.cx * scale, self.cy * scale)


class DepthCamera:
    """Base camera: resolution bookkeeping + disparity window
    (reference: camera.py:40-146)."""

    def __init__(self, resolution: str, scale: float = 1.0):
        self.scale = scale
        self.resolution_str = resolution  # "WxH"
        self.intrinsics: Dict[str, np.ndarray] = {}
        self.distortions: Dict[str, np.ndarray] = {}
        self.extrinsics: Dict[str, np.ndarray] = {}
        self._T_fc = np.eye(4)
        self.config: Dict = {}
        self.device = "unknown"
        self._changed_res = False

    @staticmethod
    def from_device(device: str = "sim") -> "DepthCamera":
        if device == "clearpose":
            return RGBDCamera.default_clearpose()
        if device == "syntodd":
            return RGBDCamera.default_syntodd()
        if device == "sim":
            return Realsense.default_sim(min_depth=0.2, max_depth=5.0)
        return Realsense.default_real(device)

    def change_resolution(self, new_res) -> None:
        """One-shot by design (reference: camera.py:64-77)."""
        if self._changed_res:
            raise RuntimeError("resolution already changed")
        if isinstance(new_res, str):
            w, h = (int(x) for x in new_res.split("x"))
        else:
            w, h = new_res
        # MULTIPLY, don't overwrite: intrinsics are stored at the 640-base
        # and self.scale already maps base -> current resolution. For the
        # standard default_real flow (constructed at base, scale 1) this
        # equals the reference's `scale = h / H` (camera.py:72); for a
        # camera constructed at a non-base resolution (e.g. "1280x720",
        # scale 2) the reference's overwrite yields wrong intrinsics.
        self.scale *= h / self.H
        self.resolution_str = f"{w}x{h}"
        self._changed_res = True

    @property
    def resolution(self):
        w, h = self.resolution_str.split("x")
        return int(h), int(w)

    @property
    def H(self) -> int:
        return self.resolution[0]

    @property
    def W(self) -> int:
        return self.resolution[1]

    @property
    def K_color(self) -> K:
        return K(*self.intrinsics["color"]) * self.scale

    @property
    def K_depth(self) -> K:
        return K(*self.intrinsics["depth"]) * self.scale

    @property
    def min_depth(self):
        return self.config["min_depth"]

    @property
    def max_depth(self):
        return self.config["max_depth"]

    @property
    def fxb_color(self):
        return self.baseline * self.K_color.fx

    @property
    def fxb_depth(self):
        return self.baseline * self.K_depth.fx

    @property
    def min_disp(self):
        return self.K_depth.fx * self.baseline / self.config["max_depth"]

    @property
    def max_disp(self):
        return self.K_depth.fx * self.baseline / self.config["min_depth"]

    def normalize_disp(self, disp):
        return normalize_disp(disp, self.min_disp, self.max_disp, self.config["shift"])

    def unnormalize_disp(self, disp):
        un = unnormalize_disp(disp, self.min_disp, self.max_disp, self.config["shift"])
        return np.clip(un, self.min_disp, self.max_disp)

    @property
    def T_cl(self) -> np.ndarray:
        return self._T_fc @ self.extrinsics["color_to_depth"] @ self._T_fc.T

    # ------------------------------------------------------------------ #
    def _reproject(self, depth: np.ndarray, K_src: np.ndarray, K_dst: np.ndarray,
                   T: np.ndarray, out_hw, aggressive_fill: bool) -> np.ndarray:
        """Scatter depth from one camera frame into another
        (reference: camera.py:654-701, vectorized)."""
        H, W = depth.shape[:2]
        oH, oW = out_hw
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        pix = np.stack([xs.ravel(), ys.ravel(), np.ones(H * W, np.float32)])
        d = depth.reshape(1, -1)
        pts = (np.linalg.inv(K_src) @ pix) * d
        pts = T[:3, :3] @ pts + T[:3, 3:]
        # destination-frame z (equals the source depth for the RealSense
        # pure-translation transform; correct for general T — see
        # ops/reproject.py)
        z_dst = pts[2]
        valid = (d[0] > 0.0) & (z_dst > 0.0)
        proj = K_dst @ pts
        u = proj[0] / np.maximum(proj[2], 1e-12)
        v = proj[1] / np.maximum(proj[2], 1e-12)

        out = np.zeros((oH, oW), np.float32)

        def fill(uu, vv):
            uu = np.round(uu).astype(np.int64)
            vv = np.round(vv).astype(np.int64)
            ok = valid & (uu >= 0) & (uu < oW) & (vv >= 0) & (vv < oH)
            out[vv[ok], uu[ok]] = z_dst[ok]

        if aggressive_fill:
            fill(np.floor(u), np.floor(v))
            fill(np.floor(u), np.ceil(v))
            fill(np.ceil(u), np.floor(v))
            fill(np.ceil(u), np.ceil(v))
        else:
            fill(u, v)
        return out


class RGBDCamera(DepthCamera):
    """RGB-D camera with identity or measured color<->depth extrinsics
    (reference: camera.py:180-330)."""

    def __init__(self, resolution, rgb_cam_params, depth_cam_params, extrinsics):
        super().__init__(resolution)
        self.intrinsics["color"] = np.asarray(rgb_cam_params["intrinsic"])
        self.distortions["color"] = np.asarray(rgb_cam_params["distortion"])
        self.intrinsics["depth"] = np.asarray(depth_cam_params["intrinsic"])
        self.distortions["depth"] = np.asarray(depth_cam_params["distortion"])
        self.extrinsics["color_to_depth"] = np.asarray(extrinsics)
        self.config.update(
            min_depth=0.2, max_depth=5.0, shift=0.0, margin_left=0,
            aggressive_fill=True,
        )

    # pseudo-baselines tuned so fxb matches a RealSense (reference hack,
    # camera.py:225-243)
    @staticmethod
    def default_nyu() -> "RGBDCamera":
        return RGBDCamera(
            "640x480",
            {"intrinsic": [518.8579011745019, 519.4696111212749, 325.5824494111903, 253.73616633400465],
             "distortion": [0.20796615318809061, -0.5861382516391178, 7.2231363135888329e-04, 1.0479627195765181e-03, 0.49856986684705107]},
            {"intrinsic": [582.6244816773796, 582.6910327098864, 313.0447587080473, 238.44389626620386],
             "distortion": [-0.09989723655308448, 0.39065324602765344, 1.9290592870229277e-03, -1.9422022475975055e-03, -0.5103172505340058]},
            [[0.9999779894082926, 5.0518419386157446e-03, 4.3011152014118693e-03, 2.5031875059141302e-02],
             [-5.0359919480810989e-03, 0.99998051861144, -3.6879781309514218e-03, 6.6238747008330102e-04],
             [-4.3196624923060242e-03, 3.6662365748484798e-03, 0.9999839494838554, -2.9342312935846411e-04],
             [0, 0, 0, 1]],
        )

    @staticmethod
    def default_clearpose() -> "RGBDCamera":
        cam = RGBDCamera(
            "640x480",
            {"intrinsic": [601.33333333, 601.33333333, 334.66666667, 248.0], "distortion": []},
            {"intrinsic": [601.33333333, 601.33333333, 334.66666667, 248.0], "distortion": []},
            np.eye(4),
        )
        cam.device = "clearpose"
        cam._baseline = 24.54705 / 601.33333333
        return cam

    @staticmethod
    def default_syntodd() -> "RGBDCamera":
        cam = RGBDCamera(
            "640x480",
            {"intrinsic": [613.9624633789062, 613.75634765625, 324.4471435546875, 239.1712188720703], "distortion": []},
            {"intrinsic": [613.9624633789062, 613.75634765625, 324.4471435546875, 239.1712188720703], "distortion": []},
            np.eye(4),
        )
        cam.device = "syntodd"
        cam._baseline = 24.54705 / 613.9624633789062
        return cam

    @property
    def K(self) -> K:
        return self.K_depth

    @property
    def baseline(self):
        if hasattr(self, "_baseline"):
            return self._baseline
        return 1.0 / self.K_depth.fx  # pseudo baseline: disparity = 1/depth

    @property
    def fxb(self):
        return self.fxb_depth

    def transform_depth_to_rgb_frame(self, depth: np.ndarray) -> np.ndarray:
        """Reproject the depth map into the color frame
        (reference: camera.py:262-302; no extrinsic rotation applied there —
        only intrinsic re-projection)."""
        H, W = self.H, self.W
        if depth.shape[:2] != (H, W):
            depth = resize(depth, (W, H), interpolation=INTER_NEAREST)
        return self._reproject(
            depth, self.K_depth.arr, self.K_color.arr, np.eye(4), (H, W),
            self.config["aggressive_fill"],
        )


# measured per-device RealSense calibrations (reference: camera.py:384-532 —
# calibration data, reproduced verbatim for parity)
_REALSENSE_CONFS = {
    "wsl": dict(
        color=[455.209289550781, 455.209289550781, 317.77197265625, 179.728973388672],
        depth=[447.721832275391, 447.721832275391, 322.147064208984, 172.095764160156],
        color_to_depth=[
            [0.999998, -0.000968804, -0.0016287, -0.0149246659129858],
            [0.000967551, 0.999999, -0.000770266, -3.58414604306745e-06],
            [0.00162944, 0.000768688, 0.999998, 4.43683347839396e-05],
            [0, 0, 0, 1]],
        left_to_right=[[1, 0, 0, -0.0551159121096134], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
    ),
    "cwb": dict(
        color=[455.966003417969, 455.966003417969, 323.101226806641, 172.794128417969],
        depth=[450.814300537109, 450.814300537109, 318.694610595703, 183.3427734375],
        color_to_depth=[
            [0.999939, -0.00144325, -0.0109409, -0.0150572098791599],
            [0.00139053, 0.999987, -0.00482466, 0.000150697553181089],
            [0.0109478, 0.00480915, 0.999929, -0.000134243455249816],
            [0, 0, 0, 1]],
        left_to_right=[[1, 0, 0, -0.0551359392702579], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
    ),
    "fxm": dict(
        color=[454.445556640625, 453.388824462891, 312.513153076172, 173.245956420898],
        depth=[443.914642333984, 443.914642333984, 315.938354492188, 186.570434570312],
        color_to_depth=[
            [0.999998, 0.00216086, 1.59334e-05, -0.0250564182549715],
            [-0.00216081, 0.999995, -0.00245083, -0.0100306203619402],
            [-2.12292e-05, 0.00245079, 0.999997, 0.000343983672792092],
            [0, 0, 0, 1]],
        left_to_right=[[1, 0, 0, -0.0547803528606892], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
    ),
    "jav": dict(
        color=[453.822387695312, 453.152984619141, 317.806304931641, 174.375793457031],
        depth=[445.645629882812, 445.645629882812, 319.318328857422, 185.445999145508],
        color_to_depth=[
            [0.999994, 0.000278227, 0.00333567, -0.0150431916117668],
            [-0.000274474, 0.999999, -0.00112542, -2.82119053736096e-05],
            [-0.00333598, 0.0011245, 0.999994, 0.000287492759525776],
            [0, 0, 0, 1]],
        left_to_right=[[1, 0, 0, -0.0547580868005753], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
    ),
    "d435_right": dict(
        color=[604.988525390625, 604.2501831054688, 325.60302734375, 251.7237548828125],
        depth=[455.379180908203, 455.442810058594, 319.510498046875, 190.218185424805],
        color_to_depth=[
            [0.999823, -0.0178564, -0.00593102, -0.0150311784818769],
            [0.0178789, 0.999833, 0.0037614, 3.65326523024123e-05],
            [0.00586286, -0.00386678, 0.999975, -0.00051211315440014],
            [0, 0, 0, 1]],
        left_to_right=[[1, 0, 0, -0.0547580868005753], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
    ),
}
_REALSENSE_CONFS["d435_wrist"] = _REALSENSE_CONFS["d435_right"]
_REALSENSE_CONFS["d435"] = _REALSENSE_CONFS["d435_right"]

_RES_SCALES = {
    "640x360": 1.0, "1280x720": 2.0, "224x126": 224 / 640, "320x256": 0.5,
    "960x540": 1.5, "480x270": 0.75,
}


class Realsense(DepthCamera):
    """Active-IR stereo RealSense (reference: camera.py:329-560)."""

    def __init__(self, resolution: str = "640x360", **kwargs):
        if resolution not in _RES_SCALES:
            raise RuntimeError("no supported resolution")
        super().__init__(resolution, _RES_SCALES[resolution])
        self.config = {
            "clip_minmax": True,
            "auto_scale": True,
            "aggressive_fill": True,
            "min_depth": kwargs.get("min_depth", 0.2),
            "max_depth": kwargs.get("max_depth", 2),
            "shift": kwargs.get("shift", 0.0),
            "margin_left": kwargs.get("margin_left", 0),
        }
        # OpenGL-style frame conversion: flip x and y (reference: camera.py:370-376)
        self._T_fc = np.diag([-1.0, -1.0, 1.0, 1.0])

    @staticmethod
    def default_sim(res="640x360", fov=71.28, t_cl=0.0, t_lr=0.055, **kwargs):
        cam = Realsense.create_sim(res, fov, t_cl, t_lr, **kwargs)
        cam.device = "sim"
        return cam

    @staticmethod
    def default_real(device="wsl") -> "Realsense":
        if device not in _REALSENSE_CONFS:
            raise RuntimeError(
                "unknown real device (no intrinsics/extrinsics), "
                "please call Realsense.create_real() instead."
            )
        conf = _REALSENSE_CONFS[device]
        cam = Realsense.create_real("640x360", conf)
        cam.device = device
        if device == "d435":
            cam.config["min_depth"] = 0.2
            cam.config["max_depth"] = 5.0
        return cam

    @staticmethod
    def create_sim(res, fov, t_cl, t_lr, **kwargs) -> "Realsense":
        cam = Realsense(res, **kwargs)
        H, W = cam.resolution
        H, W = int(H / cam.scale), int(W / cam.scale)  # standard 640x360
        fx = W / (2 * math.tan(math.radians(fov) / 2))
        intr = [fx, fx, W / 2 - 0.5, H / 2 - 0.5]
        T_cl = np.eye(4); T_cl[0, 3] = -t_cl
        T_lr = np.eye(4); T_lr[0, 3] = -t_lr
        cam.intrinsics["color"] = np.asarray(intr)
        cam.intrinsics["depth"] = np.asarray(intr)
        cam.extrinsics["color_to_depth"] = T_cl
        cam.extrinsics["left_to_right"] = T_lr
        return cam

    @staticmethod
    def create_real(res, conf) -> "Realsense":
        cam = Realsense(res)
        cam.intrinsics["color"] = np.asarray(conf["color"])
        cam.intrinsics["depth"] = np.asarray(conf["depth"])
        cam.extrinsics["color_to_depth"] = np.asarray(conf["color_to_depth"])
        cam.extrinsics["left_to_right"] = np.asarray(conf["left_to_right"])
        return cam

    @property
    def K(self) -> K:
        return self.K_color

    @property
    def T_lr(self) -> np.ndarray:
        return self._T_fc @ self.extrinsics["left_to_right"] @ self._T_fc.T

    @property
    def T_cr(self) -> np.ndarray:
        return self.T_cl @ self.T_lr

    @property
    def focal(self):
        return self.K_color.fx

    @property
    def baseline(self):
        return self.T_lr[0, 3]

    @property
    def fxb(self):
        return self.fxb_color

    def transform_depth_to_rgb_frame(self, depth: np.ndarray) -> np.ndarray:
        """Depth (IR frame) -> color frame with aggressive fill
        (reference: camera.py:654-701)."""
        if np.allclose(self.T_cl, np.eye(4)) or self.device == "d435":
            return depth
        H, W = self.H, self.W
        if self.config["auto_scale"] and depth.shape[:2] != (H, W):
            depth = resize(depth, (W, H), interpolation=INTER_NEAREST)
        return self._reproject(
            depth, self.K_depth.arr, self.K_color.arr, self.T_cl, (H, W),
            self.config["aggressive_fill"],
        )

    def transform_cropped_depth_to_rgb_frame(
        self, depth: np.ndarray, cropped_K: np.ndarray
    ) -> np.ndarray:
        """Cropped-window variant (reference: camera.py:610-652)."""
        if np.allclose(self.T_cl, np.eye(4)):
            return depth
        H, W = depth.shape[:2]
        off_x = int(self.K.cx - cropped_K[0, 2])
        off_y = int(self.K.cy - cropped_K[1, 2])
        full = self._reproject(
            depth, cropped_K, self.K_color.arr, self.T_cl, (self.H, self.W),
            aggressive_fill=False,
        )
        return full[off_y : off_y + H, off_x : off_x + W]
