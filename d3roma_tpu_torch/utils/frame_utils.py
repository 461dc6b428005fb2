"""File-format IO for depth/disparity/flow data.

Port of `d3roma_tpu/utils/frame_utils.py`: PFM, Middlebury .flo, KITTI
16-bit PNG, EXR/NPY/PNG depth-or-disparity with per-device unit/validity
windows, SceneFlow resolution-rescaled disparity, and griddata hole
filling (scipy). OpenCV and PIL are not on the machine with the card:
PNGs are read and written by `utils/png.py` (RGB channel order where
`cv2.imread` gives BGR: the reads that took BGR channels flip
explicitly), resizes go through `utils/resize.py` (cv2.resize's
semantics), EXRs through the native reader `utils/native_io.py` (else
`utils/exr.py`, as the JAX package's hook falls back). `read_gen`
returns a numpy array where the JAX package returns a PIL image (its
callers take `np.array` of it either way). PNG, JPEG and binary PPM files
are told apart by their content, as PIL tells them: a PNG named .jpg reads
as a PNG, a JPEG named .png as a JPEG. JPEGs go through the port's host
decoder (`utils/jpeg.py`), PPMs through `utils/netpbm.py`, both PIL's
pixels bit for bit.
"""

from __future__ import annotations

import os
import re
from os.path import splitext
import numpy as np

from d3roma_tpu_torch.utils import jpeg, native_io, netpbm, png
from d3roma_tpu_torch.utils.exr import read_exr
from d3roma_tpu_torch.utils.resize import INTER_NEAREST, resize

TAG_CHAR = np.array([202021.25], np.float32)  # .flo magic


def _read_exr_file(path):
    """EXR read: the native threaded decoder (`utils/native_io.py`) first,
    then the pure-Python reader (`utils/exr.py`) where the native library
    is not built or refuses the file."""
    try:
        if native_io.available():
            return native_io.read_exr(path)
    except (NotImplementedError, ValueError, OSError):
        pass
    return read_exr(path)


def _read_gray(path):
    """A gray PNG as `cv2.imread(path, IMREAD_GRAYSCALE / ANYDEPTH)` reads
    one; a colour file raises (OpenCV would convert it to gray)."""
    img = png.read_png(path)
    if img.ndim != 2:
        raise NotImplementedError(f"{path}: a colour PNG where a gray one is read")
    return img


# ---------------------------------------------------------------------- #
# PFM
# ---------------------------------------------------------------------- #


def readPFM(path) -> np.ndarray:
    """Portable float map; returns float32 [H,W] or [H,W,3], top-row-first."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dims = f.readline()
        while dims.startswith(b"#"):
            dims = f.readline()
        m = re.match(rb"^(\d+)\s(\d+)\s*$", dims)
        if not m:
            raise ValueError("Malformed PFM header.")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).astype(np.float32)


def writePFM(path, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("Image must have H x W x 3, H x W x 1 or H x W dims.")
    endian = image.dtype.byteorder
    if endian == "<" or (endian == "=" and np.little_endian):
        scale = -scale
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)


# ---------------------------------------------------------------------- #
# Optical flow / KITTI
# ---------------------------------------------------------------------- #


def readFlow(path) -> np.ndarray:
    """Middlebury .flo -> [H, W, 2] float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)
        if magic != TAG_CHAR[0]:
            raise ValueError(f"invalid .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, 2 * w * h)
    return data.reshape(h, w, 2)


def writeFlow(path, uv: np.ndarray) -> None:
    assert uv.ndim == 3 and uv.shape[2] == 2
    with open(path, "wb") as f:
        TAG_CHAR.tofile(f)
        np.array([uv.shape[1]], np.int32).tofile(f)
        np.array([uv.shape[0]], np.int32).tofile(f)
        uv.astype(np.float32).tofile(f)


def readFlowKITTI(path):
    """16-bit KITTI flow png -> (flow [H,W,2], valid [H,W])."""
    flow = png.read_png(path).astype(np.float32)  # RGB, as cv2's BGR flipped
    flow, valid = flow[:, :, :2], flow[:, :, 2]
    flow = (flow - 2**15) / 64.0
    return flow, valid


def writeFlowKITTI(path, uv: np.ndarray) -> None:
    uv = 64.0 * uv + 2**15
    valid = np.ones((uv.shape[0], uv.shape[1], 1))
    uv = np.concatenate([uv, valid], axis=-1).astype(np.uint16)
    png.write_png(path, uv)  # RGB: cv2.imwrite of the BGR flip


def readDispKITTI(path):
    disp = _read_gray(path) / 256.0
    return disp, disp > 0.0


def readDispSintelStereo(path):
    """MPI-Sintel RGB-packed disparity PNG + sibling occlusion mask
    (reference: utils_d3roma/frame_utils.py:135-141; encoding per the
    Sintel SDK: d = R*4 + G/2^6 + B/2^14, occluded where the mask under
    training/occlusions is nonzero)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    img = png.read_png(path)
    r, g, b = [img[..., i].astype(np.float32) for i in range(3)]  # RGB
    disp = r * 4.0 + g / (2 ** 6) + b / (2 ** 14)
    occ_path = path.replace("disparities", "occlusions")
    if not os.path.exists(occ_path):
        # a missing mask must not silently yield an all-False valid mask
        raise FileNotFoundError(occ_path)
    occ = _read_gray(occ_path)
    valid = (occ == 0) & (disp > 0)
    return disp, valid


def readDispFallingThings(path):
    """FallingThings 16-bit depth PNG (0.1 mm units) -> disparity via the
    fx recorded in the scene's _camera_settings.json and the fixed 6 cm
    stereo baseline (reference: utils_d3roma/frame_utils.py:144-151,
    per the NVIDIA dataset readme)."""
    import json as _json

    if not os.path.exists(path):
        raise FileNotFoundError(path)
    depth = _read_gray(path)
    with open(os.path.join(os.path.dirname(path),
                           "_camera_settings.json")) as f:
        fx = _json.load(f)["camera_settings"][0]["intrinsic_settings"]["fx"]
    depth = depth.astype(np.float32)
    disp = np.where(depth > 0, (fx * 6.0 * 100.0) / np.maximum(depth, 1e-6),
                    0.0)
    return disp, disp > 0


def readDispTartanAir(path):
    """TartanAir depth .npy -> disparity: fx*baseline = 320 * 0.25 = 80
    (reference: utils_d3roma/frame_utils.py:153-158, per the tartanair
    data_type docs)."""
    depth = np.load(path).astype(np.float32)
    disp = np.where(depth > 0, 80.0 / np.maximum(depth, 1e-6), 0.0)
    return disp, disp > 0


# ---------------------------------------------------------------------- #
# Depth / disparity readers with camera semantics
# ---------------------------------------------------------------------- #


def readDispReal(camera, filename: str):
    """Read real-capture raw data (depth png/exr/npy or disparity), convert
    to disparity at the camera resolution with per-device depth units and
    validity windows (reference: frame_utils.py:165-216).

    Returns (disp, valid, min_disp, max_disp).
    """
    if not os.path.exists(filename):
        # missing-file fault masking (reference: frame_utils.py:170-172)
        return (
            np.ones(camera.resolution), np.ones(camera.resolution, bool), 0, 1
        )
    ext = splitext(filename)[-1]
    if ext == ".png":
        data = _read_gray(filename)
    elif ext == ".npy":
        data = np.load(filename)
    elif ext == ".exr":
        data = _read_exr_file(filename)
        if data is not None and data.ndim == 3 and data.shape[-1] == 3:
            data = data[..., 0]
    else:
        raise NotImplementedError(ext)

    scale = data.shape[1] / camera.resolution[1]
    data = resize(data, dsize=camera.resolution[::-1], interpolation=INTER_NEAREST)
    valid = ~np.isinf(data) & ~np.isnan(data) & (data > 0)

    if "depth" in filename or "Depth" in filename:
        disp = np.zeros_like(data, np.float32)
        depth_unit = 1.0
        if camera.device in ("fxm", "jav", "d435"):
            depth_unit = 1e-3  # millimeters
            valid = valid & (data > 200) & (data < 3000)
            data = np.clip(data, 0.0, 3000)
        elif camera.device == "clearpose":
            depth_unit = 1e-3
            max_depth = camera.max_depth / depth_unit
            valid = valid & (data > camera.min_depth / depth_unit) & (data < max_depth)
            data = np.clip(data, 0.0, max_depth)
        disp[valid] = camera.fxb_depth / (data[valid] * depth_unit)
    else:
        disp = data / scale  # disparity scales with resolution

    valid = (disp > camera.min_disp) & (disp < camera.max_disp) & valid
    return disp, valid, camera.min_disp, camera.max_disp


def readDispDreds_exr(camera, filename: str):
    """DREDS GT depth exr -> disparity (reference: frame_utils.py:218-231)."""
    depth = _read_exr_file(filename)
    if depth.ndim == 3 and depth.shape[-1] == 3:
        depth = depth[..., 0]
    if depth.shape[:2] != tuple(camera.resolution):
        depth = resize(depth, dsize=camera.resolution[::-1], interpolation=INTER_NEAREST)
    valid = (~(np.isinf(depth) | np.isnan(depth))) & (depth > 0.2) & (depth < 2)
    disp = np.zeros_like(depth)
    disp[valid] = camera.fxb / depth[valid]
    return disp, valid, camera.min_disp, camera.max_disp


def readDispSTD_exr(filename: str):
    disp = _read_exr_file(filename)
    valid = (~(np.isinf(disp) | np.isnan(disp))) & (disp != 0)
    return disp, valid


def readDispMiddlebury(file_name: str):
    """GT pfm + calib.txt parsing (reference: frame_utils.py:309-352)."""
    if os.path.basename(file_name) == "disp0GT.pfm":
        disp = readPFM(file_name).astype(np.float32)
        assert disp.ndim == 2
        nocc_pix = os.path.join(os.path.dirname(file_name), "mask0nocc.png")
        assert os.path.exists(nocc_pix)
        nocc_pix = _read_gray(nocc_pix) == 255
        assert np.any(nocc_pix)
        return disp, nocc_pix
    elif os.path.basename(file_name) == "disp0.pfm":
        disp = readPFM(file_name).astype(np.float32)
        valid = disp < 1e3
        return disp, valid
    raise ValueError(file_name)


def read_sceneflow(resolution, file_name: str, pil: bool = False):
    """SceneFlow disparity with resolution-scaled bounds
    (reference: frame_utils.py:360-378)."""
    disp = np.array(read_gen(file_name, pil)).astype(np.float32)
    assert disp.ndim == 2
    scale, min_disp, max_disp = 1.0, 0.5, 256.0
    if resolution is not None and disp.shape != tuple(resolution):
        # height-ratio scale, as the reference computes it
        # (frame_utils.py:373) — exact only for aspect-preserving
        # resolutions, which is all the eval protocol supports
        # (evaluate.py's scale=960/W makes the same assumption)
        scale = disp.shape[0] / resolution[0]
        disp = resize(disp, tuple(resolution[::-1]), interpolation=INTER_NEAREST)
        disp = disp / scale
        max_disp /= scale
        min_disp /= scale
    return disp, (disp < max_disp) & (disp > min_disp), min_disp, max_disp


def read_image(file_name: str) -> np.ndarray:
    """A PNG, JPEG or binary PPM file as `np.array(PIL.Image.open(...))`,
    its format told by its first bytes."""
    with open(file_name, "rb") as f:
        data = f.read()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return png.decode_png(data)
    if jpeg.is_jpeg(data):
        return jpeg.decode_jpeg(data, file_name)
    if data[:1] == b"P":
        return netpbm.decode_ppm(data, file_name)
    raise NotImplementedError(f"{file_name}: not a PNG, JPEG or binary PPM file")


def read_gen(file_name: str, pil: bool = False):
    """Extension-dispatched generic reader (reference: frame_utils.py:380-398).
    A PNG comes back as `np.array(PIL.Image.open(...))` would: uint8 gray,
    RGB or RGBA, uint16 for 16-bit gray."""
    ext = splitext(file_name)[-1]
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        return read_image(file_name)
    if ext in (".bin", ".raw", ".npy"):
        return np.load(file_name)
    if ext == ".flo":
        return readFlow(file_name).astype(np.float32)
    if ext == ".pfm":
        flow = readPFM(file_name).astype(np.float32)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    if ext == ".exr":
        return _read_exr_file(file_name)
    return []


def interpolate_missing_pixels(
    image: np.ndarray, mask: np.ndarray, method: str = "nearest", fill_value=0
) -> np.ndarray:
    """Fill masked (missing) pixels by griddata interpolation
    (reference: frame_utils.py:402-435)."""
    from scipy import interpolate

    assert image.ndim == 2
    h, w = image.shape
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    interp = interpolate.griddata(
        (xx[~mask], yy[~mask]), image[~mask], (xx[mask], yy[mask]),
        method=method, fill_value=fill_value,
    )
    out = image.copy()
    out[mask] = interp
    return out
