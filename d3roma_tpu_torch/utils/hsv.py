"""RGB <-> HSV on uint8 images with OpenCV's `cv2.cvtColor` arithmetic
(COLOR_RGB2HSV and COLOR_HSV2RGB: hue in [0, 180)), on numpy arrays.

RGB -> HSV is OpenCV's fixed point with 12 fractional bits:
v = max, s = round(diff * round(255 * 2^12 / v) / 2^12), and the hue
sector's numerator times round(180 * 2^12 / (6 * diff)), rounded the same
way, plus 180 when negative.

HSV -> RGB is OpenCV's float path: s and v scaled by the float 1/255, the
hue by 6/180 in float32, the sector its integer part and f the rest, the
channels chosen from v, v(1 - s), v * fma(-s, f, 1) and
v * fma(-s, 1 - f, 1), each times 255 in float32. OpenCV then truncates in
its vector loop, which takes a row's pixels CV_SIMD_PIXELS at a time, and
rounds to nearest (ties to even) in its scalar loop over the row's last
width % CV_SIMD_PIXELS pixels; CV_SIMD_PIXELS is 32, the uint8 lanes of an
AVX2 build's vectors.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rgb_to_hsv", "hsv_to_rgb"]

_SHIFT = 12
CV_SIMD_PIXELS = 32
_HALF = 1 << (_SHIFT - 1)


def _tables():
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << _SHIFT) / np.maximum(i, 1)), 0)
        hdiv = np.where(i > 0, np.rint((180 << _SHIFT) / (6.0 * np.maximum(i, 1))), 0)
    return sdiv.astype(np.int64), hdiv.astype(np.int64)


_SDIV, _HDIV = _tables()
# tab indices of (b, g, r) for each hue sector, as OpenCV's sector_data
_SECTOR_BGR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_RGB2HSV)` for a uint8 [..., 3] image."""
    if img.dtype != np.uint8 or img.shape[-1] != 3:
        raise ValueError(f"expected uint8 [..., 3], got {img.dtype} {img.shape}")
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    s = (diff * _SDIV[v] + _HALF) >> _SHIFT
    vr = v == r
    vg = v == g
    h = np.where(vr, g - b, np.where(vg, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + _HALF) >> _SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).clip(0, 255).astype(np.uint8)


def _fma(a: np.ndarray, b: np.ndarray, c) -> np.ndarray:
    """float32 fma(a, b, c): the float64 product of two float32s is exact,
    and over the uint8 HSV domain one rounding of the float64 sum to float32
    gives the fused result (checked against cv2 on every H < 180, S, V)."""
    return (a.astype(np.float64) * b.astype(np.float64) + np.float64(c)).astype(np.float32)


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_HSV2RGB)` for a uint8 [..., W, 3] image
    with hue < 180."""
    if img.dtype != np.uint8 or img.shape[-1] != 3:
        raise ValueError(f"expected uint8 [..., 3], got {img.dtype} {img.shape}")
    f32 = np.float32
    h = img[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = img[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = img[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(h)
    h = (h - sector).astype(f32)
    sector = sector.astype(np.int64) % 6
    one = f32(1.0)
    tab = np.stack([v, v * (one - s), v * _fma(-s, h, one), v * _fma(-s, one - h, one)], axis=-1)
    bgr = np.take_along_axis(tab, _SECTOR_BGR[sector], axis=-1)
    rgb = bgr[..., ::-1] * f32(255.0)
    # OpenCV's vector loop truncates, its scalar tail rounds (ties to even)
    width = img.shape[-2] if img.ndim >= 2 else 1
    vec = (width // CV_SIMD_PIXELS) * CV_SIMD_PIXELS
    out = np.rint(rgb)
    if img.ndim >= 2 and vec:
        out[..., :vec, :] = np.trunc(rgb[..., :vec, :])
    return np.clip(out, 0, 255).astype(np.uint8)
