"""Image resizing with OpenCV's `cv2.resize` semantics, on numpy arrays.

The stand-in for `cv2.resize` on the machine with the card, which has no
OpenCV. The data loader resizes frames on the host, so this works on numpy
arrays [H, W] or [H, W, C]; `dsize` is (width, height) as OpenCV takes it,
or None with the scale factors `fx` and `fy`.

- `INTER_NEAREST`: the source index of output column x is
  floor(x * (1 / (dst_w / src_w))) in float64, clamped to src_w - 1, as
  OpenCV's `resizeNN` computes it. It is not PyTorch's "nearest-exact" nor
  `jax.image.resize`'s "nearest" (half-pixel centres).
- `INTER_LINEAR`: half-pixel centres, sx = floor(c) and weight c - sx of
  c = (x + 0.5) * src_w / dst_w - 0.5, or (x + 0.5) / fx - 0.5 with
  `fx`/`fy` and no `dsize` (c in float32 where OpenCV's own code resizes:
  uint8, and float images of 2 or more than 4 channels, on which this is
  bit-equal to cv2; in float64 for float images of 1, 3 or 4 channels,
  which cv2 hands to IPP, within a few ulps of it); edges clamped (a column
  left of 0 or right of the last reads the edge pixel with weight 1). For
  uint8, OpenCV's fixed point: weights rounded to 11 bits
  (round(w * 2048), half to even), the horizontal pass in exact int32,
  the vertical pass as OpenCV computes it for uint8, in its vector loop and
  its scalar tail alike: ((((S0 >> 4) * b0) >> 16) + (((S1 >> 4) * b1) >>
  16) + 2) >> 2, which drops low bits a rounded 22-bit shift would keep:
  bit-equal to cv2 on uint8. Other
  dtypes are interpolated in float32 with float32 weights.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["INTER_NEAREST", "INTER_LINEAR", "resize"]

INTER_NEAREST = 0
INTER_LINEAR = 1
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _nearest_index(src: int, dst: int, inv: float = 0.0) -> np.ndarray:
    ifx = 1.0 / (inv or dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64), src - 1)


def _taps(src: int, dst: int, fixed: bool, inv: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """(s [dst] int64, f [dst] float32): the source index floor(c) and the
    fraction c - floor(c) of c = (x + 0.5) * (1 / inv) - 0.5, inv the
    caller's scale factor or else dst / src, as OpenCV computes them: c
    rounded to float32 first (`fixed`: its own resize code, the uint8 path
    and the float path), else in float64 (the float images cv2 hands to
    IPP)."""
    scale = 1.0 / (inv or dst / src)
    c = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    if fixed:
        c = c.astype(np.float32)
        s = np.floor(c)
        return s.astype(np.int64), (c - s).astype(np.float32)
    s = np.floor(c)
    return s.astype(np.int64), (c - s).astype(np.float32)


def _linear_taps(src: int, dst: int, fixed: bool,
                 inv: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """The columns' taps, the edges clamped to (0, 0) and (src - 1, 0)."""
    s, f = _taps(src, dst, fixed, inv)
    low, high = s < 0, s >= src - 1
    f[low | high] = 0.0
    s[low] = 0
    s[high] = src - 1
    return s, f


def _fixed_weights(f: np.ndarray) -> np.ndarray:
    """[n, 2] int32: round((1 - f) * 2048), round(f * 2048) in float32,
    half to even, as OpenCV's saturate_cast<short>."""
    one = (np.float32(1.0) - f).astype(np.float32)
    w = np.stack([one * np.float32(_COEF_SCALE), f * np.float32(_COEF_SCALE)], axis=-1)
    return np.rint(w.astype(np.float32)).astype(np.int32)


def _linear_u8(img: np.ndarray, dh: int, dw: int, ifx: float = 0.0,
               ify: float = 0.0) -> np.ndarray:
    h, w = img.shape[:2]
    cn = img.shape[2] if img.ndim == 3 else 1
    x = img.reshape(h, w, cn).astype(np.int32)
    sx, fx = _linear_taps(w, dw, True, ifx)
    ax = _fixed_weights(fx)
    sx1 = np.minimum(sx + 1, w - 1)
    rows = x[:, sx] * ax[None, :, 0, None] + x[:, sx1] * ax[None, :, 1, None]  # [h, dw, cn]
    sy, fy = _taps(h, dh, True, ify)
    by = _fixed_weights(fy)  # no clamping of the weights in y: the rows clamp
    s0 = rows[np.clip(sy, 0, h - 1)].reshape(dh, dw * cn)
    s1 = rows[np.clip(sy + 1, 0, h - 1)].reshape(dh, dw * cn)
    b0, b1 = by[:, 0:1], by[:, 1:2]

    # S0, S1 <= 255 * 2048: S >> 4 fits int16, as OpenCV's v_pack needs
    out = ((((s0 >> 4) * b0) >> 16) + (((s1 >> 4) * b1) >> 16) + 2) >> 2
    out = np.clip(out, 0, 255).astype(np.uint8).reshape(dh, dw, cn)
    return out if img.ndim == 3 else out[..., 0]


def _linear_float(img: np.ndarray, dh: int, dw: int, ifx: float = 0.0,
                  ify: float = 0.0) -> np.ndarray:
    h, w = img.shape[:2]
    x = img.astype(np.float32)
    # cv2 resizes float images of 1, 3 or 4 channels with IPP, the rest
    # with its own code
    own = img.ndim == 3 and img.shape[2] not in (1, 3, 4)
    sx, fx = _linear_taps(w, dw, own, ifx)
    sx1 = np.minimum(sx + 1, w - 1)
    shape = (1, dw) + (1,) * (img.ndim - 2)
    ax0 = (np.float32(1.0) - fx).reshape(shape)
    ax1 = fx.reshape(shape)
    rows = x[:, sx] * ax0 + x[:, sx1] * ax1
    sy, fy = _taps(h, dh, own, ify)
    yshape = (dh,) + (1,) * (img.ndim - 1)
    out = (rows[np.clip(sy, 0, h - 1)] * (np.float32(1.0) - fy).reshape(yshape)
           + rows[np.clip(sy + 1, 0, h - 1)] * fy.reshape(yshape))
    return out.astype(img.dtype) if img.dtype.kind == "f" else out


def resize(img: np.ndarray, dsize: Optional[Tuple[int, int]] = None,
           interpolation: int = INTER_LINEAR, fx: Optional[float] = None,
           fy: Optional[float] = None) -> np.ndarray:
    """`cv2.resize(img, dsize, fx=..., fy=..., interpolation=...)` for
    INTER_NEAREST and INTER_LINEAR. `dsize` is (width, height); without it
    the output is (round(w * fx), round(h * fy)) (ties to even) and the
    source coordinates scale by 1 / fx and 1 / fy, as OpenCV maps them,
    not by src / dst."""
    img = np.asarray(img)
    h, w = img.shape[:2] if img.ndim >= 2 else (0, 0)
    ifx = ify = 0.0
    if dsize is None:
        if not (fx and fy and fx > 0 and fy > 0):
            raise ValueError("resize needs dsize or positive fx and fy")
        ifx, ify = float(fx), float(fy)
        dsize = (int(np.rint(w * ifx)), int(np.rint(h * ify)))
    dw, dh = int(dsize[0]), int(dsize[1])
    if img.ndim not in (2, 3) or dw <= 0 or dh <= 0:
        raise ValueError(f"cannot resize {img.shape} to {dsize}")
    if (h, w) == (dh, dw):
        return img.copy()
    if interpolation == INTER_NEAREST:
        return img[_nearest_index(h, dh, ify)][:, _nearest_index(w, dw, ifx)]
    if interpolation != INTER_LINEAR:
        raise NotImplementedError(f"interpolation {interpolation}")
    if img.dtype == np.uint8:
        return _linear_u8(img, dh, dw, ifx, ify)
    if img.dtype.kind not in "fiu":
        raise NotImplementedError(f"INTER_LINEAR on {img.dtype}")
    return _linear_float(img, dh, dw, ifx, ify)
