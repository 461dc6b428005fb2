"""PNG read and write on zlib and numpy.

The stand-in for PIL's and OpenCV's PNG I/O, which the machine with the
card does not have. `read_png` decodes colour types 0 (gray), 2 (RGB),
4 (gray + alpha) and 6 (RGBA) at 8 and 16 bits a sample into a uint8 or
uint16 array [H, W] (gray) or [H, W, C], channels in the file's order
(RGB, not OpenCV's BGR). Palette images and interlaced files raise
`PngError`, as do other bit depths. `write_png` writes gray and RGB at 8
and 16 bits.

The five row filters: None and Up are one numpy operation a row, Sub one
cumulative sum a row over each byte lane. Average and Paeth read the
byte `bpp` to the left already reconstructed, so they are sequential
within a row; and Up, Average and Paeth read the row above, so rows are
sequential too. An image with any Average or Paeth row is therefore
reconstructed over its anti-diagonals of pixels (row y, pixel x at step
y + x): the left, upper and upper-left neighbours of every pixel of a
diagonal are on the two before it, so each step is a few numpy
operations over the diagonal's pixels and byte lanes (held skewed, so
that they are contiguous slices), each pixel's row filter chosen by
np.where, and the image takes H + W - 1 steps instead of H * W.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

__all__ = ["PngError", "read_png", "write_png", "decode_png", "encode_png", "row_filters"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVERAGE, FILTER_PAETH = range(5)


class PngError(ValueError):
    """A file outside what this module reads, or a malformed one."""


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise PngError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        if len(body) != length:
            raise PngError("truncated chunk")
        crc = struct.unpack(">I", data[pos + 8 + length: pos + 12 + length])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise PngError(f"bad CRC in chunk {kind!r}")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise PngError("no IEND chunk")


def _header(data: bytes) -> Tuple[int, int, int, int, bytes]:
    """(height, width, bit depth, colour type, the concatenated IDAT)."""
    ihdr, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise PngError("no IHDR chunk")
    width, height, depth, ctype, compression, filter_method, interlace = ihdr
    if ctype == 3:
        raise PngError("palette PNGs are not supported")
    if ctype not in _CHANNELS:
        raise PngError(f"unknown colour type {ctype}")
    if depth not in (8, 16):
        raise PngError(f"bit depth {depth} is not supported (8 or 16)")
    if interlace != 0:
        raise PngError("interlaced PNGs are not supported")
    if compression != 0 or filter_method != 0:
        raise PngError("unknown compression or filter method")
    return height, width, depth, ctype, b"".join(idat)


def row_filters(data: bytes) -> np.ndarray:
    """The filter type of each row of a PNG file's bytes, [H] uint8."""
    height, width, depth, ctype, idat = _header(data)
    stride = width * _CHANNELS[ctype] * depth // 8
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)[: height * (stride + 1)]
    return rows.reshape(height, stride + 1)[:, 0].copy()


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(filt: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Rows with None, Sub and Up filters only: one row at a time."""
    height, stride = filt.shape
    out = np.empty_like(filt)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        row, t = filt[y], types[y]
        if t == FILTER_NONE:
            out[y] = row
        elif t == FILTER_UP:
            out[y] = row + prior
        else:  # Sub: a running sum mod 256 in each byte lane
            out[y] = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        prior = out[y]
    return out


def _unfilter_wavefront(filt: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Any filters: over the anti-diagonals of pixels (module docstring).
    The image is held skewed, diagonal d of pixel (y, x = d - y) at
    s[d + 2, y + 1], so that each step reads its left, upper and
    upper-left neighbours as contiguous slices of the two diagonals before
    it; entries outside the image stay 0, the filters' zero border."""
    height, stride = filt.shape
    width = stride // bpp
    ys, xs = np.mgrid[0:height, 0:width]
    diag = ys + xs
    f = np.zeros((height + width + 1, height + 1, bpp), np.int16)
    f[diag + 2, ys + 1] = filt.reshape(height, width, bpp)
    s = np.zeros_like(f)
    t = types.astype(np.int16)[:, None]
    for d in range(height + width - 1):
        y0, y1 = max(0, d - width + 1), min(height, d + 1)
        a = s[d + 1, y0 + 1: y1 + 1]    # left
        b = s[d + 1, y0: y1]            # up
        c = s[d, y0: y1]                # up-left
        tt = t[y0:y1]
        pred = np.where(tt == FILTER_SUB, a, np.where(tt == FILTER_UP, b, 0))
        avg_rows = tt == FILTER_AVERAGE
        if avg_rows.any():
            pred = np.where(avg_rows, (a + b) >> 1, pred)
        paeth_rows = tt == FILTER_PAETH
        if paeth_rows.any():
            pred = np.where(paeth_rows, _paeth(a, b, c), pred)
        s[d + 2, y0 + 1: y1 + 1] = (f[d + 2, y0 + 1: y1 + 1] + pred) & 0xFF
    return s[diag + 2, ys + 1].astype(np.uint8).reshape(height, stride)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> uint8 / uint16 array ([H, W] or [H, W, C])."""
    height, width, depth, ctype, idat = _header(data)
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size < height * (stride + 1):
        raise PngError("image data too short")
    rows = raw[: height * (stride + 1)].reshape(height, stride + 1)
    types, filt = rows[:, 0], rows[:, 1:]
    if types.max(initial=0) > FILTER_PAETH:
        raise PngError(f"unknown row filter {int(types.max())}")
    if np.isin(types, (FILTER_AVERAGE, FILTER_PAETH)).any():
        pixels = _unfilter_wavefront(filt, types, bpp)
    else:
        pixels = _unfilter_rows(filt, types, bpp)
    if depth == 16:
        pixels = pixels.reshape(height, width * channels, 2).view(">u2")[..., 0].astype(np.uint16)
    img = pixels.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, filter_type: int = FILTER_UP) -> bytes:
    """uint8 or uint16 [H, W] / [H, W, 1] (gray) or [H, W, 3] (RGB) -> PNG
    bytes, every row with `filter_type` (any
    of the five; Up by default, one vector operation a row to undo)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype == np.uint8 and img.ndim == 2:
        depth, ctype, channels = 8, 0, 1
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, ctype, channels = 8, 2, 3
    elif img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype, channels = 16, 0, 1
    elif img.dtype == np.uint16 and img.ndim == 3 and img.shape[2] == 3:
        depth, ctype, channels = 16, 2, 3
    else:
        raise PngError(f"cannot write {img.dtype} {img.shape}: 8- or 16-bit gray or RGB")
    height, width = img.shape[:2]
    bpp = channels * depth // 8
    if depth == 16:
        raw = np.ascontiguousarray(img.astype(">u2")).view(np.uint8)
    else:
        raw = np.ascontiguousarray(img).view(np.uint8)
    raw = raw.reshape(height, width * bpp).astype(np.int16)
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    upleft = np.zeros_like(raw)
    upleft[1:, bpp:] = raw[:-1, :-bpp]
    pred = {FILTER_NONE: 0, FILTER_SUB: left, FILTER_UP: up,
            FILTER_AVERAGE: (left + up) >> 1, FILTER_PAETH: _paeth(left, up, upleft)}
    if filter_type not in pred:
        raise PngError(f"unknown row filter {filter_type}")
    filt = ((raw - pred[filter_type]) & 0xFF).astype(np.uint8)
    rows = np.concatenate([np.full((height, 1), filter_type, np.uint8), filt], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filter_type: int = FILTER_UP) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type))
