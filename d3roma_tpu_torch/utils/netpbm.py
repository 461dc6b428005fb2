"""Binary netpbm (P5 gray, P6 RGB) read as PIL reads it, without PIL.

`read_ppm(path)` returns `np.array(PIL.Image.open(path))`: a P5 file with
maxval <= 255 is uint8 [H, W], one with a larger maxval int32 [H, W] (PIL's
mode "I"); a P6 file is uint8 [H, W, 3] whatever its maxval. Samples are 1
byte, or 2 big-endian bytes where maxval > 255. Where maxval is not the
output's full scale (255, or 65535 for mode "I") each sample becomes
min(full, round(v / maxval * full)), as PIL's PpmDecoder computes it in
float64 with ties to even. ASCII (P1-P3), bitmap (P4) and float (Pf, PF)
files raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_ppm", "decode_ppm"]


def _header(data: bytes, name: str):
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace() and data[pos:pos + 1] != b"#":
            pos += 1
        if start == pos:
            raise ValueError(f"{name}: truncated netpbm header")
        fields.append(int(data[start:pos]))
    return fields, pos + 1  # one whitespace byte ends the header


def decode_ppm(data: bytes, name: str = "<bytes>") -> np.ndarray:
    magic = data[:2]
    if magic not in (b"P5", b"P6"):
        raise NotImplementedError(f"{name}: netpbm format {magic!r} (only binary P5 and P6)")
    (width, height, maxval), pos = _header(data, name)
    if not 0 < maxval < 65536:
        raise ValueError(f"{name}: bad maxval {maxval}")
    bands = 1 if magic == b"P5" else 3
    dtype = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
    count = width * height * bands
    raw = np.frombuffer(data, dtype, count, pos) if len(data) >= pos + count * dtype.itemsize \
        else None
    if raw is None:
        raise ValueError(f"{name}: netpbm data too short")
    wide = bands == 1 and maxval > 255
    full = 65535 if wide else 255
    if maxval == full:
        img = raw.astype(np.int32 if wide else np.uint8)
    else:
        scaled = np.minimum(full, np.round(raw.astype(np.float64) / maxval * full))
        img = scaled.astype(np.int32 if wide else np.uint8)
    return img.reshape((height, width) if bands == 1 else (height, width, 3))


def read_ppm(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_ppm(f.read(), str(path))
