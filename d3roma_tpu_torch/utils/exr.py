"""Minimal OpenEXR scanline IO (float32, NONE or ZIP compression).

Port of `d3roma_tpu/utils/exr.py` (pure Python on `zlib` and `struct`):
the depth datasets store GT and sensor depth as .exr, which neither
OpenCV's nor PIL's builds read everywhere. It covers the simple subset
those files use: single-part scanline images, FLOAT (and HALF on read)
channels, NO_COMPRESSION or ZIP/ZIPS (zlib + the EXR byte-delta and
deinterleave transform, here as one numpy cumulative sum).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

MAGIC = 0x01312F76

# compression ids
NO_COMPRESSION = 0
ZIPS_COMPRESSION = 2  # 1 scanline per block
ZIP_COMPRESSION = 3  # 16 scanlines per block

PIXELTYPE_FLOAT = 2
PIXELTYPE_HALF = 1


def _write_attr(f, name: str, type_name: str, data: bytes):
    f.write(name.encode() + b"\x00")
    f.write(type_name.encode() + b"\x00")
    f.write(struct.pack("<i", len(data)))
    f.write(data)


def write_exr(path: str, image: np.ndarray, channel_names: List[str] = None) -> None:
    """image: [H,W] or [H,W,C] float32. Channels default to Y or BGR-style
    R,G,B naming (alphabetical storage order as EXR requires)."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if channel_names is None:
        channel_names = ["Y"] if C == 1 else ["B", "G", "R"][:C]
    order = sorted(range(C), key=lambda i: channel_names[i])

    with open(path, "wb") as f:
        f.write(struct.pack("<I", MAGIC))
        f.write(struct.pack("<I", 2))  # version 2, scanline

        chan = b""
        for i in order:
            chan += channel_names[i].encode() + b"\x00"
            chan += struct.pack("<iiii", PIXELTYPE_FLOAT, 0, 1, 1)
        chan += b"\x00"
        _write_attr(f, "channels", "chlist", chan)
        _write_attr(f, "compression", "compression", bytes([NO_COMPRESSION]))
        box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
        _write_attr(f, "dataWindow", "box2i", box)
        _write_attr(f, "displayWindow", "box2i", box)
        _write_attr(f, "lineOrder", "lineOrder", b"\x00")
        _write_attr(f, "pixelAspectRatio", "float", struct.pack("<f", 1.0))
        _write_attr(f, "screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        _write_attr(f, "screenWindowWidth", "float", struct.pack("<f", 1.0))
        f.write(b"\x00")  # end of header

        # scanline offset table
        table_pos = f.tell()
        f.write(b"\x00" * 8 * H)
        offsets = []
        for y in range(H):
            offsets.append(f.tell())
            row = img[y][:, order]  # [W, C] in storage order
            data = b"".join(row[:, ci].tobytes() for ci in range(len(order)))
            f.write(struct.pack("<ii", y, len(data)))
            f.write(data)
        f.seek(table_pos)
        f.write(struct.pack(f"<{H}Q", *offsets))


def _read_attr_headers(f) -> Dict:
    attrs = {}
    while True:
        name = _read_cstr(f)
        if name == "":
            break
        type_name = _read_cstr(f)
        (size,) = struct.unpack("<i", f.read(4))
        attrs[name] = (type_name, f.read(size))
    return attrs


def _read_cstr(f) -> str:
    out = b""
    while True:
        c = f.read(1)
        if c in (b"\x00", b""):
            return out.decode()
        out += c


def _parse_channels(data: bytes) -> List[Tuple[str, int]]:
    chans = []
    i = 0
    while i < len(data) and data[i] != 0:
        j = data.index(0, i)
        name = data[i:j].decode()
        ptype, _, _, _ = struct.unpack_from("<iiii", data, j + 1)
        chans.append((name, ptype))
        i = j + 1 + 16
    return chans


def _unzip_block(raw: bytes) -> bytes:
    data = np.frombuffer(zlib.decompress(raw), np.uint8)
    if data.size == 0:
        return b""
    # EXR zip post-filter: byte delta (a running sum of d - 128 mod 256
    # after the first byte), then deinterleave the two halves
    delta = data.astype(np.int16) - 128
    delta[0] = data[0]
    data = np.cumsum(delta, dtype=np.int64).astype(np.uint8)
    half = (data.size + 1) // 2
    out = np.empty_like(data)
    out[0::2] = data[:half]
    out[1::2] = data[half:]
    return out.tobytes()


def read_exr(path: str) -> np.ndarray:
    """Returns [H,W] for single-channel files, else [H,W,C] with channels
    in B,G,R(,A)-friendly order (R,G,B reversed from alphabetical when
    those names are present, matching cv2 expectations used upstream)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<II", f.read(8))
        if magic != MAGIC:
            raise ValueError(f"not an EXR file: {path}")
        # OpenEXR 2.0 version-field flags: 0x200 = single-part tiled,
        # 0x800 = deep data, 0x1000 = multi-part. All three change the
        # chunk layout this scanline reader assumes — misparsing a
        # multipart header as the offset table yields garbage pixels,
        # so reject loudly
        if version & 0x200:
            raise NotImplementedError("tiled EXR unsupported")
        if version & 0x800:
            raise NotImplementedError("deep-data EXR unsupported")
        if version & 0x1000:
            raise NotImplementedError("multi-part EXR unsupported")
        attrs = _read_attr_headers(f)
        chans = _parse_channels(attrs["channels"][1])
        comp = attrs["compression"][1][0]
        x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
        W, H = x1 - x0 + 1, y1 - y0 + 1
        C = len(chans)

        if comp == NO_COMPRESSION:
            lines_per_block = 1
        elif comp == ZIPS_COMPRESSION:
            lines_per_block = 1
        elif comp == ZIP_COMPRESSION:
            lines_per_block = 16
        else:
            raise NotImplementedError(f"EXR compression {comp} unsupported")

        n_blocks = (H + lines_per_block - 1) // lines_per_block
        f.read(8 * n_blocks)  # offset table (we read sequentially)

        dtype_sizes = {PIXELTYPE_FLOAT: 4, PIXELTYPE_HALF: 2}
        out = np.zeros((H, W, C), np.float32)
        for _ in range(n_blocks):
            y, size = struct.unpack("<ii", f.read(8))
            raw = f.read(size)
            n_lines = min(lines_per_block, H - (y - y0))
            expect = sum(W * dtype_sizes[pt] for _, pt in chans) * n_lines
            if comp != NO_COMPRESSION and size != expect:
                raw = _unzip_block(raw)
            pos = 0
            for line in range(n_lines):
                for ci, (name, ptype) in enumerate(chans):
                    nbytes = W * dtype_sizes[ptype]
                    buf = raw[pos : pos + nbytes]
                    pos += nbytes
                    if ptype == PIXELTYPE_FLOAT:
                        vals = np.frombuffer(buf, "<f4")
                    else:
                        vals = np.frombuffer(buf, "<f2").astype(np.float32)
                    out[y - y0 + line, :, ci] = vals

    names = [c[0] for c in chans]
    if C == 1:
        return out[..., 0]
    if set(names) >= {"R", "G", "B"}:
        # storage is alphabetical (B,G,R); return RGB-ordered
        idx = [names.index("R"), names.index("G"), names.index("B")]
        extra = [i for i in range(C) if i not in idx]
        return out[..., idx + extra]
    return out
