"""JPEG decode without PIL: `read_jpeg(path)` is `np.array(PIL.Image.open(path))`.

The machine with the card has no PIL, so the port decodes JPEGs with its
own host decoder, `csrc/jpeg_decode.cpp` (C++17, built by g++ at first use
into `_build/` through `utils/native_io.build`, bound with ctypes). It
copies libjpeg's default arithmetic (the ISLOW IDCT, fancy upsampling, the
fixed-point YCbCr->RGB tables, the colour-space decision), which is what
PIL decodes with, so its pixels are PIL's bit for bit: uint8 [H, W] for one
component, [H, W, 3] RGB for three.

Sequential (SOF0, SOF1) and progressive (SOF2) Huffman files with 8-bit
samples, 1 or 3 components, sampling factors up to 2x2, restart intervals
and partial MCUs decode. Arithmetic coding, lossless and hierarchical
frames, 12-bit samples, CMYK/YCCK, sampling factors above 2 and
progressive files libjpeg would block-smooth raise NotImplementedError
naming what was found; corrupt or truncated data raises ValueError. There
is no pure-Python fallback: where g++ is missing or fails, the first call
raises RuntimeError with the compiler's output. ctypes releases the GIL
during a decode, so a loader's threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from d3roma_tpu_torch.utils import native_io

__all__ = ["SOURCE", "decode_jpeg", "read_jpeg", "is_jpeg"]

SOURCE = native_io.PACKAGE_DIR / "csrc" / "jpeg_decode.cpp"
_MSG_LEN = 512


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(native_io.build(SOURCE, libs=())))
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                ctypes.c_size_t, c_int_p, c_int_p, c_int_p,
                                ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_decode.restype = ctypes.c_int
    return lib


def is_jpeg(head: bytes) -> bool:
    """Whether a file's first bytes are a JPEG's SOI marker."""
    return head[:3] == b"\xff\xd8\xff"


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A JPEG file's bytes -> uint8 [H, W] or [H, W, 3]."""
    lib = _lib()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(_MSG_LEN)

    def call(out, cap):
        return lib.jpeg_decode(data, len(data), out, cap, ctypes.byref(h), ctypes.byref(w),
                               ctypes.byref(c), msg, _MSG_LEN)

    rc = call(None, 0)
    if rc == 1:
        img = np.empty((h.value, w.value, c.value), np.uint8)
        rc = call(img.ctypes.data, img.nbytes)
    text = msg.value.decode(errors="replace")
    if rc == -2:
        raise NotImplementedError(f"{name}: {text}")
    if rc != 0:
        raise ValueError(f"{name}: corrupt JPEG: {text}")
    return img[..., 0] if c.value == 1 else img


def read_jpeg(path) -> np.ndarray:
    """`np.array(PIL.Image.open(path))` for a JPEG file."""
    data = Path(path).read_bytes()
    return decode_jpeg(data, str(path))
