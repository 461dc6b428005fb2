"""ctypes bindings for the native IO runtime (`csrc/d3roma_io.cpp`).

Port of `d3roma_tpu/utils/native_io.py`: threaded EXR decode for the data
loader's hot path. The C++ source is host code, compiled by g++ (not nvcc)
at first use into `d3roma_tpu_torch/_build/` under a name that hashes the
source and the flags, as the kernels' libraries are. Where no compiler
builds it, `available()` is False and `utils/frame_utils.py` reads EXRs
with the pure-Python reader (`utils/exr.py`); `build()` raises instead, for
callers that require the native path. The port writes its own EXRs
through `utils/exr.py`; `write_exr` mirrors the JAX package's API.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR / "_build"  # shared with the kernels' builds
SOURCE = PACKAGE_DIR / "csrc" / "d3roma_io.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-lz", "-lpthread")


class BuildError(RuntimeError):
    """g++ is missing, or failed on a host source; the message has its output."""


def library_path(source: Path = SOURCE, libs: Tuple[str, ...] = LIBS) -> Path:
    """Where the build of `source` lives: keyed by the source and flags."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(CXX_FLAGS + tuple(libs)).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, libs: Tuple[str, ...] = LIBS) -> Path:
    """Compile a host C++ source into a shared library unless a current build
    exists; returns its path. Raises BuildError with the compiler's output
    when g++ is missing or fails. The IO library by default; the JPEG
    decoder (`utils/jpeg.py`) builds `csrc/jpeg_decode.cpp` through it."""
    target = library_path(source, libs)
    if target.exists():
        return target
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(source), "-o", str(tmp), *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise BuildError(f"building {source.name} failed: {e!r}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"building {source.name} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: concurrent builds each publish a whole file
    return target


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError):
        return None
    lib.exr_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.exr_header.restype = ctypes.c_int
    lib.exr_read.argtypes = [ctypes.c_char_p,
                             np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                             ctypes.c_int]
    lib.exr_read.restype = ctypes.c_int
    lib.exr_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int,
    ]
    lib.exr_read_batch.restype = None
    lib.exr_write.argtypes = [ctypes.c_char_p,
                              np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                              ctypes.c_int, ctypes.c_int]
    lib.exr_write.restype = ctypes.c_int
    lib.exr_channel_names.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.exr_channel_names.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO unavailable")
    return lib


def _rgb_reorder(img: np.ndarray, path: str) -> np.ndarray:
    """Match the pure-Python decoder's channel convention (utils/exr.py):
    storage is alphabetical (B,G,R); return RGB-ordered when R/G/B are
    all present."""
    buf = ctypes.create_string_buffer(4096)
    if _lib().exr_channel_names(path.encode(), buf, len(buf)) != 0:
        return img
    names = buf.value.decode().split(";")
    if set(names) >= {"R", "G", "B"}:
        idx = [names.index("R"), names.index("G"), names.index("B")]
        idx += [i for i in range(img.shape[-1]) if i not in idx]
        return img[..., idx]
    return img


def available() -> bool:
    return _load() is not None


def _header(path: str) -> Tuple[int, int, int]:
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if _lib().exr_header(path.encode(), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c)) != 0:
        raise ValueError(f"bad EXR header: {path}")
    return h.value, w.value, c.value


def read_exr(path: str) -> np.ndarray:
    """Native EXR read; raises on failure (callers fall back to Python)."""
    h, w, c = _header(path)
    total = h * w * c
    if not 0 < total < 2**31:  # c_int capacity + sane allocation bound
        raise ValueError(f"unreasonable EXR size {total}: {path}")
    out = np.empty(total, np.float32)
    n = _lib().exr_read(path.encode(), out, out.size)
    if n < 0:
        raise NotImplementedError(f"native EXR decode failed ({n}): {path}")
    img = out.reshape(h, w, c)
    return img[..., 0] if c == 1 else _rgb_reorder(img, path)


def read_exr_batch(paths: List[str], num_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Parallel decode of same-shaped EXR files -> ([N,H,W(,C)], status [N])."""
    lib = _lib()
    if not paths:
        return np.empty((0,), np.float32), np.empty((0,), np.int32)
    h, w, c = _header(paths[0])
    per = h * w * c
    if not 0 < per < 2**31:  # c_int capacity
        raise ValueError(f"unreasonable EXR size {per}: {paths[0]}")
    n = len(paths)
    out = np.empty(n * per, np.float32)
    status = np.empty(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.exr_read_batch(arr, n, out, per, status, num_threads)
    res = out.reshape((n, h, w) if c == 1 else (n, h, w, c))
    if c > 1:
        res = _rgb_reorder(res, paths[0])  # same-shaped files share names
    return res, status


def write_exr(path: str, image: np.ndarray) -> None:
    """Single-channel float32 EXR, NO_COMPRESSION (the JAX package's API)."""
    img = np.ascontiguousarray(np.asarray(image, np.float32))
    if img.ndim != 2:
        raise ValueError(f"the native writer is single-channel, got shape {img.shape}")
    if _lib().exr_write(path.encode(), img, img.shape[0], img.shape[1]) != 0:
        raise IOError(f"native EXR write failed: {path}")
