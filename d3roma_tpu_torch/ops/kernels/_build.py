"""Build the CUDA sources under `d3roma_tpu_torch/csrc/` and load them.

Each `csrc/<name>.cu` is compiled by nvcc, for `sm_90a`, into a shared
library with a plain C interface, which ctypes loads. A library is built at
first use into `d3roma_tpu_torch/_build/` (listed in .gitignore), under a
name that hashes the sources and the flags, so an edited source is never
served by a stale build. `build()` compiles several sources at once, one
nvcc process each, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    """Where the build of `csrc/<name>.cu` lives: keyed by the source, the
    shared headers and the flags."""
    h = hashlib.sha256()
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every source in `names` that has no current build, one nvcc
    process per source, all started together. Returns the wall seconds each
    build took (0.0 for one that was current). nvcc's output, with ptxas's
    register and shared-memory report, goes to `_build/<name>.log`."""
    BUILD_DIR.mkdir(exist_ok=True)
    seconds: Dict[str, float] = {}
    running = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running[name] = (proc, tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in running.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


@functools.lru_cache(maxsize=8)
def sm_count(device_index: int) -> int:
    """The SM count of a CUDA device (the plans size their grids by it)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def current_stream(device) -> int:
    """The raw handle of PyTorch's current CUDA stream on `device` (the
    binding PyTorch's compiled kernels use: no Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error (its cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")
