"""The committed mono fixtures (`tests/data/torch_mono/`) and their manifest.

`write_fixtures(root)` writes them, once, with the libraries the JAX
package reads them with: PIL for the JPEGs, h5py for the HDF5 files, from
seeded numpy scenes (a room of planes at 0.5-8 m with smooth shading, the
depth in steps of 1/64 m, so that they compress): two NYUv2 official-split
files (`rgb` uint8 [3, 480, 640], `depth` float32 [480, 640], chunked and
gzipped), two HyperSim frames at 768x1024 (a baseline 4:2:0 JPEG at quality
90 and the float16 `dataset` of its `.depth_meters.hdf5`, gzipped), and a
handful of small JPEGs (progressive, 4:4:4, gray, restart intervals, and a
480x640 4:2:0 frame). `manifest.json` records, for every file and dataset,
the shape, the dtype and the sha256 of the array PIL or h5py returns.
`python3 chip_smoke.py --mono` decodes them with the port on the card's
machine, which has neither library, and checks each sha256.

Regenerate with `python tests/test_torch_mono_fixtures.py`.
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_mono")
MAX_BYTES = 1_500_000

NYU = ("nyu_depth_v2/official_splits/train/bedroom_0001/00000.h5",
       "nyu_depth_v2/official_splits/test/kitchen_0002/00001.h5")
HYPERSIM = ("hypersim/ai_001_001/frame.0000", "hypersim/ai_001_002/frame.0001")
SMALL_JPEGS = {  # name: (height, width, PIL save arguments, gray)
    "jpeg/progressive_420.jpg": (37, 53, dict(quality=75, progressive=True), False),
    "jpeg/baseline_444.jpg": (48, 64, dict(quality=95, subsampling=0), False),
    "jpeg/gray.jpg": (50, 70, dict(quality=80), True),
    "jpeg/restart_422.jpg": (41, 66, dict(quality=85, subsampling=1,
                                           restart_marker_blocks=3), False),
    "jpeg/baseline_420_480x640.jpg": (480, 640, dict(quality=90, subsampling=2), False),
}


def scene(h: int, w: int, seed: int):
    """A room of planes: uint8 RGB [h, w, 3] with smooth banded shading and
    float32 depth [h, w] in 0.5-8 m, in steps of 1/64 m."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    u, v = (x + 0.5) / w - 0.5, (y + 0.5) / h - 0.5
    back = rng.uniform(5.0, 7.5)
    floor = np.where(v > 0.02, rng.uniform(0.6, 0.9) / np.maximum(v, 1e-3), np.inf)
    left = np.where(u < -0.05, rng.uniform(0.8, 1.2) / np.maximum(-u, 1e-3), np.inf)
    right = np.where(u > 0.05, rng.uniform(0.8, 1.2) / np.maximum(u, 1e-3), np.inf)
    depth = np.minimum.reduce([np.full((h, w), back), floor, left, right])
    depth = np.clip(np.round(depth * 64) / 64, 0.5, 8.0)
    surface = np.select([depth == np.round(back * 64) / 64, np.isfinite(floor) & (floor <= depth),
                         np.isfinite(left) & (left <= depth)], [0, 1, 2], 3)
    base = rng.uniform(60, 200, (4, 3))
    shade = np.floor(24 * (1.0 - depth / 8.0)) * 2.0
    rgb = np.clip(base[surface] + shade[..., None], 0, 255).astype(np.uint8)
    return rgb, depth.astype(np.float32)


def write_fixtures(root: str = ROOT) -> dict:
    """Write every fixture under `root` and its manifest; returns the manifest."""
    import h5py
    from PIL import Image

    for i, rel in enumerate(NYU):
        rgb, depth = scene(480, 640, 100 + i)
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with h5py.File(path, "w") as f:
            f.create_dataset("rgb", data=np.ascontiguousarray(rgb.transpose(2, 0, 1)),
                             chunks=(3, 120, 160), compression="gzip", compression_opts=9)
            f.create_dataset("depth", data=depth, chunks=(120, 160), compression="gzip",
                             compression_opts=9, shuffle=True)
    for i, rel in enumerate(HYPERSIM):
        rgb, depth = scene(768, 1024, 200 + i)
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(rgb).save(path + ".tonemap.jpg", quality=90, subsampling=2)
        with h5py.File(path + ".depth_meters.hdf5", "w") as f:
            f.create_dataset("dataset", data=depth.astype(np.float16), chunks=(128, 256),
                             compression="gzip", compression_opts=9, shuffle=True)
    for i, (rel, (h, w, kw, gray)) in enumerate(sorted(SMALL_JPEGS.items())):
        rgb, _ = scene(h, w, 300 + i)
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(rgb[..., 1] if gray else rgb).save(path, "JPEG", **kw)
    manifest = reference_manifest(root)
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


def _entry(arr: np.ndarray) -> dict:
    return dict(shape=list(arr.shape), dtype=arr.dtype.str,
                sha256=hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest())


def _files(root: str):
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            if name != "manifest.json":
                yield os.path.relpath(os.path.join(dirpath, name), root)


def reference_manifest(root: str) -> dict:
    """{file: {dataset or "": entry}} as PIL and h5py read the files."""
    import h5py
    from PIL import Image

    out = {}
    for rel in sorted(_files(root)):
        path = os.path.join(root, rel)
        if rel.endswith(".jpg"):
            out[rel] = {"": _entry(np.array(Image.open(path)))}
        else:
            with h5py.File(path, "r") as f:
                out[rel] = {k: _entry(np.asarray(f[k])) for k in sorted(f.keys())}
    return out


def port_manifest(root: str) -> dict:
    """The same through the port's readers."""
    from d3roma_tpu_torch.utils import hdf5
    from d3roma_tpu_torch.utils.jpeg import read_jpeg

    out = {}
    for rel in sorted(_files(root)):
        path = os.path.join(root, rel)
        if rel.endswith(".jpg"):
            out[rel] = {"": _entry(read_jpeg(path))}
        else:
            f = hdf5.File(path)
            out[rel] = {k: _entry(f[k]) for k in sorted(f.keys())}
    return out


def _committed() -> dict:
    with open(os.path.join(ROOT, "manifest.json")) as f:
        return json.load(f)


def test_manifest_matches_pil_and_h5py():
    assert reference_manifest(ROOT) == _committed()


def test_port_readers_match_manifest():
    assert port_manifest(ROOT) == _committed()


def test_writer_reproduces_the_committed_arrays(tmp_path):
    """The writer's scenes are what the committed files hold (the files'
    bytes may differ with the libraries' versions, their arrays not)."""
    assert write_fixtures(str(tmp_path)) == _committed()


def test_fixtures_stay_small():
    total = sum(os.path.getsize(os.path.join(ROOT, rel)) for rel in _files(ROOT))
    assert 0 < total < MAX_BYTES, total
    assert len(_committed()) == len(NYU) + 2 * len(HYPERSIM) + len(SMALL_JPEGS)


if __name__ == "__main__":
    manifest = write_fixtures(ROOT)
    total = sum(os.path.getsize(os.path.join(ROOT, rel)) for rel in _files(ROOT))
    print(f"{len(manifest)} files, {total} bytes under {ROOT}", file=sys.stderr)
