"""The port's mono datasets (`data/mono_datasets.py`) against the JAX
package's, item for item.

A module fixture writes tiny trees for all eleven sets at their default
roots (under one temporary directory, the working directory of the tests)
with the libraries the JAX package reads them with: JPEGs by cv2.imwrite
(as the JAX package's own tests write them), 16-bit and 8-bit PNGs by cv2,
HDF5 by h5py (NYUv2 at its published 480x640, since the eigen crop is
fixed), EXR by the JAX package's writer, `.npy` by numpy. Frames and depth
maps differ in size where the sets do (ScanNet's colour is resized to the
depth grid, ScanNetpp and SceneNet upsample their depth 4x and 2x,
InStereo2K resizes its colour to the disparity's size), and depth maps
hold zeros (invalid pixels).

Every item of the `train` split (the same seed, so the same flip and
RandomResizedCrop; an oversampled index too) and of the `val` / `test`
split must equal the JAX package's: every key, each array's dtype, shape
and values bit for bit (tolerance 0), the path and device strings.
FallingThings items with JPEG frames equal the JAX `datasets.FallingThings`
ones. `create_dataset` builds every mono name. A JPEG the port's decoder
does not read (4:1:1 chroma) raises instead of being skipped, while a
truncated one is skipped as the JAX package skips it.
"""

import json
import os

import cv2
import h5py
import numpy as np
import pytest

from d3roma_tpu.config import load_task_preset as jax_preset
from d3roma_tpu.data import datasets as JD
from d3roma_tpu.data import loader as JL
from d3roma_tpu.data import mono_datasets as JM
from d3roma_tpu.utils.exr import write_exr
from d3roma_tpu_torch.config import load_task_preset
from d3roma_tpu_torch.data import datasets as D
from d3roma_tpu_torch.data import loader as L
from d3roma_tpu_torch.data import mono_datasets as M

SIZE = (16, 24)  # image_size (h, w)
N = 3  # frames a split


def _rgb(rng, hw):
    y, x = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(x / 5 + k) * np.cos(y / 7 - k) for k in range(3)], -1)
    return np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.uint8)


def _u16(rng, hw, lo, hi, holes=0.1):
    d = rng.integers(lo, hi, hw).astype(np.uint16)
    d[rng.random(hw) < holes] = 0
    return d


def _write(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    assert cv2.imwrite(path, img)


def _nyu(root, rng):
    for split in ("train", "test"):
        for i in range(N):
            path = f"{root}/nyu_depth_v2/official_splits/{split}/room_{i % 2}/{i:05d}.h5"
            os.makedirs(os.path.dirname(path), exist_ok=True)
            depth = rng.uniform(0.3, 12.0, (480, 640)).astype(np.float32)
            depth[rng.random(depth.shape) < 0.05] = 0
            with h5py.File(path, "w") as f:
                f.create_dataset("rgb", data=_rgb(rng, (480, 640)).transpose(2, 0, 1),
                                 chunks=(3, 120, 160), compression="gzip")
                f.create_dataset("depth", data=depth, chunks=(120, 160), compression="gzip")


def _hypersim(root, rng):
    for split in ("train", "val"):
        for i in range(N):
            stem = f"{root}/hypersim/{split}/ai_00{i}/images/frame.{i:04d}"
            _write(stem + ".tonemap.jpg", _rgb(rng, (24, 32)))
            with h5py.File(stem + ".depth_meters.hdf5", "w") as f:
                f["dataset"] = rng.uniform(0.5, 9.0, (24, 32)).astype(np.float16)


def _listed(root, rng, cls, rel, rgb_hw, depth_hw, write_depth):
    """Frames at `rel` (formatted with the frame's index) under the class's
    root and split, matching its glob; depth at its `_depth_path`."""
    base = f"{root}/{os.path.relpath(cls.ROOT, 'datasets')}"
    for split in ("train",) if cls is JM.HRWSI else ("train", "val"):
        for i in range(N):
            rgb_path = f"{base}/{split}/{rel.format(i)}"
            _write(rgb_path, _rgb(rng, rgb_hw))
            depth_path = cls._depth_path(None, rgb_path)
            os.makedirs(os.path.dirname(depth_path), exist_ok=True)
            write_depth(depth_path, rng, depth_hw)


def _png16(lo, hi):
    return lambda path, rng, hw: _write(path, _u16(rng, hw, lo, hi))


def _npy(path, rng, hw):
    np.save(path, rng.uniform(0.5, 30.0, hw).astype(np.float32))


def _gray8(path, rng, hw):
    _write(path, _u16(rng, hw, 1, 255, holes=0.2).astype(np.uint8))


def _syntodd(root, rng):
    for split in ("train", "val"):
        for i in range(N):
            stem = f"{root}/SynTODD/{split}_png/{i:06d}"
            _write(stem + "_ir_l.png", _rgb(rng, (24, 32))[..., 0])
            write_exr(stem + "_depth.exr", rng.uniform(0.2, 2.5, (24, 32)).astype(np.float32))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Tiny trees of every mono set at its default root under datasets/."""
    top = tmp_path_factory.mktemp("mono")
    root = str(top / "datasets")
    rng = np.random.default_rng(0)
    _nyu(root, rng)
    _hypersim(root, rng)
    _listed(root, rng, JM.ScanNet, "s{}/color/0.jpg", (30, 40), (24, 36), _png16(300, 9000))
    _listed(root, rng, JM.ScanNetpp, "s/rgb/{:04d}.jpg", (96, 144), (24, 36),
            _png16(200, 4000))
    _listed(root, rng, JM.SceneNet, "s/photo/{}.jpg", (48, 72), (24, 36), _png16(300, 9000))
    _listed(root, rng, JM.VK2, "s/rgb/rgb_{:05d}.jpg", (24, 36), (24, 36), _png16(100, 6000))
    _listed(root, rng, JM.KITTI, "drive/image_02/data/{:010d}.png", (24, 36), (24, 36),
            _png16(256, 20000))
    _listed(root, rng, JM.InStereo2K, "pair{}/left.png", (48, 72), (24, 36),
            _png16(500, 40000))
    _listed(root, rng, JM.Tartenair, "P00{0}/image_left/{0:06d}_left.png", (24, 36), (24, 36),
            _npy)
    _listed(root, rng, JM.HRWSI, "imgs/{}.jpg", (24, 36), (24, 36), _gray8)
    _syntodd(root, rng)
    return top


def assert_items_equal(ours, ref):
    assert ours.keys() == ref.keys()
    for k in ref:
        a, b = ours[k], ref[k]
        if isinstance(b, str):
            assert a == b, k
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


SPLITS = {"NYUv2": "test", "HRWSI": "val"}


@pytest.mark.parametrize("split", ["train", "eval"])
@pytest.mark.parametrize("name", L.MONO_DATASETS)
def test_items_equal_jax(datasets, monkeypatch, name, split):
    monkeypatch.chdir(datasets)
    split = "train" if split == "train" else SPLITS.get(name, "val")
    ours = getattr(M, name)(SIZE, split=split, seed=5)
    ref = getattr(JM, name)(SIZE, split=split, seed=5)
    assert len(ours) == len(ref) == N
    for index in (0, 1, 2, N + 1):  # an oversampled copy draws its own crop
        assert_items_equal(ours[index], ref[index])


def test_create_dataset_builds_every_mono_name(datasets, monkeypatch):
    """The mono branch of `create_dataset` (`KITTI` is the mono reader,
    `KITTIStereo` the stereo one): the JAX registry's classes and items."""
    monkeypatch.chdir(datasets)
    cfg, jcfg = load_task_preset("train_ldm_mono"), jax_preset("train_ldm_mono")
    for c in (cfg, jcfg):
        c.image_size = list(SIZE)
    for name in L.MONO_DATASETS:
        ours, ref = L.create_dataset(cfg, name, "train"), JL.create_dataset(jcfg, name, "train")
        assert type(ours) is getattr(M, name) and type(ref).__name__ == name
        assert len(ours) == len(ref) == N
        assert_items_equal(ours[1], ref[1])
    with pytest.raises(ValueError, match="unknown dataset"):
        L.create_dataset(cfg, "NYUv3", "train")


def test_fallingthings_jpeg_frames_equal_jax(tmp_path):
    """FallingThings' left/right JPEGs and 0.1 mm depth PNGs (ROADMAP item
    5's remainder): the port's items equal the JAX package's."""
    rng = np.random.default_rng(3)
    root = tmp_path / "FallingThings"
    names = []
    for i in range(2):
        scene = root / "fat" / "mixed" / f"kitchen_{i}"
        os.makedirs(scene)
        for side in ("left", "right"):
            _write(str(scene / f"000000.{side}.jpg"), _rgb(rng, (27, 48)))
        _write(str(scene / "000000.left.depth.png"), _u16(rng, (27, 48), 4000, 30000))
        with open(scene / "_camera_settings.json", "w") as f:
            json.dump({"camera_settings": [{"intrinsic_settings": {"fx": 768.2}}]}, f)
        names.append(f"fat/mixed/kitchen_{i}/000000.left.jpg")
    (root / "filenames.txt").write_text("\n".join(names) + "\n")
    ours, ref = D.FallingThings(root=str(root)), JD.FallingThings(root=str(root))
    assert len(ours) == len(ref) == 2
    for i in range(2):
        assert_items_equal(ours[i], ref[i])


def _scannet_tree(root, rng, first):
    """A ScanNet val split of two frames whose first colour JPEG is `first`."""
    for i in range(2):
        path = f"{root}/ScanNet/val/scene/color/{i:04d}.jpg"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if i == 0:
            with open(path, "wb") as f:
                f.write(first)
        else:
            _write(path, _rgb(rng, (24, 36)))
        _write(path.replace("/color/", "/depth/").replace(".jpg", ".png"),
               _u16(rng, (24, 36), 300, 9000))


def test_unsupported_jpeg_raises_and_corrupt_one_is_skipped(tmp_path):
    """The port's one difference from the JAX skip-and-retry loop: a file
    outside what its decoder reads (here 4:1:1 chroma, which PIL decodes)
    raises NotImplementedError instead of being skipped; a truncated JPEG,
    which PIL refuses too, is skipped to the next frame in both (an item
    keeps the path it was asked for; its pixels are the next frame's)."""
    rng = np.random.default_rng(4)
    ok, enc = cv2.imencode(".jpg", _rgb(rng, (24, 36)), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    _scannet_tree(str(tmp_path / "a"), rng, enc.tobytes())
    root = str(tmp_path / "a" / "ScanNet")
    ref = JM.ScanNet(SIZE, split="val", root=root)
    assert not np.array_equal(ref[0]["rgb"], ref[1]["rgb"])  # PIL decoded it: no skip
    with pytest.raises(NotImplementedError, match="sampling factor 4x1"):
        M.ScanNet(SIZE, split="val", root=root)[0]

    ok, enc = cv2.imencode(".jpg", _rgb(rng, (24, 36)))
    _scannet_tree(str(tmp_path / "b"), rng, enc.tobytes()[:-40])
    root = str(tmp_path / "b" / "ScanNet")
    ours, ref = M.ScanNet(SIZE, split="val", root=root), JM.ScanNet(SIZE, split="val", root=root)
    np.testing.assert_array_equal(ours[0]["rgb"], ours[1]["rgb"])  # skipped to frame 1
    for i in range(2):
        assert_items_equal(ours[i], ref[i])


def test_failed_decoder_build_is_not_skipped(tmp_path, monkeypatch):
    """A decoder that does not build raises from the item, not a skip."""
    from d3roma_tpu_torch.utils import jpeg, native_io

    rng = np.random.default_rng(5)
    ok, enc = cv2.imencode(".jpg", _rgb(rng, (24, 36)))
    _scannet_tree(str(tmp_path), rng, enc.tobytes())

    def broken():
        raise native_io.BuildError("building jpeg_decode.cpp failed: no compiler")

    monkeypatch.setattr(jpeg, "_lib", broken)
    with pytest.raises(native_io.BuildError, match="no compiler"):
        M.ScanNet(SIZE, split="val", root=str(tmp_path / "ScanNet"))[0]


@pytest.mark.parametrize("channels", [3, 4])
def test_imread_raw_is_opencv_channel_order(tmp_path, channels):
    """`_imread_raw` is `cv2.imread(path, IMREAD_UNCHANGED)` as float32:
    colour PNGs (8 and 16 bit) in BGR / BGRA order."""
    rng = np.random.default_rng(channels)
    for dtype, hi in ((np.uint8, 255), (np.uint16, 65535)):
        path = str(tmp_path / f"c{channels}_{np.dtype(dtype).itemsize}.png")
        _write(path, rng.integers(0, hi, (5, 7, channels)).astype(dtype))
        ref = cv2.imread(path, -1).astype(np.float32)
        np.testing.assert_array_equal(M._imread_raw(path), ref)
