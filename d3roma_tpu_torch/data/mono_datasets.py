"""Monocular RGB-D datasets (pseudo-disparity from depth).

Port of `d3roma_tpu/data/mono_datasets.py`: RGB + depth (+mask) items,
RandomResizedCrop/hflip augmentation, the pseudo-baseline fxb = 24 so that
raw_disp = fxb / depth, percentile depth normalization on the device, and
the eleven sets with their globs, roots, split quirks and unit conversions
(NYUv2, HyperSim, ScanNet, ScanNetpp, SceneNet, VK2, KITTI, InStereo2K,
Tartenair, HRWSI, SynTODD). The machine with the card has neither OpenCV,
PIL nor h5py, so the library calls map to the port's own readers:

- `cv2.resize` -> `utils/resize.py` (INTER_LINEAR on uint8 OpenCV's fixed
  point, INTER_NEAREST its float64 floor index: bit-equal);
- RGB frames -> `utils/frame_utils.read_gen`, whose JPEGs go through the
  host decoder `utils/jpeg.py` (PIL's pixels);
- `cv2.imread(path, -1)` -> the port's PNG reader with OpenCV's channel
  order (an 8- or 16-bit colour PNG comes back BGR, with alpha BGRA);
- `h5py` -> `utils/hdf5.py`.

One deliberate difference: the skip-and-retry loop of `__getitem__`
retries I/O and format errors as the JAX package does, but lets a
`NotImplementedError` (a file outside what the port's decoders read) and a
failed build of the decoder through. Where PIL would have decoded such a
file, a skip would silently train on other frames than the JAX package.
"""

from __future__ import annotations

import glob
import os.path as osp
from typing import List

import numpy as np

from d3roma_tpu_torch.data.datasets import BaseDataset, _to_rgb3
from d3roma_tpu_torch.utils import frame_utils, hdf5
from d3roma_tpu_torch.utils.native_io import BuildError
from d3roma_tpu_torch.utils.resize import INTER_LINEAR, INTER_NEAREST, resize

PSEUDO_FXB = 24.0  # reference: data/mono_datasets.py:73

# errors that a retry on the next frame must not hide
_NOT_RETRIED = (NotImplementedError, BuildError)


class MonoDataset(BaseDataset):
    """Base: rgb + depth (+valid) -> raw item dict with pseudo disparity."""

    def __init__(self, image_size, split="train", seed=None,
                 resizedcrop_scale=(0.6, 1.0), resizedcrop_ratio=(1.0, 4 / 3)):
        self.image_size = tuple(image_size)
        self.split = split
        self._base_seed = 0 if seed is None else int(seed)
        self.rgb_list: List[str] = []
        self.depth_list: List[str] = []
        self.mask_list: List[str] = []
        self.scale = resizedcrop_scale
        self.ratio = resizedcrop_ratio

    def __len__(self):
        return len(self.rgb_list)

    # per-dataset raw loading; override as needed
    def _load(self, index):
        rgb = _to_rgb3(np.array(frame_utils.read_gen(self.rgb_list[index])).astype(np.uint8))
        depth = np.asarray(frame_utils.read_gen(self.depth_list[index]), np.float32)
        if depth.ndim == 3:
            depth = depth[..., 0]
        mask = None
        if self.mask_list:
            mask = np.asarray(frame_utils.read_gen(self.mask_list[index])) > 0
        return rgb, depth, mask

    def _resized_crop(self, rgb, depth, mask, rng):
        """torchvision RandomResizedCrop semantics
        (reference: data/dataset.py:24-69)."""
        H, W = rgb.shape[:2]
        th, tw = self.image_size
        area = H * W
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            ar = np.exp(rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            w = int(round(np.sqrt(target_area * ar)))
            h = int(round(np.sqrt(target_area / ar)))
            if 0 < w <= W and 0 < h <= H:
                y0 = int(rng.integers(0, H - h + 1))
                x0 = int(rng.integers(0, W - w + 1))
                break
        else:
            w, h = min(W, int(H * self.ratio[0])), H
            y0, x0 = 0, (W - w) // 2
        rgb = resize(rgb[y0:y0 + h, x0:x0 + w], (tw, th), interpolation=INTER_LINEAR)
        depth = resize(depth[y0:y0 + h, x0:x0 + w], (tw, th), interpolation=INTER_NEAREST)
        if mask is not None:
            mask = resize(mask[y0:y0 + h, x0:x0 + w].astype(np.uint8), (tw, th),
                          interpolation=INTER_NEAREST) > 0
        return rgb, depth, mask

    def _center_fit(self, rgb, depth, mask):
        th, tw = self.image_size
        rgb = resize(rgb, (tw, th), interpolation=INTER_LINEAR)
        depth = resize(depth, (tw, th), interpolation=INTER_NEAREST)
        if mask is not None:
            mask = resize(mask.astype(np.uint8), (tw, th), interpolation=INTER_NEAREST) > 0
        return rgb, depth, mask

    def __getitem__(self, index):
        raw_index = index  # distinct per oversampled copy (RepeatedDataset)
        index = index % len(self)
        # bad-sample skip-and-retry (reference: mono_datasets.py:48-51)
        for attempt in range(4):
            try:
                rgb, depth, mask = self._load((index + attempt) % len(self))
                break
            except _NOT_RETRIED:
                raise
            except Exception:
                continue
        else:
            raise RuntimeError(f"failed to load sample near index {index}")

        if rgb.shape[:2] != depth.shape[:2]:
            # rgb follows the depth grid, as the reference's loaders do
            # (e.g. ScanNet resizes color to the depth size): crop/flip
            # coordinates below are shared between the two
            rgb = resize(rgb, (depth.shape[1], depth.shape[0]), interpolation=INTER_LINEAR)

        if mask is None:
            mask = (depth > 0) & np.isfinite(depth)
        else:
            mask = mask & (depth > 0) & np.isfinite(depth)
        depth = np.nan_to_num(depth, nan=0.0, posinf=0.0, neginf=0.0)

        if self.split == "train":
            rng = self._sample_rng(raw_index)
            if rng.random() < 0.5:
                rgb, depth, mask = rgb[:, ::-1], depth[:, ::-1], mask[:, ::-1]
            rgb, depth, mask = self._resized_crop(rgb, depth, mask, rng)
        else:
            rgb, depth, mask = self._center_fit(rgb, depth, mask)

        disp = np.where(mask, PSEUDO_FXB / np.maximum(depth, 1e-6), 0.0)
        zeros = np.zeros_like(rgb, np.float32)
        return {
            "disp": disp[..., None].astype(np.float32),
            "valid": mask[..., None].astype(np.float32),
            "depth": depth[..., None].astype(np.float32),
            "raw_depth": depth[..., None].astype(np.float32),
            "rgb": rgb.astype(np.float32),
            "left": zeros,
            "right": zeros,
            "fxb": np.float32(PSEUDO_FXB),
            "K": np.eye(3, dtype=np.float32),
            "index": np.int32(index),
            "path": self.rgb_list[index],
            "device": "mono",
        }


class NYUv2(MonoDataset):
    """Official h5 splits with the eigen crop
    (reference: data/mono_datasets.py:351-405)."""

    EIGEN_CROP = (45, 471, 41, 601)

    def __init__(self, image_size, split="train", root="datasets/nyu_depth_v2", seed=None):
        super().__init__(image_size, split, seed)
        sub = "official_splits/train" if split == "train" else "official_splits/test"
        self.h5_list = sorted(glob.glob(osp.join(root, sub, "**/*.h5"), recursive=True))
        self.rgb_list = self.h5_list  # len() proxy

    def _load(self, index):
        with hdf5.File(self.h5_list[index]) as f:
            rgb = np.transpose(np.asarray(f["rgb"]), (1, 2, 0)).astype(np.uint8)
            depth = np.asarray(f["depth"]).astype(np.float32)
        t, b, l, r = self.EIGEN_CROP
        # valid depths clipped to the NYU working range (reference:
        # data/mono_datasets.py:393 clips to [1e-3, 10] metres)
        depth = np.where(depth > 0, np.clip(depth, 1e-3, 10.0), 0.0).astype(np.float32)
        return rgb[t:b, l:r], depth[t:b, l:r], None


class HyperSim(MonoDataset):
    """Distance -> planar depth conversion (reference:
    data/mono_datasets.py:196-248)."""

    def __init__(self, image_size, split="train", root="datasets/hypersim", seed=None):
        super().__init__(image_size, split, seed)
        self.rgb_list = sorted(glob.glob(osp.join(root, split, "**/*.tonemap.jpg"), recursive=True))
        self.depth_list = [p.replace(".tonemap.jpg", ".depth_meters.hdf5") for p in self.rgb_list]

    def _load(self, index):
        rgb = _to_rgb3(np.array(frame_utils.read_gen(self.rgb_list[index])).astype(np.uint8))
        with hdf5.File(self.depth_list[index]) as f:
            dist = np.asarray(f["dataset"]).astype(np.float32)
        # optical-center distance -> planar depth
        H, W = dist.shape
        focal = 886.81  # HyperSim intrinsics
        xs = np.linspace(-0.5 * W + 0.5, 0.5 * W - 0.5, W)
        ys = np.linspace(-0.5 * H + 0.5, 0.5 * H - 0.5, H)
        xg, yg = np.meshgrid(xs, ys)
        planar = dist / np.sqrt(xg**2 + yg**2 + focal**2) * focal
        return rgb, planar.astype(np.float32), None


def _read_rgb(path) -> np.ndarray:
    return _to_rgb3(np.array(frame_utils.read_gen(path)).astype(np.uint8))


def _imread_raw(path) -> np.ndarray:
    """16-bit/float raw read, as `cv2.imread(path, IMREAD_UNCHANGED)` gives
    it (colour in BGR, with alpha BGRA), as float32."""
    img = frame_utils.read_image(path)
    if img.ndim == 3 and img.shape[2] in (3, 4):
        img = img[..., [2, 1, 0, 3][: img.shape[2]]]
    return np.asarray(img, np.float32)


class _ListedMono(MonoDataset):
    """Shared glob-listing constructor; subclasses own the depth semantics."""

    RGB_GLOB = "*.png"
    ROOT = "datasets"

    def __init__(self, image_size, split="train", root=None, seed=None):
        super().__init__(image_size, split, seed)
        root = root or self.ROOT
        self.rgb_list = sorted(
            glob.glob(osp.join(root, split, self.RGB_GLOB), recursive=True)
        )
        self.depth_list = [self._depth_path(p) for p in self.rgb_list]

    def _depth_path(self, rgb_path: str) -> str:
        raise NotImplementedError


class ScanNet(_ListedMono):
    """mm-unit 16-bit depth PNGs: depth/1000 -> metres
    (reference: data/mono_datasets.py:189-193)."""

    RGB_GLOB = "**/color/*.jpg"
    ROOT = "datasets/ScanNet"

    def _depth_path(self, p):
        return p.replace("/color/", "/depth/").replace(".jpg", ".png")

    def _load(self, index):
        depth = _imread_raw(self.depth_list[index]) / 1000.0
        return _read_rgb(self.rgb_list[index]), depth, None


class ScanNetpp(_ListedMono):
    """192x256 depth upsampled 4x nearest, /500
    (reference: data/mono_datasets.py:438-449)."""

    RGB_GLOB = "**/rgb/*.jpg"
    ROOT = "datasets/ScanNetpp"

    def _depth_path(self, p):
        return p.replace("/rgb/", "/depth/").replace(".jpg", ".png")

    def _load(self, index):
        depth = _imread_raw(self.depth_list[index])
        depth = resize(depth, dsize=(4 * depth.shape[1], 4 * depth.shape[0]),
                       interpolation=INTER_NEAREST)
        return _read_rgb(self.rgb_list[index]), depth / 500.0, None


class SceneNet(_ListedMono):
    """240x320 mm depth upsampled 2x nearest, /1000 -> metres
    (reference: data/mono_datasets.py:343-348)."""

    RGB_GLOB = "**/photo/*.jpg"
    ROOT = "datasets/SceneNet"

    def _depth_path(self, p):
        return p.replace("/photo/", "/depth/").replace(".jpg", ".png")

    def _load(self, index):
        depth = _imread_raw(self.depth_list[index])
        depth = resize(depth, dsize=(2 * depth.shape[1], 2 * depth.shape[0]),
                       interpolation=INTER_NEAREST)
        return _read_rgb(self.rgb_list[index]), depth / 1000.0, None


class VK2(_ListedMono):
    """Virtual KITTI 2 cm-unit depth PNGs, /500 as in the reference's chosen
    scaling ("make it to around 0~10", data/mono_datasets.py:316-326)."""

    RGB_GLOB = "**/rgb/*.jpg"
    ROOT = "datasets/VK2"

    def _depth_path(self, p):
        return (p.replace("/rgb/", "/depth/")
                 .replace("rgb_", "depth_").replace(".jpg", ".png"))

    def _load(self, index):
        depth = _imread_raw(self.depth_list[index]) / 500.0
        return _read_rgb(self.rgb_list[index]), depth, None


class KITTI(_ListedMono):
    """KITTI sparse LiDAR GT: 16-bit PNG /256 -> metres, 0 = missing
    (reference convention: utils_d3roma/frame_utils.py:129-132)."""

    RGB_GLOB = "**/image_02/data/*.png"
    ROOT = "datasets/KITTI"

    def _depth_path(self, p):
        return p.replace("/image_02/data/", "/proj_depth/groundtruth/image_02/")

    def _load(self, index):
        depth = _imread_raw(self.depth_list[index]) / 256.0
        return _read_rgb(self.rgb_list[index]), depth, depth > 0


class InStereo2K(_ListedMono):
    """Stores *disparity* PNGs: depth = 10000/disp (metres, ~0-5 range); RGB
    is resized to the depth resolution (reference:
    data/mono_datasets.py:466-477)."""

    RGB_GLOB = "**/left.png"
    ROOT = "datasets/InStereo2K"

    def _depth_path(self, p):
        return p.replace("left.png", "left_disp.png")

    def _load(self, index):
        disp = np.asarray(_imread_raw(self.depth_list[index]), np.float64)
        with np.errstate(divide="ignore"):
            depth = np.where(disp > 0, 10000.0 / np.maximum(disp, 1e-9), 0.0)
        rgb = _read_rgb(self.rgb_list[index])
        rgb = resize(rgb, dsize=(depth.shape[1], depth.shape[0]), interpolation=INTER_NEAREST)
        return rgb, depth.astype(np.float32), depth > 0


class Tartenair(_ListedMono):
    """Depth stored as float32 .npy in metres (reference:
    data/mono_datasets.py:132-133)."""

    RGB_GLOB = "**/image_left/*.png"
    ROOT = "datasets/Tartenair"

    def _depth_path(self, p):
        return (p.replace("/image_left/", "/depth_left/")
                 .replace(".png", "_depth.npy"))

    def _load(self, index):
        depth = np.asarray(np.load(self.depth_list[index], allow_pickle=True),
                           np.float32)
        return _read_rgb(self.rgb_list[index]), depth, None


class HRWSI(_ListedMono):
    """Relative-disparity PNGs: depth = 10/disp (reference:
    data/mono_datasets.py:157-159; its split quirk always lists train)."""

    RGB_GLOB = "imgs/*.jpg"
    ROOT = "datasets/HRWSI"

    def __init__(self, image_size, split="train", root=None, seed=None):
        # the reference forces split='train' for HRWSI (mono_datasets.py:143-145)
        super().__init__(image_size, "train", root, seed)
        self.split = split  # aug still follows the requested split

    def _depth_path(self, p):
        return p.replace("/imgs/", "/gts/").replace(".jpg", ".png")

    def _load(self, index):
        disp = np.asarray(_imread_raw(self.depth_list[index]), np.float64)
        with np.errstate(divide="ignore"):
            depth = np.where(disp > 0, 10.0 / np.maximum(disp, 1e-9), 0.0)
        return _read_rgb(self.rgb_list[index]), depth.astype(np.float32), depth > 0


class SynTODD(_ListedMono):
    """IR-left frames with metric EXR depth and the published camera
    intrinsics (reference: data/mono_datasets.py:250-298)."""

    CAMERA_K = np.array(
        [[613.9624633789062, 0.0, 324.4471435546875],
         [0.0, 613.75634765625, 239.1712188720703],
         [0.0, 0.0, 1.0]], dtype=np.float32)

    def __init__(self, image_size, split="train", root="datasets/SynTODD", seed=None):
        MonoDataset.__init__(self, image_size, split, seed)
        self.rgb_list = sorted(
            glob.glob(osp.join(root, f"{split}_png", "*_ir_l.png"))
        )
        if split == "val":
            self.rgb_list = self.rgb_list[:1001]  # reference val cap (:288)
        self.depth_list = [p.replace("_ir_l.png", "_depth.exr") for p in self.rgb_list]

    def _load(self, index):
        rgb = _read_rgb(self.rgb_list[index])
        depth = np.asarray(frame_utils.read_gen(self.depth_list[index]), np.float32)
        if depth.ndim == 3:
            depth = depth[..., 0]
        return rgb, depth, None

    def __getitem__(self, index):
        ret = super().__getitem__(index)
        ret["K"] = self.CAMERA_K
        ret["device"] = "syntodd"
        return ret
