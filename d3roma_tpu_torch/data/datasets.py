"""RGB-D / active-IR dataset classes (host-side file IO + shape-defining aug).

Port of the evaluation half of `d3roma_tpu/data/datasets.py`: the base
classes (`BaseDataset`, `RepeatedDataset`, `ConcatDataset`) and
`ActiveStereoDataset` with the two public variants' eval sets (`Dreds`,
`HISS`, `ClearPose`, `SynTODDRgbd`, `Gapartnet2`, `Real`). The passive
`StereoDataset` family (SceneFlow ... KITTIStereo) and its augmentation
belong to the training slice (ROADMAP.md). Items are numpy, channel-LAST,
*raw* (un-normalized) — numeric normalization runs batched on the device
(`data/preprocess.py`). Item keys: disp, valid, depth, raw_depth, rgb,
left, right, fxb, K, index, path, device. PNGs are read by `utils/png.py`
and resized by `utils/resize.py`, with cv2.resize's semantics.
"""

from __future__ import annotations

import glob
import os.path as osp
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from d3roma_tpu_torch.utils import frame_utils
from d3roma_tpu_torch.utils.camera import DepthCamera
from d3roma_tpu_torch.utils.resize import INTER_LINEAR, INTER_NEAREST, resize

def _to_rgb3(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        return np.tile(img[..., None], (1, 1, 3))
    return img[..., :3]


class BaseDataset:
    # Augmentation randomness is a pure function of (seed, epoch, index) so
    # sample content never depends on worker-thread interleaving — a shared
    # mutable Generator would make runs irreproducible and break
    # resume-replays-the-same-stream guarantees.
    _epoch = 0
    _base_seed = 0

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def _sample_rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([int(self._base_seed), int(self._epoch), int(index)])
        )

    def __mul__(self, v: int) -> "BaseDataset":
        """Oversample by list replication (reference:
        data/stereo_datasets.py:158-164)."""
        return RepeatedDataset(self, v)

    __rmul__ = __mul__

    def __add__(self, other: "BaseDataset") -> "BaseDataset":
        return ConcatDataset([self, other])


class RepeatedDataset(BaseDataset):
    def __init__(self, base: BaseDataset, times: int):
        self.base = base
        self.times = times

    def __len__(self):
        return len(self.base) * self.times

    def set_epoch(self, epoch: int):
        self.base.set_epoch(epoch)

    def __getitem__(self, index):
        # pass the RAW repeated index through: the base modulos it for
        # list access but seeds the augmentation RNG with it, so the w
        # oversampled copies of a sample get w DIFFERENT augmentations
        # (keying on the modulo'd index made every copy byte-identical)
        return self.base[index]


class ConcatDataset(BaseDataset):
    def __init__(self, datasets: Sequence[BaseDataset]):
        self.datasets = list(datasets)
        self._cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self._cum[-1])

    def set_epoch(self, epoch: int):
        for d in self.datasets:
            d.set_epoch(epoch)

    def __getitem__(self, index):
        di = int(np.searchsorted(self._cum, index, side="right"))
        prev = 0 if di == 0 else int(self._cum[di - 1])
        return self.datasets[di][index - prev]


# ---------------------------------------------------------------------- #
# Active stereo / RGB-D
# ---------------------------------------------------------------------- #


class ActiveStereoDataset(BaseDataset):
    """RGB-D / active-IR: GT depth + raw sensor depth, device depth units,
    random crop-with-margin + hflip, disp or depth working space
    (reference: data/stereo_datasets.py:353-545)."""

    def __init__(self, camera: DepthCamera, image_size, split="train",
                 space="disp", reader: Optional[Callable] = None, seed=None):
        self.camera = camera
        self.image_size = (image_size, image_size) if isinstance(image_size, int) else tuple(image_size)
        self.split = split
        self.space = space
        self.disparity_reader = reader
        self._base_seed = 0 if seed is None else int(seed)
        self.rgb_list: List[str] = []
        self.depth_list: List[str] = []
        self.raw_depth_list: List[str] = []
        self.image_list: List[Tuple[str, str]] = []
        self.disparity_list: List[str] = []

    def __len__(self):
        return len(self.disparity_list)

    def _read_depth(self, filename):
        """Per-device units (mm for real sensors) at camera resolution
        (reference: stereo_datasets.py:424-441)."""
        depth = np.array(frame_utils.read_gen(filename))
        depth_unit = 1.0
        if self.camera.device in ("fxm", "jav", "d435", "clearpose"):
            depth_unit = 1e-3
            depth = depth.astype(np.int32)
        depth = resize(depth, dsize=self.camera.resolution[::-1],
                       interpolation=INTER_NEAREST)
        depth = np.asarray(depth, np.float32) * depth_unit
        if depth.ndim == 3 and depth.shape[-1] == 3:
            depth = depth[..., 0]
        return depth[..., None] if depth.ndim == 2 else depth

    def __getitem__(self, index):
        raw_index = index  # distinct per oversampled copy (RepeatedDataset)
        index = index % len(self.disparity_list)
        disp = self.disparity_reader(self.disparity_list[index])
        if isinstance(disp, tuple):
            disp, valid = disp[0], disp[1]
        else:
            valid = (disp > 0) & (disp < 512)

        rgb = _to_rgb3(np.array(frame_utils.read_gen(self.rgb_list[index])).astype(np.uint8))
        if self.image_list:
            img1 = _to_rgb3(np.array(frame_utils.read_gen(self.image_list[index][0])).astype(np.uint8))
            img2 = _to_rgb3(np.array(frame_utils.read_gen(self.image_list[index][1])).astype(np.uint8))
        else:
            img1 = np.zeros_like(rgb)
            img2 = np.zeros_like(rgb)

        res = self.camera.resolution
        if img1.shape[:2] != tuple(res):
            img1 = resize(img1, dsize=res[::-1], interpolation=INTER_LINEAR)
            img2 = resize(img2, dsize=res[::-1], interpolation=INTER_LINEAR)
        if rgb.shape[:2] != tuple(res):
            rgb = resize(rgb, dsize=res[::-1], interpolation=INTER_LINEAR)

        depth = self._read_depth(self.depth_list[index])
        raw_depth = self._read_depth(self.raw_depth_list[index])
        raw_depth = np.maximum(raw_depth, 0.0)  # DREDS negatives -> 0

        disp = np.asarray(disp, np.float32)[..., None]
        valid = np.asarray(valid, np.float32)[..., None]

        # stack -> flip -> crop, keeping all fields aligned
        # (reference: stereo_datasets.py:457-496)
        fields = np.concatenate([disp, rgb, img1, img2, valid, depth, raw_depth], axis=-1)
        if self.split == "train":
            rng = self._sample_rng(raw_index)
            if rng.random() < 0.5:
                fields = fields[:, ::-1]
            fields = self._random_crop(fields, rng)
        splits = np.split(fields, [1, 4, 7, 10, 11, 12], axis=-1)
        disp, rgb, img1, img2, valid, depth = splits[:6]
        raw_depth = splits[6]

        return {
            "disp": np.ascontiguousarray(disp, dtype=np.float32),
            "valid": np.ascontiguousarray(valid, dtype=np.float32),
            "depth": np.ascontiguousarray(depth, dtype=np.float32),
            "raw_depth": np.ascontiguousarray(raw_depth, dtype=np.float32),
            "rgb": np.ascontiguousarray(rgb, dtype=np.float32),
            "left": np.ascontiguousarray(img1, dtype=np.float32),
            "right": np.ascontiguousarray(img2, dtype=np.float32),
            "fxb": np.float32(self.camera.fxb_depth),
            "K": self.camera.K_depth.arr.astype(np.float32),
            "index": np.int32(index),
            "path": self.raw_depth_list[index],
            "device": self.camera.device,
        }

    def _random_crop(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Random crop to image_size (margin handling per reference:
        stereo_datasets.py:457-474; margin_left is asserted 0 there)."""
        H, W = self.image_size
        H1, W1 = x.shape[:2]
        if H >= H1 and W >= W1:
            return x
        off_y = int(rng.integers(0, max(1, H1 - H)))
        off_x = int(rng.integers(0, max(1, W1 - W)))
        return x[off_y : off_y + H, off_x : off_x + W]


def _sorted_glob(*parts):
    return sorted(glob.glob(osp.join(*parts)))


class Dreds(ActiveStereoDataset):
    """(reference: data/stereo_datasets.py:547-583)"""

    def __init__(self, camera, image_size, split="train", space="disp",
                 root="datasets/DREDS", variant="default", reader=None, seed=None):
        super().__init__(camera, image_size, split, space, reader, seed)
        sub = {"train": "train", "val": "val",
               "test": "test"}.get(split, split)
        base = osp.join(root, sub)
        self.rgb_list = _sorted_glob(base, "**/*_color.png")
        self.depth_list = _sorted_glob(base, "**/*_gt_depth.exr")
        self.raw_depth_list = _sorted_glob(base, "**/*_simDepthImage.exr")
        self.disparity_list = self.depth_list
        self.image_list = [
            (p.replace("_color.png", "_ir_l.png"), p.replace("_color.png", "_ir_r.png"))
            for p in self.rgb_list
        ]
        if not all(osp.exists(a) and osp.exists(b) for a, b in self.image_list[:1]):
            self.image_list = []
        assert len(self.rgb_list) == len(self.depth_list) == len(self.raw_depth_list), (
            f"DREDS list mismatch: {len(self.rgb_list)}/{len(self.depth_list)}/{len(self.raw_depth_list)}"
        )


class HISS(ActiveStereoDataset):
    """(reference: data/stereo_datasets.py:585-626)"""

    def __init__(self, camera, image_size, split="train", space="disp",
                 root="datasets/HISS", variant="default", reader=None, seed=None):
        super().__init__(camera, image_size, split, space, reader, seed)
        base = osp.join(root, split)
        bad = set()
        bad_file = osp.join(root, "bad_his.txt")
        if osp.exists(bad_file):
            with open(bad_file) as f:
                bad = {line.strip() for line in f if line.strip()}
        rgbs = [p for p in _sorted_glob(base, "**/*_color.png") if p not in bad]
        self.rgb_list = rgbs
        self.depth_list = [p.replace("_color.png", "_depth.exr") for p in rgbs]
        self.raw_depth_list = [p.replace("_color.png", "_simDepthImage.exr") for p in rgbs]
        self.disparity_list = self.depth_list
        self.image_list = [
            (p.replace("_color.png", "_ir_l.png"), p.replace("_color.png", "_ir_r.png"))
            for p in rgbs
        ]


class ClearPose(ActiveStereoDataset):
    """Set/scene splits incl. named test conditions
    (reference: data/stereo_datasets.py:628-742)."""

    TEST_CONDITIONS = {
        "new_background": [("set4", None)],
        "heavy_occlusion": [("set5", None)],
        "translucent_cover": [("set6", None)],
        "opaque_distractor": [("set7", None)],
        "filled_liquid": [("set8", None)],
        "non_planar": [("set9", None)],
    }

    def __init__(self, camera, image_size, split="train", space="disp",
                 root="datasets/ClearPose", variant="default", reader=None, seed=None):
        super().__init__(camera, image_size, split, space, reader, seed)
        if split == "train":
            sets = [("set1", None), ("set2", None), ("set3", None)]
        elif split in self.TEST_CONDITIONS:
            sets = self.TEST_CONDITIONS[split]
        else:
            sets = [("set1", "scene1")]  # small val slice
        for set_name, scene in sets:
            pattern = osp.join(root, set_name, scene or "*", "*-color.png")
            for p in sorted(glob.glob(pattern)):
                self.rgb_list.append(p)
                self.depth_list.append(p.replace("-color.png", "-depth_true.png"))
                self.raw_depth_list.append(p.replace("-color.png", "-depth.png"))
        self.disparity_list = self.depth_list


class SynTODDRgbd(ActiveStereoDataset):
    """3 raw variants (reference: data/stereo_datasets.py:744-790)."""

    def __init__(self, camera, image_size, split="train", space="disp",
                 root="datasets/SynTODD", variant="mlt", reader=None, seed=None):
        super().__init__(camera, image_size, split, space, reader, seed)
        base = osp.join(root, split)
        self.rgb_list = _sorted_glob(base, "*_rgb.png")
        self.depth_list = [p.replace("_rgb.png", "_gt_depth.exr") for p in self.rgb_list]
        raw_suffix = {"mlt": "_mlt_depth.exr", "sgm": "_sgm_depth.exr",
                      "default": "_raw_depth.exr"}.get(variant, "_raw_depth.exr")
        self.raw_depth_list = [p.replace("_rgb.png", raw_suffix) for p in self.rgb_list]
        self.disparity_list = self.depth_list


class Gapartnet2(ActiveStereoDataset):
    """(reference: data/stereo_datasets.py:792-822)"""

    def __init__(self, camera, image_size, split="train", space="disp",
                 root="datasets/Gapartnet2", variant="default", reader=None, seed=None):
        super().__init__(camera, image_size, split, space, reader, seed)
        base = osp.join(root, split)
        self.rgb_list = _sorted_glob(base, "**/*_color.png")
        self.depth_list = [p.replace("_color.png", "_depth.exr") for p in self.rgb_list]
        self.raw_depth_list = [p.replace("_color.png", "_simDepthImage.exr") for p in self.rgb_list]
        self.disparity_list = self.depth_list
        self.image_list = [
            (p.replace("_color.png", "_ir_l.png"), p.replace("_color.png", "_ir_r.png"))
            for p in self.rgb_list
        ]


class Real(ActiveStereoDataset):
    """Bundled RealSense captures with intrinsics.txt
    (reference: data/stereo_datasets.py:825-858; data layout
    datasets/Real/<scene>/{rgb,depth,ir_l,ir_r})."""

    def __init__(self, camera, image_size, split="test", space="disp",
                 root="datasets/Real", scene="xiaomeng", reader=None, seed=None):
        super().__init__(camera, image_size, split, space, reader, seed)
        base = osp.join(root, scene)
        # The reference globs recursive substrings (`**/*rgb*`,
        # stereo_datasets.py:834-840), so its bundled capture layout is
        # `0000_rgb.png` etc. — cover that naming alongside the
        # `*_color.png` / `rgb/` layouts.
        self.rgb_list = (_sorted_glob(base, "*_color.png")
                         or _sorted_glob(base, "rgb", "*.png")
                         or _sorted_glob(base, "*rgb*.png"))
        self.raw_depth_list = _sorted_glob(base, "*_depth.png") or _sorted_glob(base, "depth", "*.png")
        self.depth_list = self.raw_depth_list  # no GT for real captures
        self.disparity_list = self.raw_depth_list
        ir_l = _sorted_glob(base, "*_ir_l.png") or _sorted_glob(base, "ir_l", "*.png")
        ir_r = _sorted_glob(base, "*_ir_r.png") or _sorted_glob(base, "ir_r", "*.png")
        # one missing file must fail loudly, not silently re-pair every
        # later frame (zip truncates) or IndexError at high indices
        if not (len(ir_l) == len(ir_r) == len(self.rgb_list)
                == len(self.raw_depth_list)):
            raise ValueError(
                f"Real capture {base!r} has mismatched frame lists: "
                f"{len(self.rgb_list)} rgb, {len(self.raw_depth_list)} "
                f"depth, {len(ir_l)} ir_l, {len(ir_r)} ir_r")
        self.image_list = list(zip(ir_l, ir_r))
