"""RGB-D / active-IR dataset classes (host-side file IO + shape-defining aug).

Port of `d3roma_tpu/data/datasets.py`: the base classes (`BaseDataset`,
`RepeatedDataset`, `ConcatDataset`), the passive `StereoDataset` family
with its RAFT-style augmentation (`SceneFlow`, `Middlebury`, `ETH3D`,
`SintelStereo`, `FallingThings`, `TartanAir`, `KITTIStereo`; where a
reader resizes the disparity to the camera's resolution, the frames are
resized with it) and `ActiveStereoDataset` with the two public variants'
sets (`Dreds`, `HISS`, `ClearPose`, `SynTODDRgbd`, `Gapartnet2`, `Real`). Items are numpy, channel-LAST,
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

from d3roma_tpu_torch.data.augment import FlowAugmentor, SparseFlowAugmentor
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
# Passive stereo (SceneFlow family)
# ---------------------------------------------------------------------- #


class StereoDataset(BaseDataset):
    """Passive stereo: GT disparity from PFM + left/right frames, with
    RAFT-style augmentation producing a disparity 'flow'
    (reference: data/stereo_datasets.py:33-156)."""

    def __init__(self, aug_params=None, sparse: bool = False, reader=None,
                 camera: Optional[DepthCamera] = None):
        self.augmentor = None
        self.sparse = sparse
        self.img_pad = aug_params.pop("img_pad", None) if aug_params is not None else None
        if aug_params is not None and "crop_size" in aug_params:
            if sparse:
                self.augmentor = SparseFlowAugmentor(**aug_params)
            else:
                self.augmentor = FlowAugmentor(**aug_params)
        self.disparity_reader = reader if reader is not None else frame_utils.read_gen
        self.camera = camera
        self.is_test = False
        self.disparity_list: List[str] = []
        self.image_list: List[Tuple[str, str]] = []
        self.sim_list: List[str] = []
        self.extra_info: List = []

    def __len__(self):
        return len(self.image_list)

    def __getitem__(self, index):
        raw_index = index  # distinct per oversampled copy (RepeatedDataset)
        index = index % len(self.image_list)
        disp = self.disparity_reader(self.disparity_list[index])
        if isinstance(disp, tuple):
            disp, valid = disp[0], disp[1]
        else:
            valid = disp < 512

        img1 = _to_rgb3(np.array(frame_utils.read_gen(self.image_list[index][0])).astype(np.uint8))
        img2 = _to_rgb3(np.array(frame_utils.read_gen(self.image_list[index][1])).astype(np.uint8))
        disp = np.array(disp).astype(np.float32)
        if img1.shape[:2] != disp.shape:
            # the reader brought the disparity to the camera's resolution
            # (read_sceneflow at a camera_resolution other than the
            # frames'): the frames follow it, bilinearly. The JAX package
            # keeps them at their own size, and its batches of such items
            # cannot be stacked (ROADMAP.md section 3).
            dsize = (disp.shape[1], disp.shape[0])
            img1 = resize(img1, dsize, INTER_LINEAR)
            img2 = resize(img2, dsize, INTER_LINEAR)

        # precomputed sim (SGM) disparity, if present ("" = missing for
        # this frame; zeros keep the channel layout)
        if self.sim_list and self.sim_list[index]:
            sim = self.disparity_reader(self.sim_list[index])
            sim = sim[0] if isinstance(sim, tuple) else sim
            sim = np.array(sim).astype(np.float32)
        else:
            sim = np.zeros_like(disp)

        flow = np.stack([-disp, np.zeros_like(disp)], axis=-1)
        sim_flow = np.stack([-sim, np.zeros_like(sim)], axis=-1)

        if self.augmentor is not None:
            rng = self._sample_rng(raw_index)
            if self.sparse:
                img1, img2, flow, valid, sim_flow = self.augmentor(
                    img1, img2, flow, valid, rng=rng, sim_flow=sim_flow)
            else:
                img1, img2, flow, sim_flow = self.augmentor(img1, img2, flow, sim_flow, rng=rng)
                valid = (np.abs(flow[..., 0]) < 512) & (np.abs(flow[..., 1]) < 512)

        disp = -flow[..., 0]
        sim_disp = -sim_flow[..., 0] if sim_flow is not None else np.zeros_like(disp)
        valid = valid & (disp > 0)

        fxb = float(self.camera.fxb) if self.camera is not None else 1.0
        # passive stereo has no sensor depth; raw_depth carries the sim
        # disparity converted to pseudo-depth so device preprocessing can
        # rebuild the sim channel uniformly
        raw_depth = np.where(sim_disp > 0, fxb / np.maximum(sim_disp, 1e-6), 0.0)

        h, w = disp.shape
        return {
            "disp": disp[..., None].astype(np.float32),
            "valid": valid[..., None].astype(np.float32),
            "depth": np.where(disp > 0, fxb / np.maximum(disp, 1e-6), 0.0)[..., None].astype(np.float32),
            "raw_depth": raw_depth[..., None].astype(np.float32),
            "rgb": img1.astype(np.float32),
            "left": img1.astype(np.float32),
            "right": img2.astype(np.float32),
            "fxb": np.float32(fxb),
            "K": (self.camera.K_depth.arr if self.camera is not None else np.eye(3)).astype(np.float32),
            "index": np.int32(index),
            "path": self.disparity_list[index],
            "device": self.camera.device if self.camera is not None else "unknown",
        }


class SceneFlow(StereoDataset):
    """FlyingThings3D + Monkaa + Driving with the bad-file filter and a
    fixed 400-image val split (reference: data/stereo_datasets.py:169-249)."""

    def __init__(self, camera=None, aug_params=None, root="datasets/SceneFlow",
                 dstype="frames_cleanpass", split="train", resolution=None):
        super().__init__(aug_params, reader=lambda fn: frame_utils.read_sceneflow(resolution, fn),
                         camera=camera)
        self.root = root
        self.dstype = dstype
        self.split = split
        bad = set()
        bad_file = osp.join(root, "bad_his.txt")
        if osp.exists(bad_file):
            with open(bad_file) as f:
                bad = {line.strip() for line in f if line.strip()}
        self._add_things(split, bad)
        self._add_monkaa(split, bad)
        self._add_driving(split, bad)
        if split != "train":
            # fixed 400-sample validation subset
            self.image_list = self.image_list[:400]
            self.disparity_list = self.disparity_list[:400]
            self.sim_list = self.sim_list[:400] if self.sim_list else []

    def _pairs(self, image_root, disp_root, bad):
        lefts = sorted(glob.glob(osp.join(image_root, "**/left/*.png"), recursive=True))
        for lf in lefts:
            rf = lf.replace("/left/", "/right/")
            df = lf.replace(self.dstype, "disparity").replace(".png", ".pfm")
            if lf in bad or not osp.exists(rf) or not osp.exists(df):
                continue
            self.image_list.append((lf, rf))
            self.disparity_list.append(df)
            sim = lf.replace(self.dstype, "raw_cleanpass").replace(".png", ".pfm")
            # "" placeholder keeps sim_list index-aligned with
            # image_list — conditional appends silently paired most
            # frames with another scene's sim disparity
            self.sim_list.append(sim if osp.exists(sim) else "")

    def _add_things(self, split, bad):
        sub = "TRAIN" if split == "train" else "TEST"
        self._pairs(osp.join(self.root, "FlyingThings3D", self.dstype, sub),
                    None, bad)

    def _add_monkaa(self, split, bad):
        if split == "train":
            self._pairs(osp.join(self.root, "Monkaa", self.dstype), None, bad)

    def _add_driving(self, split, bad):
        if split == "train":
            self._pairs(osp.join(self.root, "Driving", self.dstype), None, bad)


class Middlebury(StereoDataset):
    """Middlebury v3 (reference: data/stereo_datasets.py:322-351)."""

    def __init__(self, camera=None, aug_params=None, root="datasets/Middlebury", split="F"):
        super().__init__(aug_params, sparse=True,
                         reader=frame_utils.readDispMiddlebury, camera=camera)
        scenes = sorted(glob.glob(osp.join(root, "MiddEval3", f"train{split}", "*")))
        for scene in scenes:
            self.image_list.append(
                (osp.join(scene, "im0.png"), osp.join(scene, "im1.png"))
            )
            self.disparity_list.append(osp.join(scene, "disp0GT.pfm"))


class ETH3D(StereoDataset):
    """(reference: data/stereo_datasets.py:252-268)"""

    def __init__(self, camera=None, aug_params=None, root="datasets/ETH3D", split="training"):
        super().__init__(aug_params, sparse=True, camera=camera)
        img1s = sorted(glob.glob(osp.join(root, f"two_view_{split}/*/im0.png")))
        # non-training splits have no GT; the reference substitutes one
        # fixed training disparity as a dummy (stereo_datasets.py:259) —
        # an im0 PNG here would crash the PFM reader
        dummy = osp.join(root, "two_view_training_gt/playground_1l/disp0GT.pfm")
        for im0 in img1s:
            self.image_list.append((im0, im0.replace("im0", "im1")))
            self.disparity_list.append(
                osp.join(osp.dirname(im0), "disp0GT.pfm")
                if split == "training" else dummy
            )


class SintelStereo(StereoDataset):
    """MPI-Sintel stereo: clean/final left-right renders over one shared
    RGB-packed disparity per scene/frame (reference:
    data/stereo_datasets.py:264-276). The disparity path is derived from
    the frame's scene/name — both `clean_left` and `final_left` passes map
    to the same training/disparities file, which the reference enforces by
    an assert on a doubled sorted list."""

    def __init__(self, camera=None, aug_params=None,
                 root="datasets/SintelStereo"):
        super().__init__(aug_params, sparse=True,
                         reader=frame_utils.readDispSintelStereo,
                         camera=camera)
        for lf in sorted(glob.glob(
                osp.join(root, "training", "*_left", "*", "frame_*.png"))):
            scene, frame = lf.split(osp.sep)[-2:]
            self.image_list.append((lf, lf.replace("_left", "_right")))
            self.disparity_list.append(
                osp.join(root, "training", "disparities", scene, frame))


class FallingThings(StereoDataset):
    """NVIDIA FallingThings: filenames.txt lists left JPEGs; right frames
    and 0.1mm depth PNGs are path-derived (reference:
    data/stereo_datasets.py:277-292)."""

    def __init__(self, camera=None, aug_params=None,
                 root="datasets/FallingThings"):
        super().__init__(aug_params,
                         reader=frame_utils.readDispFallingThings,
                         camera=camera)
        with open(osp.join(root, "filenames.txt")) as f:
            names = sorted(line.strip() for line in f if line.strip())
        for name in names:
            self.image_list.append((osp.join(root, name),
                                    osp.join(root, name.replace(
                                        "left.jpg", "right.jpg"))))
            self.disparity_list.append(
                osp.join(root, name.replace("left.jpg", "left.depth.png")))


class TartanAir(StereoDataset):
    """TartanAir: tartanair_filenames.txt lists left PNGs; depth .npy is
    path-derived; `seasonsforest_winter/Easy` is excluded and optional
    keywords filter the listing (reference:
    data/stereo_datasets.py:293-310)."""

    def __init__(self, camera=None, aug_params=None, root="datasets",
                 keywords: Sequence[str] = ()):
        super().__init__(aug_params, reader=frame_utils.readDispTartanAir,
                         camera=camera)
        with open(osp.join(root, "tartanair_filenames.txt")) as f:
            names = sorted(line.strip() for line in f
                           if line.strip()
                           and "seasonsforest_winter/Easy" not in line)
        for kw in keywords:
            names = [n for n in names if kw in n.lower()]
        for name in names:
            self.image_list.append((osp.join(root, name),
                                    osp.join(root, name.replace(
                                        "_left", "_right"))))
            self.disparity_list.append(osp.join(root, name.replace(
                "image_left", "depth_left").replace(
                "left.png", "left_depth.npy")))


class KITTIStereo(StereoDataset):
    """KITTI 2015 stereo pairs + sparse disp_occ_0 GT (reference's stereo
    KITTI class, data/stereo_datasets.py:311-321 — registered here as
    `KITTIStereo`: the registry name `KITTI` is taken by the mono-depth
    reader, matching the reference's own registry at data/data_loader.py:10
    which also binds `KITTI` to the mono class)."""

    def __init__(self, camera=None, aug_params=None, root="datasets/KITTI",
                 image_set="training"):
        super().__init__(aug_params, sparse=True,
                         reader=frame_utils.readDispKITTI, camera=camera)
        img1s = sorted(glob.glob(osp.join(root, image_set, "image_2",
                                          "*_10.png")))
        # non-training sets have no GT; the reference substitutes one fixed
        # training disparity as a dummy (stereo_datasets.py:318)
        dummy = osp.join(root, "training", "disp_occ_0", "000085_10.png")
        for im0 in img1s:
            self.image_list.append((im0, im0.replace("image_2", "image_3")))
            self.disparity_list.append(
                im0.replace("image_2", "disp_occ_0")
                if image_set == "training" else dummy)


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
