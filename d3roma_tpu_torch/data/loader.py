"""Dataset registry, factory, and the host->device input pipeline.

Port of `d3roma_tpu/data/loader.py`: `create_dataset(config, name,
split)` binds per-dataset camera defaults, disparity readers and the
train split's augmentation for the active-stereo / RGB-D datasets
(`Dreds`, `HISS`, `Gapartnet2`, `ClearPose`, `SynTODDRgbd`,
`Real_<split>_<device>`) and the passive-stereo ones (`SceneFlow`,
`Middlebury`, `SintelStereo`, `FallingThings`, `TartanAir`,
`KITTIStereo`) and the monocular ones (`data/mono_datasets.py`: `NYUv2`,
`HyperSim`, `ScanNet`, ..., `KITTI` naming the mono reader, as in the JAX
registry). `val_loaders(config)`
builds one loader per eval dataset; `fetch_dataloader(config)` adds the
weighted train concat. The loader is a thread-pool prefetching batcher
feeding numpy batches; `data/preprocess.py` normalizes them on the
device.
"""

from __future__ import annotations

import os
import queue
import threading
from functools import partial
from typing import Iterator, List, Optional, Tuple

import numpy as np

from d3roma_tpu_torch.data import datasets as D
from d3roma_tpu_torch.data import mono_datasets as M
from d3roma_tpu_torch.utils import frame_utils
from d3roma_tpu_torch.utils.camera import Realsense, RGBDCamera

STEREO_DATASETS = ["Dreds", "SceneFlow", "Real", "HISS", "ClearPose",
                   "SynTODDRgbd", "Gapartnet2", "Middlebury",
                   # the reference's RAFT-heritage readers
                   # (data/stereo_datasets.py:264-321) — unregistered in the
                   # reference's own factory (data_loader.py:10); registered
                   # here so they are reachable from task configs. The
                   # stereo KITTI class is `KITTIStereo` (`KITTI` names the
                   # mono reader, as in the reference registry).
                   "SintelStereo", "FallingThings", "TartanAir",
                   "KITTIStereo"]
MONO_DATASETS = ["NYUv2", "ScanNet", "HyperSim", "SceneNet", "ScanNetpp",
                 "VK2", "KITTI", "InStereo2K", "Tartenair", "HRWSI", "SynTODD"]



def _stereo_aug(config, split: str, image_size):
    """The RAFT augmentation's parameters of a passive-stereo train split."""
    if split != "train" or config.augment is None:
        return None
    return dict(crop_size=image_size,
                min_scale=config.augment.min_scale,
                max_scale=config.augment.max_scale,
                saturation_range=tuple(config.augment.saturation_range),
                gamma=tuple(config.augment.gamma),
                yjitter=config.augment.yjitter)


def create_dataset(config, name: str, split: str):
    """Bind cameras + readers per dataset (reference: data/data_loader.py:9-118).

    `Real_<split>_<device>` parses into the bundled Real captures on a
    specific calibrated device (data_loader.py:14-15).
    """
    image_size = tuple(config.image_size)
    space = config.prediction_space
    variant = config.dataset_variant

    if name.startswith("Real"):
        parts = name.split("_")
        device = parts[2] if len(parts) > 2 else "fxm"
        camera = Realsense.default_real(device)
        camera.change_resolution(config.camera_resolution)
        return D.Real(camera, image_size, split=split, space=space,
                      reader=partial(frame_utils.readDispReal, camera))

    if name == "Dreds":
        camera = Realsense.default_sim(min_depth=0.2, max_depth=2.0)
        camera.change_resolution(config.camera_resolution)
        return D.Dreds(camera, image_size, split=split, space=space,
                       variant=variant,
                       reader=partial(frame_utils.readDispDreds_exr, camera))

    if name == "HISS":
        camera = Realsense.default_sim(min_depth=0.2, max_depth=2.0)
        camera.change_resolution(config.camera_resolution)
        return D.HISS(camera, image_size, split=split, space=space,
                      variant=variant,
                      reader=partial(frame_utils.readDispReal, camera))

    if name == "Gapartnet2":
        camera = Realsense.default_sim(min_depth=0.2, max_depth=2.0)
        camera.change_resolution(config.camera_resolution)
        return D.Gapartnet2(camera, image_size, split=split, space=space,
                            variant=variant,
                            reader=partial(frame_utils.readDispReal, camera))

    if name == "ClearPose":
        camera = RGBDCamera.default_clearpose()
        camera.change_resolution(config.camera_resolution)
        return D.ClearPose(camera, image_size, split=split, space=space,
                           variant=variant,
                           reader=partial(frame_utils.readDispReal, camera))

    if name == "SynTODDRgbd":
        camera = RGBDCamera.default_syntodd()
        camera.change_resolution(config.camera_resolution)
        return D.SynTODDRgbd(camera, image_size, split=split, space=space,
                             variant=variant,
                             reader=partial(frame_utils.readDispReal, camera))

    if name == "SceneFlow":
        camera = Realsense.default_sim(min_depth=0.2, max_depth=2.0)
        camera.change_resolution(config.camera_resolution)
        return D.SceneFlow(camera=camera, aug_params=_stereo_aug(config, split, image_size),
                           split=split, resolution=camera.resolution)

    if name == "Middlebury":
        camera = Realsense.default_sim()
        return D.Middlebury(camera=camera)

    if name in ("SintelStereo", "FallingThings", "TartanAir", "KITTIStereo"):
        # RAFT-heritage passive-stereo readers: disparity-space, no device
        # camera binding (the reference constructs them with aug_params
        # only); train split gets the RAFT augmentation like SceneFlow
        return getattr(D, name)(aug_params=_stereo_aug(config, split, image_size))

    if name in MONO_DATASETS:
        return getattr(M, name)(image_size, split=split)

    raise ValueError(f"unknown dataset: {name}")


# ---------------------------------------------------------------------- #
# Batching / prefetching
# ---------------------------------------------------------------------- #

_COLLATE_KEYS = ("disp", "valid", "depth", "raw_depth", "rgb", "left",
                 "right", "fxb", "K", "index")


def collate(items: List[dict]) -> dict:
    """Stack numeric fields; keep path/device as lists."""
    batch = {k: np.stack([it[k] for it in items]) for k in _COLLATE_KEYS if k in items[0]}
    batch["path"] = [it["path"] for it in items]
    batch["device"] = [it["device"] for it in items]
    return batch


class DataLoader:
    """Thread-pool prefetching batcher over a BaseDataset.

    Worker threads run __getitem__ (zlib, numpy and file IO release the
    GIL); a bounded queue holds ready batches. Worker
    count follows SLURM_CPUS_PER_TASK like the reference
    (data/data_loader.py:161-166).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, num_workers: Optional[int] = None,
                 seed: int = 0, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_workers is None:
            num_workers = int(os.environ.get("SLURM_CPUS_PER_TASK", "4"))
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)  # per-sample aug keys fold the epoch in

    def _index_batches(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        nb = len(self)
        return [order[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)]

    def __iter__(self) -> Iterator[dict]:
        batches = self._index_batches()
        idx_q: "queue.Queue" = queue.Queue()
        for bi, idxs in enumerate(batches):
            idx_q.put((bi, idxs))
        stop = threading.Event()
        results = {}
        results_lock = threading.Condition()
        # caps decoded-but-unconsumed batches at `prefetch`: without it
        # the workers race through the whole epoch and the results dict
        # holds every decoded batch (host OOM on big datasets). Acquired
        # BEFORE pulling from idx_q so slot holders always own the
        # oldest remaining batches — the in-order consumer can't starve.
        slots = threading.Semaphore(max(1, self.prefetch))

        def worker():
            while not stop.is_set():
                if not slots.acquire(timeout=0.1):
                    continue
                try:
                    bi, idxs = idx_q.get_nowait()
                except queue.Empty:
                    slots.release()
                    return
                try:
                    batch = collate([self.dataset[int(i)] for i in idxs])
                except Exception as e:  # surface worker errors
                    batch = e
                with results_lock:
                    results[bi] = batch
                    results_lock.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for bi in range(len(batches)):
                with results_lock:
                    while bi not in results:
                        results_lock.wait(timeout=60.0)
                    batch = results.pop(bi)
                slots.release()  # frees a worker to decode the next batch
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()


def val_loaders(config, seed: int = 0) -> List[DataLoader]:
    """One val loader per eval dataset, in order (reference:
    data/data_loader.py:158-170)."""
    loaders = []
    for name in config.eval_dataset:
        ds = create_dataset(config, name, config.eval_split)
        loaders.append(DataLoader(ds, config.eval_batch_size, shuffle=False,
                                  drop_last=False, seed=seed))
    return loaders


def fetch_dataloader(config, seed: int = 0) -> Tuple[DataLoader, List[DataLoader]]:
    """Weighted concat of train datasets + one val loader per eval dataset
    (reference: data/data_loader.py:120-170)."""
    assert len(config.train_dataset) == len(config.dataset_weight), (
        "dataset_weight must match train_dataset"
    )
    train_sets = []
    for name, w in zip(config.train_dataset, config.dataset_weight):
        ds = create_dataset(config, name, "train")
        # reference semantics: the base dataset is ALWAYS included once
        # plus int(w)-1 extra copies (data_loader.py:143) — int(0.5)=0
        # must not silently drop the dataset to an empty concat member
        reps = max(1, int(w))
        if reps != w:
            import logging

            logging.getLogger(__name__).warning(
                "dataset_weight %r for %s truncated to %d (weights are "
                "whole-dataset repetition counts)", w, name, reps)
        train_sets.append(ds * reps if reps != 1 else ds)
    train_ds = train_sets[0]
    for ds in train_sets[1:]:
        train_ds = train_ds + ds
    train_loader = DataLoader(train_ds, config.train_batch_size, shuffle=True,
                              drop_last=True, seed=seed)
    return train_loader, val_loaders(config, seed)
