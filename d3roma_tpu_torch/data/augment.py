"""RAFT-Stereo style data augmentation (host-side, numpy).

Port of `d3roma_tpu/data/augment.py` without OpenCV: the RGB <-> HSV
conversions are `utils/hsv.py`'s and the `fx`/`fy` resizes
`utils/resize.py`'s, both with OpenCV's arithmetic, so an item augmented
from the same numpy Generator, whose draws come in the same order, is the
JAX package's. Rebuild of the reference augmentors (reference: data/augmentor.py:60-398):
photometric jitter (brightness/contrast/saturation/hue, optional asymmetric
between the two views, gamma), eraser occlusion on the right image, spatial
scale/stretch resizing, horizontal/vertical/stereo-swap flips, y-jitter
crop, and the sparse-disparity-aware resize. Augmentation is shape-defining
and file-adjacent, so it stays on the host; everything after (normalization,
disp conversions) is batched on the device (data/preprocess.py).
"""

from __future__ import annotations

import numpy as np

from d3roma_tpu_torch.utils.hsv import hsv_to_rgb, rgb_to_hsv
from d3roma_tpu_torch.utils.resize import resize


def _adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    return np.clip(255.0 * gain * (img / 255.0) ** gamma, 0, 255).astype(np.uint8)


def _color_jitter(rng, img, brightness=0.4, contrast=0.4, saturation=0.4, hue=0.5 / 3.14):
    """Torchvision-style ColorJitter on uint8 HWC."""
    img = img.astype(np.float32)
    # brightness
    img = img * rng.uniform(1 - brightness, 1 + brightness)
    # contrast
    mean = img.mean()
    img = (img - mean) * rng.uniform(1 - contrast, 1 + contrast) + mean
    img = np.clip(img, 0, 255).astype(np.uint8)
    # saturation + hue in HSV
    hsv = rgb_to_hsv(img).astype(np.float32)
    hsv[..., 1] *= rng.uniform(1 - saturation, 1 + saturation)
    hsv[..., 0] = (hsv[..., 0] + rng.uniform(-hue, hue) * 180.0) % 180.0
    hsv[..., 1] = np.clip(hsv[..., 1], 0, 255)
    return hsv_to_rgb(hsv.astype(np.uint8))


class FlowAugmentor:
    """Dense-disparity augmentor (reference: data/augmentor.py:60-231)."""

    def __init__(
        self,
        crop_size,
        min_scale: float = -0.2,
        max_scale: float = 0.5,
        spatial_aug_prob: float = 1.0,
        stretch_prob: float = 0.8,
        max_stretch: float = 0.2,
        do_flip: bool = False,
        yjitter: bool = False,
        saturation_range=(0.0, 1.4),
        gamma=(1, 1, 1, 1),
        seed: int | None = None,
    ):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = spatial_aug_prob
        self.stretch_prob = stretch_prob
        self.max_stretch = max_stretch
        self.do_flip = do_flip
        self.yjitter = yjitter
        self.saturation_range = saturation_range
        self.gamma = gamma
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5
        self.rng = np.random.default_rng(seed)

    # -------------------------------------------------------------- #
    def color_transform(self, img1, img2, rng=None):
        rng = self.rng if rng is None else rng
        lo, hi = self.saturation_range
        sat = (hi - lo) / 2

        def jitter(im):
            out = _color_jitter(rng, im, saturation=min(sat, 0.99))
            g_lo, g_hi = self.gamma[0], self.gamma[1]
            return _adjust_gamma(out, rng.uniform(g_lo, g_hi))

        if rng.random() < self.asymmetric_color_aug_prob:
            return jitter(img1), jitter(img2)
        stacked = np.concatenate([img1, img2], axis=0)
        out = jitter(stacked)
        return out[: img1.shape[0]], out[img1.shape[0] :]

    def eraser_transform(self, img1, img2, bounds=(50, 100), rng=None):
        """Random occlusion rectangles on the right image
        (reference: augmentor.py:107-121)."""
        rng = self.rng if rng is None else rng
        ht, wd = img1.shape[:2]
        if rng.random() < self.eraser_aug_prob:
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(rng.integers(1, 3)):
                x0 = rng.integers(0, wd)
                y0 = rng.integers(0, ht)
                dx = rng.integers(bounds[0], bounds[1])
                dy = rng.integers(bounds[0], bounds[1])
                img2 = img2.copy()
                img2[y0 : y0 + dy, x0 : x0 + dx, :] = mean_color
        return img1, img2

    def spatial_transform(self, img1, img2, flow, sim_flow=None, rng=None):
        """Random scale/stretch + flips + crop, keeping the disparity flow
        consistent (reference: augmentor.py:123-215). flow: [H,W,2]."""
        rng = self.rng if rng is None else rng
        ht, wd = img1.shape[:2]
        ch, cw = self.crop_size
        min_scale = max((ch + 8) / ht, (cw + 8) / wd)

        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if rng.random() < self.stretch_prob:
            scale_x *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        scale_x = max(scale_x, min_scale)
        scale_y = max(scale_y, min_scale)

        if rng.random() < self.spatial_aug_prob:
            img1 = resize(img1, None, fx=scale_x, fy=scale_y)
            img2 = resize(img2, None, fx=scale_x, fy=scale_y)
            flow = resize(flow, None, fx=scale_x, fy=scale_y)
            flow = flow * [scale_x, scale_y]
            if sim_flow is not None:
                sim_flow = resize(sim_flow, None, fx=scale_x, fy=scale_y)
                sim_flow = sim_flow * [scale_x, scale_y]

        if self.do_flip:
            if rng.random() < 0.5:  # h-flip + stereo swap
                tmp1 = img1[:, ::-1]
                tmp2 = img2[:, ::-1]
                img1, img2 = tmp2, tmp1
                flow = flow[:, ::-1] * [-1.0, 1.0]
                if sim_flow is not None:
                    sim_flow = sim_flow[:, ::-1] * [-1.0, 1.0]
            if rng.random() < 0.1:  # v-flip
                img1 = img1[::-1]
                img2 = img2[::-1]
                flow = flow[::-1] * [1.0, -1.0]
                if sim_flow is not None:
                    sim_flow = sim_flow[::-1] * [1.0, -1.0]

        if self.yjitter:
            y0 = rng.integers(2, img1.shape[0] - ch - 2)
            x0 = rng.integers(2, img1.shape[1] - cw - 2)
            y1 = y0 + rng.integers(-2, 3)
            img1 = img1[y0 : y0 + ch, x0 : x0 + cw]
            img2 = img2[y1 : y1 + ch, x0 : x0 + cw]
            flow = flow[y0 : y0 + ch, x0 : x0 + cw]
            if sim_flow is not None:
                sim_flow = sim_flow[y0 : y0 + ch, x0 : x0 + cw]
        else:
            y0 = rng.integers(0, max(1, img1.shape[0] - ch))
            x0 = rng.integers(0, max(1, img1.shape[1] - cw))
            img1 = img1[y0 : y0 + ch, x0 : x0 + cw]
            img2 = img2[y0 : y0 + ch, x0 : x0 + cw]
            flow = flow[y0 : y0 + ch, x0 : x0 + cw]
            if sim_flow is not None:
                sim_flow = sim_flow[y0 : y0 + ch, x0 : x0 + cw]

        out = (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
               np.ascontiguousarray(flow))
        if sim_flow is not None:
            return out + (np.ascontiguousarray(sim_flow),)
        return out + (None,)

    def __call__(self, img1, img2, flow, sim_flow=None, rng=None):
        """`rng` (when given) makes the augmentation a pure function of the
        caller's per-sample generator — required for reproducible runs with
        the threaded DataLoader."""
        img1, img2 = self.color_transform(img1, img2, rng=rng)
        img1, img2 = self.eraser_transform(img1, img2, rng=rng)
        return self.spatial_transform(img1, img2, flow, sim_flow, rng=rng)


class SparseFlowAugmentor(FlowAugmentor):
    """Valid-masked disparity variant: resizes the sparse flow map by
    scattering valid samples (reference: data/augmentor.py:233-398)."""

    def resize_sparse_flow_map(self, flow, valid, fx=1.0, fy=1.0):
        ht, wd = flow.shape[:2]
        coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)), axis=-1)
        coords = coords.reshape(-1, 2).astype(np.float32)
        flow = flow.reshape(-1, 2).astype(np.float32)
        valid = valid.reshape(-1).astype(np.float32)

        coords0 = coords[valid >= 1]
        flow0 = flow[valid >= 1]
        ht1 = int(round(ht * fy))
        wd1 = int(round(wd * fx))
        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]

        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        v = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
        xx, yy, flow1 = xx[v], yy[v], flow1[v]

        flow_img = np.zeros([ht1, wd1, 2], np.float32)
        valid_img = np.zeros([ht1, wd1], np.int32)
        flow_img[yy, xx] = flow1
        valid_img[yy, xx] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid, rng=None,
                          sim_flow=None):
        """`sim_flow` (dense, optional) rides the SAME scale/flip/crop as
        the sparse gt flow — leaving it untransformed mixed crop-sized gt
        with full-resolution sim in one item. Extra ops consume no rng
        draws, so the (img1, img2, flow, valid) stream is unchanged."""
        rng = self.rng if rng is None else rng
        ht, wd = img1.shape[:2]
        ch, cw = self.crop_size
        min_scale = max((ch + 1) / ht, (cw + 1) / wd)
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = max(scale, min_scale)
        scale_y = max(scale, min_scale)

        if rng.random() < self.spatial_aug_prob:
            img1 = resize(img1, None, fx=scale_x, fy=scale_y)
            img2 = resize(img2, None, fx=scale_x, fy=scale_y)
            flow, valid = self.resize_sparse_flow_map(flow, valid, fx=scale_x, fy=scale_y)
            if sim_flow is not None:
                sim_flow = resize(sim_flow, None, fx=scale_x, fy=scale_y)
                sim_flow = sim_flow * [scale_x, scale_y]

        if self.do_flip and rng.random() < 0.5:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]
            if sim_flow is not None:
                sim_flow = sim_flow[:, ::-1] * [-1.0, 1.0]

        margin_y, margin_x = 20, 50
        y0 = rng.integers(0, max(1, img1.shape[0] - ch + margin_y))
        x0 = rng.integers(-margin_x, max(1, img1.shape[1] - cw + margin_x))
        y0 = int(np.clip(y0, 0, max(0, img1.shape[0] - ch)))
        x0 = int(np.clip(x0, 0, max(0, img1.shape[1] - cw)))

        img1 = img1[y0 : y0 + ch, x0 : x0 + cw]
        img2 = img2[y0 : y0 + ch, x0 : x0 + cw]
        flow = flow[y0 : y0 + ch, x0 : x0 + cw]
        valid = valid[y0 : y0 + ch, x0 : x0 + cw]
        out = (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
               np.ascontiguousarray(flow), np.ascontiguousarray(valid))
        if sim_flow is None:
            return out
        sim_flow = sim_flow[y0 : y0 + ch, x0 : x0 + cw]
        return out + (np.ascontiguousarray(sim_flow),)

    def __call__(self, img1, img2, flow, valid, rng=None, sim_flow=None):
        img1, img2 = self.color_transform(img1, img2, rng=rng)
        img1, img2 = self.eraser_transform(img1, img2, rng=rng)
        return self.spatial_transform(img1, img2, flow, valid, rng=rng,
                                      sim_flow=sim_flow)
