"""The passive-stereo data of the training slice against the JAX package
and OpenCV: RGB <-> HSV (`utils/hsv.py`) bit-equal to `cv2.cvtColor` over
every gray, the pure hues and 10^6 random colors (and HSV -> RGB over
every (S, V) at every hue, at row widths that exercise OpenCV's vector
loop and its scalar tail); `utils/resize.py`'s fx/fy form bit-equal to
`cv2.resize(img, None, fx=..., fy=...)` on uint8 and on the 2-channel
float32 flows the augmentors resize (OpenCV's own code; float images of
1, 3 or 4 channels go to IPP in cv2, within 1e-6 of max |ref|); both
augmentors bit-equal to the JAX package's from the same numpy Generator;
and items of the seven passive-stereo datasets, from tiny on-disk trees,
equal to the JAX package's.

Where the JAX package's SceneFlow reader brings the disparity to a camera
resolution other than the frames' (the dataset's 960x540 frames under the
presets' 480x270 camera), the JAX items' frames and disparities disagree
in size and their batches cannot be stacked; the port resizes the frames
with the disparity (ROADMAP.md section 3). That case is checked for both.
"""

import json
import os

import cv2
import numpy as np
import pytest

import torch_port_utils  # noqa: F401  (one intra-op thread)
from d3roma_tpu.data import augment as jaug
from d3roma_tpu.data import datasets as JD
from d3roma_tpu.data.loader import collate as jax_collate
from d3roma_tpu_torch.data import augment as aug
from d3roma_tpu_torch.data import datasets as D
from d3roma_tpu_torch.data.loader import collate
from d3roma_tpu_torch.utils import png
from d3roma_tpu_torch.utils.camera import Realsense
from d3roma_tpu_torch.utils.frame_utils import writePFM
from d3roma_tpu_torch.utils.hsv import hsv_to_rgb, rgb_to_hsv
from d3roma_tpu_torch.utils.resize import INTER_NEAREST, resize


# ---------------------------------------------------------------------- HSV


def test_rgb_to_hsv_matches_cv2():
    gray = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    hues = []
    for v in (1, 64, 128, 255):
        for c in range(6):  # the six pure hue edges and their mixes
            ramp = np.arange(256)
            rgb = np.zeros((256, 3), np.int64)
            rgb[:, c % 3] = v
            rgb[:, (c + 1) % 3] = ramp * v // 255
            hues.append(rgb if c < 3 else rgb[:, ::-1])
    rs = np.random.RandomState(0)
    for img in (gray[None], np.concatenate(hues)[None].astype(np.uint8),
                rs.randint(0, 256, (1000, 1000, 3)).astype(np.uint8),
                rs.randint(0, 256, (7, 33, 3)).astype(np.uint8)):
        np.testing.assert_array_equal(rgb_to_hsv(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [256, 100, 33, 1])
def test_hsv_to_rgb_matches_cv2(width):
    """Every (H < 180, S, V), laid out in rows of `width` pixels: rows of
    256 go through OpenCV's vector loop alone, 100 and 33 end in its
    scalar tail, 1 is the scalar loop alone."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).reshape(-1, 3).astype(np.uint8)
    n = hsv.shape[0] // width * width
    if width == 1:
        n = 180 * 256 * 8  # the scalar loop on a slice of the domain: every hue
        hsv = hsv.reshape(180, 256 * 256, 3)[:, ::32].reshape(-1, 3)
    img = hsv[:n].reshape(-1, width, 3)
    np.testing.assert_array_equal(hsv_to_rgb(img), cv2.cvtColor(img, cv2.COLOR_HSV2RGB))
    # and back: every gray and a random million colors round trip as in cv2
    rs = np.random.RandomState(width)
    rgb = rs.randint(0, 256, (1000, 1000, 3)).astype(np.uint8)
    np.testing.assert_array_equal(hsv_to_rgb(rgb_to_hsv(rgb)),
                                  cv2.cvtColor(cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV),
                                               cv2.COLOR_HSV2RGB))


# ------------------------------------------------------------------ resize


def test_resize_fx_fy_matches_cv2():
    rs = np.random.RandomState(0)
    for _ in range(60):
        h, w = rs.randint(20, 90, 2)
        fx, fy = 2 ** rs.uniform(-1.2, 1.2, 2)
        u8 = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        flow = (rs.standard_normal((h, w, 2)) * 40).astype(np.float32)
        gray = (rs.standard_normal((h, w)) * 40).astype(np.float32)
        for img in (u8, flow, gray):
            want = cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
            got = resize(img, None, fx=fx, fy=fy)
            assert got.dtype == want.dtype
            if img is gray:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
            else:
                np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            resize(u8, None, fx=fx, fy=fy, interpolation=INTER_NEAREST),
            cv2.resize(u8, None, fx=fx, fy=fy, interpolation=cv2.INTER_NEAREST))
    with pytest.raises(ValueError):
        resize(u8, None)


# -------------------------------------------------------------- augmentors

AUG = dict(crop_size=(24, 40), min_scale=-0.2, max_scale=0.4, saturation_range=(0, 1.4),
           gamma=(0.9, 1.1, 1, 1), do_flip=True)


def _inputs(seed, h=48, w=80):
    rs = np.random.RandomState(seed)
    img1 = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    img2 = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    disp = rs.uniform(1, 30, (h, w)).astype(np.float32)
    flow = np.stack([-disp, np.zeros_like(disp)], -1)
    sim = np.stack([-(disp + rs.standard_normal((h, w)).astype(np.float32)),
                    np.zeros_like(disp)], -1)
    valid = rs.rand(h, w) > 0.3
    return img1, img2, flow, sim, valid


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("yjitter", [False, True])
def test_flow_augmentor_matches_jax(yjitter):
    for seed in range(12):
        img1, img2, flow, sim, _ = _inputs(seed)
        kw = dict(AUG, yjitter=yjitter)
        got = aug.FlowAugmentor(**kw)(img1, img2, flow, sim, rng=np.random.default_rng(seed))
        want = jaug.FlowAugmentor(**kw)(img1, img2, flow, sim, rng=np.random.default_rng(seed))
        _equal(got, want)


def test_sparse_flow_augmentor_matches_jax():
    for seed in range(12):
        img1, img2, flow, sim, valid = _inputs(100 + seed)
        got = aug.SparseFlowAugmentor(**AUG)(img1, img2, flow, valid,
                                             rng=np.random.default_rng(seed), sim_flow=sim)
        want = jaug.SparseFlowAugmentor(**AUG)(img1, img2, flow, valid,
                                               rng=np.random.default_rng(seed), sim_flow=sim)
        _equal(got, want)


# ---------------------------------------------------------------- datasets

H, W = 48, 80


def _img(path, rs, shape=(H, W, 3), dtype=np.uint8, high=256):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    png.write_png(path, rs.randint(0, high, shape).astype(dtype))


def _pfm(path, rs, shape=(H, W)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    writePFM(path, rs.uniform(2, 40, shape).astype(np.float32))


def write_sceneflow(root, rs, n=2, shape=(H, W)):
    for sub in ("FlyingThings3D/frames_cleanpass/TRAIN/A/0000", "Monkaa/frames_cleanpass/a",
                "Driving/frames_cleanpass/b"):
        for i in range(n):
            for side in ("left", "right"):
                _img(f"{root}/{sub}/{side}/{i:04d}.png", rs, shape + (3,))
            for kind in ("disparity", "raw_cleanpass"):
                _pfm(f"{root}/{sub.replace('frames_cleanpass', kind)}/left/{i:04d}.pfm", rs, shape)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Tiny trees of the seven passive-stereo datasets in their layouts."""
    root = tmp_path_factory.mktemp("stereo")
    rs = np.random.RandomState(0)
    write_sceneflow(f"{root}/SceneFlow", rs)
    write_sceneflow(f"{root}/SceneFlowBig", rs, n=1, shape=(2 * 36, 2 * 64))
    for scene in ("s1", "s2"):
        d = f"{root}/Middlebury/MiddEval3/trainF/{scene}"
        _img(f"{d}/im0.png", rs)
        _img(f"{d}/im1.png", rs)
        _pfm(f"{d}/disp0GT.pfm", rs)
        png.write_png(f"{d}/mask0nocc.png", np.where(rs.rand(H, W) > 0.2, 255, 128)
                      .astype(np.uint8))
        d = f"{root}/ETH3D/two_view_training/{scene}"
        _img(f"{d}/im0.png", rs)
        _img(f"{d}/im1.png", rs)
        _pfm(f"{d}/disp0GT.pfm", rs)
        for side in ("clean_left", "clean_right", "final_left", "final_right"):
            _img(f"{root}/SintelStereo/training/{side}/{scene}/frame_0001.png", rs)
        _img(f"{root}/SintelStereo/training/disparities/{scene}/frame_0001.png", rs, high=16)
        os.makedirs(f"{root}/SintelStereo/training/occlusions/{scene}", exist_ok=True)
        png.write_png(f"{root}/SintelStereo/training/occlusions/{scene}/frame_0001.png",
                      np.where(rs.rand(H, W) > 0.8, 255, 0).astype(np.uint8))
        d = f"{root}/KITTI/training"
        _img(f"{d}/image_2/{scene}_10.png", rs)
        _img(f"{d}/image_3/{scene}_10.png", rs)
        _img(f"{d}/disp_occ_0/{scene}_10.png", rs, (H, W), np.uint16, 40 * 256)
    # FallingThings: JPEG names holding PNG data (PIL opens by content)
    names = []
    for i in range(2):
        d = f"{root}/FallingThings/kitchen_0"
        _img(f"{d}/{i:06d}.left.jpg", rs)
        _img(f"{d}/{i:06d}.right.jpg", rs)
        _img(f"{d}/{i:06d}.left.depth.png", rs, (H, W), np.uint16, 20000)
        names.append(f"kitchen_0/{i:06d}.left.jpg")
    with open(f"{root}/FallingThings/kitchen_0/_camera_settings.json", "w") as f:
        json.dump({"camera_settings": [{"intrinsic_settings": {"fx": 768.2}}]}, f)
    with open(f"{root}/FallingThings/filenames.txt", "w") as f:
        f.write("\n".join(names))
    tnames = []
    for i in range(2):
        base = f"abandonedfactory/Easy/P000/image_left/{i:06d}_left.png"
        _img(f"{root}/{base}", rs)
        _img(f"{root}/{base.replace('_left', '_right')}", rs)
        depth = base.replace("image_left", "depth_left").replace("left.png", "left_depth.npy")
        os.makedirs(os.path.dirname(f"{root}/{depth}"), exist_ok=True)
        np.save(f"{root}/{depth}", rs.uniform(0.5, 20, (H, W)).astype(np.float32))
        tnames.append(base)
    with open(f"{root}/tartanair_filenames.txt", "w") as f:
        f.write("\n".join(tnames + ["seasonsforest_winter/Easy/P000/image_left/x_left.png"]))
    return root


def _camera():
    cam = Realsense.default_sim(min_depth=0.2, max_depth=2.0)
    cam.change_resolution(f"{W}x{H}")
    return cam


def _jax_camera():
    from d3roma_tpu.utils.camera import Realsense as JaxRealsense

    cam = JaxRealsense.default_sim(min_depth=0.2, max_depth=2.0)
    cam.change_resolution(f"{W}x{H}")
    return cam


def _make(mod, name, root, aug_params, camera):
    a = None if aug_params is None else dict(aug_params)
    if name == "SceneFlow":
        return mod.SceneFlow(camera=camera, aug_params=a, root=f"{root}/SceneFlow",
                             resolution=camera.resolution)
    if name == "Middlebury":
        return mod.Middlebury(camera=camera, aug_params=a, root=f"{root}/Middlebury")
    if name == "TartanAir":
        return mod.TartanAir(aug_params=a, root=str(root))
    if name == "KITTIStereo":
        return mod.KITTIStereo(aug_params=a, root=f"{root}/KITTI")
    return getattr(mod, name)(aug_params=a, root=f"{root}/{name}")


def _same_items(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("augmented", [False, True])
@pytest.mark.parametrize("name", ["SceneFlow", "Middlebury", "ETH3D", "SintelStereo",
                                  "FallingThings", "TartanAir", "KITTIStereo"])
def test_stereo_items_match_jax(trees, name, augmented):
    params = dict(AUG, yjitter=name == "SceneFlow") if augmented else None
    ours = _make(D, name, trees, params, _camera())
    ref = _make(JD, name, trees, params, _jax_camera())
    assert len(ours) == len(ref) >= 2
    ours.set_epoch(1)
    ref.set_epoch(1)
    for i in range(len(ref)):
        _same_items(ours[i], ref[i])
    if augmented:
        assert ours[0]["rgb"].shape == (24, 40, 3)


def test_sceneflow_frames_follow_the_camera_resolution(trees):
    """Frames at twice the camera's resolution: the JAX items' frames keep
    their size while the disparity is resized (the batch cannot stack);
    the port's frames come to the disparity's size."""
    from d3roma_tpu.utils.camera import Realsense as JaxRealsense

    cam, jcam = Realsense.default_sim(), JaxRealsense.default_sim()
    cam.change_resolution("64x36")
    jcam.change_resolution("64x36")
    root = f"{trees}/SceneFlowBig"
    ours = D.SceneFlow(camera=cam, root=root, resolution=cam.resolution)
    ref = JD.SceneFlow(camera=jcam, root=root, resolution=jcam.resolution)
    a, b = ours[0], ref[0]
    assert b["rgb"].shape[:2] == (72, 128) and b["disp"].shape[:2] == (36, 64)
    assert a["rgb"].shape[:2] == a["disp"].shape[:2] == (36, 64)
    np.testing.assert_array_equal(a["disp"], b["disp"])
    np.testing.assert_array_equal(
        a["rgb"], cv2.resize(b["rgb"].astype(np.uint8), (64, 36),
                             interpolation=cv2.INTER_LINEAR).astype(np.float32))
    crop = dict(AUG, crop_size=(24, 32))
    ours = D.SceneFlow(camera=cam, aug_params=dict(crop), root=root, resolution=cam.resolution)
    batch = collate([ours[i] for i in range(len(ours))])
    assert batch["rgb"].shape[1:3] == batch["disp"].shape[1:3] == (24, 32)
    ref = JD.SceneFlow(camera=jcam, aug_params=dict(crop), root=root, resolution=jcam.resolution)
    with pytest.raises(ValueError):
        jax_collate([ref[i] for i in range(len(ref))])


def test_real_jpeg_is_refused(tmp_path):
    """JPEGs decode through the port's own decoder (`utils/jpeg.py`, PIL's
    pixels); one outside its scope, here 4:1:1 chroma (a sampling factor of
    4), is refused with an error naming the file and what was found."""
    from d3roma_tpu_torch.utils.frame_utils import read_gen

    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8),
                [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    with pytest.raises(NotImplementedError, match=r"x\.jpg.*sampling factor 4x1"):
        read_gen(path)
