"""The evaluation slice's host side against the libraries and the JAX
package it stands in for: `utils/yaml_lite.py` against `yaml.safe_load`
(every file under conf/, override strings) and the port's presets against
the JAX ones; `utils/png.py` against cv2 and PIL (8-bit gray, RGB, RGBA,
16-bit gray, every row filter, both ways); `utils/resize.py` against
`cv2.resize`; the procedural renderer, the HISS, Dreds and Real datasets,
`collate`, the DataLoader and `device_preprocess` against the JAX package.

Tolerances: bit-equal for YAML, presets, PNG, nearest resize, uint8
bilinear resize, procedural frames and dataset items; float bilinear
resize within 1e-6 of max |ref| (OpenCV's float path and numpy round the
two float32 products and their sum in another order); device_preprocess
within 1e-6 of max |ref| (XLA's and PyTorch's elementwise float32 ops)."""

import glob
import os
import struct
import zlib
from functools import partial

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from d3roma_tpu import config as jax_config
from d3roma_tpu.data import DataLoader as JaxDataLoader
from d3roma_tpu.data import collate as jax_collate
from d3roma_tpu.data import create_dataset as jax_create_dataset
from d3roma_tpu.data import device_preprocess as jax_device_preprocess
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.synthetic import procedural as jax_procedural
from d3roma_tpu.utils.exr import write_exr as jax_write_exr
from d3roma_tpu_torch import config as port_config
from d3roma_tpu_torch.data import DataLoader, collate, create_dataset, device_preprocess
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.synthetic import procedural
from d3roma_tpu_torch.utils import png, yaml_lite
from d3roma_tpu_torch.utils.exr import read_exr
from d3roma_tpu_torch.utils.resize import INTER_LINEAR, INTER_NEAREST, resize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF_FILES = sorted(os.path.relpath(p, REPO)
                    for p in glob.glob(os.path.join(REPO, "conf", "**", "*.yaml"), recursive=True))
PRESETS = sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(REPO, "conf", "task",
                                                                         "*.yaml")))
FRAME = procedural.SceneConfig(height=36, width=64)  # 16:9, as the sim camera


# ---------------------------------------------------------------- YAML, config

@pytest.mark.parametrize("path", CONF_FILES)
def test_yaml_lite_equals_safe_load_on_conf(path):
    with open(os.path.join(REPO, path)) as f:
        ref = yaml.safe_load(f)
    assert yaml_lite.load_file(os.path.join(REPO, path)) == ref


OVERRIDES = ["[HISS]", "1e-4", "3.0e-05", "true", "null", '"a b"', "480x270", "[1, 2]",
             "2e-4", "~", "", "False", "off", "0x1F", "0755", "1_000", ".5", "-.inf",
             "[a, 'b c', 1.5]", "'it''s'", "x: 1", "- a", "[]", "foo#bar", "1.", "+3"]


def test_yaml_lite_equals_safe_load_on_overrides():
    for text in OVERRIDES:
        got, ref = yaml_lite.loads(text), yaml.safe_load(text)
        assert got == ref and type(got) is type(ref), (text, got, ref)
    for text in ("{a: 1}", "[[1], 2]", "&x 1", "!!str 1", "a: |", "--- 1", "2020-01-01",
                 "\tx: 1", "a:\n- b: 1"):
        with pytest.raises(yaml_lite.YamlError):
            yaml_lite.loads(text)


@pytest.mark.parametrize("name", PRESETS)
def test_task_preset_matches_jax(name):
    ours = port_config.config_to_dict(port_config.load_task_preset(name))
    ref = jax_config.config_to_dict(jax_config.load_task_preset(name))
    assert ours == ref
    for k in ref:
        assert type(ours[k]) is type(ref[k]), k


def test_compose_overrides_match_jax():
    argv = ["task=eval_ldm_mixed_rgb+raw", "task.eval_dataset=[HISS]", "task.learning_rate=2e-4",
            "task.eval_batch_size=2", "task.ensemble=true", "task.tag=a b", "seed=3",
            "task.fast_inference=latency", "task.camera_resolution=480x270"]
    ours, ref = port_config.compose(argv), jax_config.compose(argv)
    assert port_config.config_to_dict(ours) == jax_config.config_to_dict(ref)
    assert ours.task.learning_rate == 2e-4 and ours.seed == 3


# ------------------------------------------------------------------------- PNG

def _image(kind, h=23, w=37, seed=0):
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    smooth = (np.sin(x / 5.0) + np.cos(y / 3.0) + 2) / 4
    ch = {"gray8": 0, "rgb8": 3, "rgba8": 4, "gray16": 0, "rgb16": 3}[kind]
    hi = 65535 if kind.endswith("16") else 255
    base = smooth[..., None] * np.linspace(0.4, 1.0, ch) if ch else smooth
    img = base * (hi - 40) + rs.randint(0, 40, base.shape)
    return img.astype(np.uint16 if hi > 255 else np.uint8)


CV2_FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE, "sub": cv2.IMWRITE_PNG_FILTER_SUB,
               "up": cv2.IMWRITE_PNG_FILTER_UP, "avg": cv2.IMWRITE_PNG_FILTER_AVG,
               "paeth": cv2.IMWRITE_PNG_FILTER_PAETH, "adaptive": cv2.IMWRITE_PNG_ALL_FILTERS}


def _rgb_order(cv_img):
    """cv2's BGR(A) as the file's RGB(A)."""
    if cv_img.ndim == 2:
        return cv_img
    return cv_img[..., [2, 1, 0, 3][: cv_img.shape[2]]]


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16"])
def test_png_decodes_cv2_and_pil_files(kind, tmp_path):
    img = _image(kind)
    seen = set()
    for name, flag in CV2_FILTERS.items():
        path = str(tmp_path / f"{name}.png")
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, flag])
        with open(path, "rb") as f:
            seen |= set(png.row_filters(f.read()).tolist())
        got = png.read_png(path)
        ref = _rgb_order(cv2.imread(path, cv2.IMREAD_UNCHANGED))
        assert got.dtype == ref.dtype and np.array_equal(got, ref), name
        assert np.array_equal(got, np.array(Image.open(path))), name
    assert seen == {0, 1, 2, 3, 4}  # cv2 wrote every row filter
    if kind != "gray16":  # PIL's own encoder (its adaptive filters)
        path = str(tmp_path / "pil.png")
        Image.fromarray(img).save(path)
        assert np.array_equal(png.read_png(path), img)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16", "rgb16"])
def test_png_written_by_the_port_decodes_in_cv2_and_pil(kind, tmp_path):
    img = _image(kind, seed=1)
    for filt in range(5):
        path = str(tmp_path / f"f{filt}.png")
        png.write_png(path, img, filt)
        with open(path, "rb") as f:
            assert set(png.row_filters(f.read()).tolist()) == {filt}
        assert np.array_equal(_rgb_order(cv2.imread(path, cv2.IMREAD_UNCHANGED)), img), filt
        if kind != "rgb16":  # PIL reads 16-bit RGB as 8-bit
            assert np.array_equal(np.array(Image.open(path)), img), filt
        assert np.array_equal(png.read_png(path), img)


def _with_ihdr(data: bytes, **fields) -> bytes:
    """A PNG's bytes with IHDR fields replaced (CRC recomputed)."""
    names = ("width", "height", "depth", "ctype", "compression", "filter", "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    vals.update(fields)
    body = struct.pack(">IIBBBBB", *(vals[n] for n in names))
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    return data[:16] + body + crc + data[33:]


def test_png_refuses_palette_and_interlaced(tmp_path):
    path = str(tmp_path / "p.png")
    Image.fromarray(_image("gray8")).convert("P").save(path)
    with pytest.raises(png.PngError, match="palette"):
        png.read_png(path)
    data = png.encode_png(_image("gray8"))
    with pytest.raises(png.PngError, match="interlaced"):
        png.decode_png(_with_ihdr(data, interlace=1))
    with pytest.raises(png.PngError, match="bit depth"):
        png.decode_png(_with_ihdr(data, depth=4))
    with pytest.raises(png.PngError, match="CRC"):
        png.decode_png(data[:20] + bytes([data[20] ^ 1]) + data[21:])


# ---------------------------------------------------------------------- resize

RESIZES = [((360, 640), (480, 270)), ((36, 64), (100, 75)), ((37, 53), (23, 19)),
           ((7, 9), (31, 29)), ((48, 64), (13, 47)), ((360, 640), (333, 201))]


@pytest.mark.parametrize("src,dsize", RESIZES)
def test_resize_matches_cv2(src, dsize):
    rs = np.random.RandomState(sum(src) + sum(dsize))
    h, w = src
    for shape in ((h, w), (h, w, 3)):
        u8 = rs.randint(0, 256, shape).astype(np.uint8)
        for arr in (u8, rs.randint(-5000, 5000, shape).astype(np.int32),
                    rs.randn(*shape).astype(np.float32)):
            got = resize(arr, dsize, INTER_NEAREST)
            assert got.dtype == arr.dtype
            assert np.array_equal(got, cv2.resize(arr, dsize, interpolation=cv2.INTER_NEAREST))
        assert np.array_equal(resize(u8, dsize, INTER_LINEAR),
                              cv2.resize(u8, dsize, interpolation=cv2.INTER_LINEAR))
        f32 = rs.randn(*shape).astype(np.float32) * 3
        ref = cv2.resize(f32, dsize, interpolation=cv2.INTER_LINEAR)
        got = resize(f32, dsize, INTER_LINEAR)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


# -------------------------------------------------------- procedural, datasets

def test_procedural_frames_match_jax(tmp_path):
    jax_frames = jax_procedural.ProceduralSceneRenderer(
        jax_procedural.SceneConfig(height=36, width=64), 5)
    port_frames = procedural.ProceduralSceneRenderer(FRAME, 5)
    for _ in range(2):
        a, b = port_frames.render(), jax_frames.render()
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k], b[k]) and np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
    for gen, name in ((procedural, "port"), (jax_procedural, "jax")):
        gen.generate_dataset(str(tmp_path / name / "HISS"), 2, split="test",
                             config=gen.SceneConfig(height=36, width=64), seed=2)
        gen.generate_real_capture(str(tmp_path / name / "Real"), num_frames=1, seed=3)
        gen.generate_example_assets(str(tmp_path / name / "ex"), seed=4)
    files = sorted(os.path.relpath(p, tmp_path / "jax")
                   for p in glob.glob(str(tmp_path / "jax" / "**" / "*.*"), recursive=True))
    assert len(files) == 10 + 5 + 4
    for rel in files:
        a, b = str(tmp_path / "port" / rel), str(tmp_path / "jax" / rel)
        if rel.endswith(".png"):
            ref = cv2.imread(b, cv2.IMREAD_UNCHANGED)
            assert np.array_equal(cv2.imread(a, cv2.IMREAD_UNCHANGED), ref), rel
            assert np.array_equal(png.read_png(b), _rgb_order(ref)), rel
        elif rel.endswith(".exr"):
            assert np.array_equal(read_exr(a), read_exr(b)), rel
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read().replace("d3roma_tpu_torch", "d3roma_tpu") == fb.read(), rel


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Small frames in the HISS, DREDS and Real layouts under one
    datasets/ root, written by cv2 where the JAX package's writers use it."""
    root = tmp_path_factory.mktemp("eval_data")
    ds = root / "datasets"
    procedural.generate_dataset(str(ds / "HISS"), 3, split="test", config=FRAME, seed=7)
    renderer = procedural.ProceduralSceneRenderer(FRAME, 8)
    for i in range(2):
        fr = renderer.render()
        d = ds / "DREDS" / "test" / "scene"
        d.mkdir(parents=True, exist_ok=True)
        p = str(d / f"{i:04d}")
        cv2.imwrite(p + "_color.png", cv2.cvtColor(fr["rgb"], cv2.COLOR_RGB2BGR))
        cv2.imwrite(p + "_ir_l.png", fr["ir_l"])
        cv2.imwrite(p + "_ir_r.png", fr["ir_r"])
        jax_write_exr(p + "_gt_depth.exr", fr["depth"])
        jax_write_exr(p + "_simDepthImage.exr", fr["sim_depth"])
    jax_procedural.generate_real_capture(str(ds / "Real"), scene="xiaomeng", num_frames=2, seed=9)
    return root


def _same_items(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], (str, list)):
            assert a[k] == b[k], k
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6 * max(np.abs(y).max(), 1), err_msg=k)


@pytest.mark.parametrize("name", ["HISS", "Dreds", "Real_xiaomeng_fxm"])
def test_dataset_items_match_jax(trees, name, monkeypatch):
    monkeypatch.chdir(trees)
    port_cfg = port_config.load_task_preset("eval_ldm_mixed_rgb+raw")
    jax_cfg = jax_config.load_task_preset("eval_ldm_mixed_rgb+raw")
    ours = create_dataset(port_cfg, name, port_cfg.eval_split)
    ref = jax_create_dataset(jax_cfg, name, jax_cfg.eval_split)
    assert len(ours) == len(ref) >= 2
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a["rgb"].shape == (270, 480, 3)  # resized to the preset's 480x270
        _same_items(a, b)


def test_training_slice_datasets_raise(trees, monkeypatch):
    """The mono sets build since the mono slice ported them, as the
    passive-stereo ones of the training slice do (with no frames here,
    empty; `KITTI` is the mono reader, `KITTIStereo` the stereo one); a name
    that is no dataset raises."""
    monkeypatch.chdir(trees)
    cfg = port_config.load_task_preset("eval_ldm_mixed_rgb+raw")
    for name in ("NYUv2", "KITTI", "HRWSI", "SceneFlow", "KITTIStereo"):
        assert len(create_dataset(cfg, name, "test")) == 0
    assert type(create_dataset(cfg, "KITTI", "test")).__name__ == "KITTI"
    with pytest.raises(ValueError, match="unknown dataset"):
        create_dataset(cfg, "NYUv3", "test")


class _Failing:
    def __init__(self, base, bad):
        self.base, self.bad = base, bad

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        if i == self.bad:
            raise RuntimeError(f"broken item {i}")
        return self.base[i]


def test_collate_and_loader_match_jax(trees, monkeypatch):
    monkeypatch.chdir(trees)
    cfg = port_config.load_task_preset("eval_ldm_mixed_rgb+raw")
    ds = create_dataset(cfg, "HISS", "test")
    items = [ds[i] for i in range(len(ds))]
    _same_items(collate(items), jax_collate(items))
    ours = list(DataLoader(ds, 2, shuffle=False, drop_last=False, num_workers=3))
    ref = list(JaxDataLoader(ds, 2, shuffle=False, drop_last=False, num_workers=3))
    assert [b["index"].tolist() for b in ours] == [b["index"].tolist() for b in ref] == [[0, 1], [2]]
    for a, b in zip(ours, ref):
        _same_items(a, b)
    shuffled = DataLoader(ds, 1, shuffle=True, seed=3, num_workers=2)
    jax_shuffled = JaxDataLoader(ds, 1, shuffle=True, seed=3, num_workers=2)
    assert [b["index"].tolist() for b in shuffled] == [b["index"].tolist() for b in jax_shuffled]
    for loader in (DataLoader, JaxDataLoader):
        with pytest.raises(RuntimeError, match="broken item 1"):
            list(loader(_Failing(ds, 1), 1, num_workers=2))


@pytest.mark.parametrize("space,ssi", [("disp", False), ("depth", False), ("disp", True)])
def test_device_preprocess_matches_jax(trees, monkeypatch, space, ssi):
    monkeypatch.chdir(trees)
    cfg = port_config.load_task_preset("eval_ldm_mixed_rgb+raw")
    raw = collate([create_dataset(cfg, "HISS", "test")[i] for i in range(2)])
    arrays = {k: v for k, v in raw.items() if not isinstance(v, list)}
    kw = dict(ssi=ssi, mode="average", num_chs=1, ch_bounds=(8.0,), ch_gammas=(1.0,),
              low_p=0.02 if ssi else 0.0)
    ref = jax_device_preprocess({k: jnp.asarray(v) for k, v in arrays.items()},
                                JaxNormalizer(**kw), space)
    ours = device_preprocess({k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()},
                             Normalizer(**kw), space)
    assert set(ours) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        got = ours[k].numpy()
        assert got.shape == r.shape, k
        np.testing.assert_allclose(got, r, rtol=0, atol=1e-6 * max(np.abs(r).max(), 1), err_msg=k)
