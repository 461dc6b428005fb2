"""The port's native EXR reader (d3roma_tpu_torch/utils/native_io.py, built
from csrc/d3roma_io.cpp by g++), its hook in utils/frame_utils.py, and
utils/profiling.py and utils/misc.py.

The native decoder is bit-equal to the pure-Python reader (utils/exr.py),
channel order included, on single-channel and 3-channel files with and
without R,G,B names, NONE, ZIPS and ZIP compression, FLOAT and HALF
channels; the batched decode equals the single reads; the native writer's
file reads back exactly through the Python reader. Skipped where there is
no g++, as the JAX package's native tests skip without their library."""

import json
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

from d3roma_tpu_torch.utils import exr, frame_utils, misc, native_io, profiling


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build csrc/d3roma_io.cpp")
    native_io.build()
    assert native_io.available()
    return native_io


def _zip_block(raw: bytes) -> bytes:
    """The EXR ZIP pre-filter (interleave the two halves, byte deltas + 128),
    then zlib: the inverse of utils/exr.py's _unzip_block."""
    data = np.frombuffer(raw, np.uint8)
    half = (data.size + 1) // 2
    t = np.empty_like(data)
    t[:half], t[half:] = data[0::2], data[1::2]
    d = t.astype(np.int16)
    d[1:] = (t[1:].astype(np.int16) - t[:-1].astype(np.int16) + 128) % 256
    return zlib.compress(d.astype(np.uint8).tobytes())


def _write_compressed(path, img, names, types, comp):
    """A scanline EXR with `comp` (2 ZIPS, 3 ZIP), channels `names` (in
    storage order) of pixel `types` (1 HALF, 2 FLOAT)."""
    H, W, C = img.shape
    lines = 16 if comp == 3 else 1
    with open(path, "wb") as f:
        f.write(struct.pack("<II", exr.MAGIC, 2))
        chan = b"".join(n.encode() + b"\x00" + struct.pack("<iiii", t, 0, 1, 1)
                        for n, t in zip(names, types)) + b"\x00"
        exr._write_attr(f, "channels", "chlist", chan)
        exr._write_attr(f, "compression", "compression", bytes([comp]))
        box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
        exr._write_attr(f, "dataWindow", "box2i", box)
        exr._write_attr(f, "displayWindow", "box2i", box)
        exr._write_attr(f, "lineOrder", "lineOrder", b"\x00")
        f.write(b"\x00")
        n_blocks = (H + lines - 1) // lines
        table = f.tell()
        f.write(b"\x00" * 8 * n_blocks)
        offsets = []
        for y in range(0, H, lines):
            raw = b"".join(img[yy, :, c].astype("<f2" if t == 1 else "<f4").tobytes()
                           for yy in range(y, min(H, y + lines))
                           for c, t in enumerate(types))
            data = _zip_block(raw)
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y, len(data)))
            f.write(data)
        f.seek(table)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))


def _files(tmp_path):
    rng = np.random.default_rng(12)
    paths = []
    one = rng.uniform(0, 3, (33, 47)).astype(np.float32)
    paths.append(str(tmp_path / "y.exr"))
    exr.write_exr(paths[-1], one)
    three = rng.uniform(0, 1, (9, 11, 3)).astype(np.float32)
    for names in (None, ["R", "G", "B"], ["U", "V", "W"]):
        paths.append(str(tmp_path / f"c3_{names}.exr"))
        exr.write_exr(paths[-1], three, names)
    for comp in (2, 3):
        for types in ((2,), (1,), (2, 1, 2)):
            img = rng.uniform(0, 4, (37, 21, len(types))).astype(np.float32)
            names = ["Y"] if len(types) == 1 else ["B", "G", "R"]
            paths.append(str(tmp_path / f"z{comp}_{types}.exr"))
            _write_compressed(paths[-1], img, names, types, comp)
    return paths


def test_native_exr_bit_equal_to_python(native, tmp_path):
    paths = _files(tmp_path)
    for p in paths:
        want = exr.read_exr(p)
        got = native.read_exr(p)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, p
        np.testing.assert_array_equal(got, want, err_msg=p)
    # the ZIP files decode to what was written (HALF rounded once)
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 4, (20, 17, 1)).astype(np.float32)
    _write_compressed(str(tmp_path / "check.exr"), img, ["Y"], (2,), 3)
    np.testing.assert_array_equal(exr.read_exr(str(tmp_path / "check.exr")), img[..., 0])


def test_native_exr_batch_and_writer(native, tmp_path):
    rng = np.random.default_rng(13)
    imgs = [rng.uniform(0, 2, (20, 30)).astype(np.float32) for _ in range(6)]
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(tmp_path / f"b{i}.exr"))
        native.write_exr(paths[-1], img)
        np.testing.assert_array_equal(exr.read_exr(paths[-1]), img)
    out, status = native.read_exr_batch(paths, num_threads=3)
    assert (status > 0).all()
    np.testing.assert_array_equal(out, np.stack(imgs))
    rgb = rng.uniform(0, 1, (9, 11, 3)).astype(np.float32)
    rgb_paths = []
    for i in range(3):
        rgb_paths.append(str(tmp_path / f"rgb{i}.exr"))
        exr.write_exr(rgb_paths[-1], rgb, ["R", "G", "B"])
    out, status = native.read_exr_batch(rgb_paths)
    assert (status > 0).all()
    np.testing.assert_array_equal(out, np.stack([exr.read_exr(p) for p in rgb_paths]))
    with pytest.raises(ValueError, match="single-channel"):
        native.write_exr(str(tmp_path / "bad.exr"), rgb)


def test_frame_utils_reads_exr_natively(native, tmp_path, monkeypatch):
    img = np.random.default_rng(11).uniform(0.2, 2.0, (12, 16)).astype(np.float32)
    p = str(tmp_path / "d.exr")
    exr.write_exr(p, img)
    calls = []
    read = native.read_exr
    monkeypatch.setattr(native_io, "read_exr", lambda path: calls.append(path) or read(path))
    np.testing.assert_array_equal(np.asarray(frame_utils.read_gen(p)), img)
    assert calls == [p]
    # a file the native decoder refuses falls back to the Python reader
    monkeypatch.setattr(native_io, "read_exr",
                        lambda path: (_ for _ in ()).throw(NotImplementedError(path)))
    np.testing.assert_array_equal(np.asarray(frame_utils.read_gen(p)), img)


def test_native_library_is_keyed_by_its_source(native):
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.name.startswith("libd3roma_io-") and path.suffix == ".so"
    assert native.build() == path  # a current build is not rebuilt


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(d, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_step_timer():
    timer = profiling.StepTimer()
    for _ in range(3):
        out = {}
        with timer.phase("step", block_on=out):
            out["x"] = torch.ones(4) * 2
    with timer.phase("other"):
        pass
    s = timer.summary()
    assert set(s) == {"step", "other"} and timer.counts["step"] == 3
    assert all(v >= 0 for v in s.values())
    timer.log()


def test_misc():
    misc.seed_everything(7)
    a = np.random.rand()
    misc.seed_everything(7)
    assert np.random.rand() == a
    d = misc.flatten({"disp": {"epe": torch.tensor(1.0), "d1": 0.5}, "n": 2})
    assert d == {"disp_epe": 1.0, "disp_d1": 0.5, "n": 2}
    assert json.loads(misc.pretty_json({"epe": np.float32(1.5)})) == {"epe": 1.5}
