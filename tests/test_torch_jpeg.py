"""The port's image readers without PIL against PIL, bit for bit.

`utils/frame_utils.read_gen` tells PNG, JPEG and binary PPM files apart by
their content and decodes JPEGs with the host decoder `utils/jpeg.py`
(`csrc/jpeg_decode.cpp`, built by g++ at first use) and PPMs with
`utils/netpbm.py`. Every case below is a file written in the test by PIL or
OpenCV (the JAX package's own tests write their JPEGs with cv2.imwrite),
read by `read_gen` and by `np.array(PIL.Image.open(path))`: the arrays must
be equal, shape, dtype and every value (tolerance 0).

Cases: 4:4:4, 4:2:2, 4:4:0 (OpenCV writes it, PIL does not) and 4:2:0;
gray; RGB stored without the YCbCr transform (Adobe marker, transform 0);
baseline and progressive; with and without restart intervals; optimized
Huffman tables; qualities 5, 50 and 95; EXIF, ICC and comment segments;
odd sizes (37x53, 17x33, 1x1, 2x3); binary P5 and P6 at 8 and 16 bits,
full and partial maxval; a PNG named .jpg and a JPEG named .png. Refused kinds raise
NotImplementedError naming what was found (CMYK, arithmetic coding,
12-bit samples, lossless, 4:1:1, a progressive file whose last refinement
scan is missing, which libjpeg would block-smooth); truncated files raise
ValueError.
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from d3roma_tpu_torch.utils import frame_utils, jpeg, native_io, png


def _pixels(h, w, seed, gray=False):
    """Smooth colour gradients with noise: every DCT frequency in use."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / 7 + k) * np.cos(y / 9 - k) for k in range(3)], -1)
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
    return img[..., 1] if gray else img


def _pil(h, w, gray=False, **kw):
    def write(path, seed):
        Image.fromarray(_pixels(h, w, seed, gray)).save(path, "JPEG", **kw)
    return write


def _cv2(h, w, factor=None, gray=False, progressive=0, rst=0, quality=80):
    def write(path, seed):
        params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
        if factor is not None:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
        ok, buf = cv2.imencode(".jpg", _pixels(h, w, seed, gray), params)
        assert ok
        with open(path, "wb") as f:
            f.write(buf.tobytes())
    return write


def _ppm(magic, h, w, maxval):
    def write(path, seed):
        bands = 1 if magic == "P5" else 3
        rng = np.random.default_rng(seed)
        data = rng.integers(0, maxval + 1, (h, w, bands))
        data = data.astype(">u2" if maxval > 255 else np.uint8)
        with open(path, "wb") as f:
            f.write(f"{magic}\n# written by the test\n{w} {h}\n{maxval}\n".encode())
            f.write(data.tobytes())
    return write


def _with_metadata(path, seed):
    """EXIF (APP1), an ICC profile (APP2) and a comment (COM) before the frame."""
    im = Image.fromarray(_pixels(37, 53, seed))
    exif = im.getexif()
    exif[0x0112] = 6  # orientation: decoded as stored, as PIL's open does
    im.save(path, "JPEG", quality=5, exif=exif.tobytes(), icc_profile=b"\0" * 3000,
            comment=b"a comment")


def _png_named_jpg(path, seed):
    png.write_png(path, _pixels(9, 13, seed))


def _jpg_named_png(path, seed):
    Image.fromarray(_pixels(9, 13, seed)).save(path, "JPEG", quality=90)


CASES = {
    # PIL: chroma 4:4:4 (0), 4:2:2 (1), 4:2:0 (2)
    "pil_444_q95": (".jpg", _pil(37, 53, quality=95, subsampling=0)),
    "pil_422_q50": (".jpg", _pil(37, 53, quality=50, subsampling=1)),
    "pil_420_q95": (".jpg", _pil(37, 53, quality=95, subsampling=2)),
    "pil_420_q50_optimized": (".jpg", _pil(37, 53, quality=50, subsampling=2, optimize=True)),
    "pil_444_progressive": (".jpg", _pil(37, 53, quality=50, subsampling=0, progressive=True)),
    "pil_422_progressive": (".jpg", _pil(37, 53, quality=95, subsampling=1, progressive=True)),
    "pil_420_progressive_optimized": (".jpg", _pil(37, 53, quality=95, subsampling=2,
                                                   progressive=True, optimize=True)),
    "pil_420_restart": (".jpg", _pil(17, 33, quality=90, restart_marker_blocks=2)),
    "pil_444_restart_progressive": (".jpg", _pil(17, 33, quality=90, subsampling=0,
                                                 progressive=True, restart_marker_blocks=3)),
    "pil_420_1x1": (".jpg", _pil(1, 1, quality=90)),
    "pil_420_2x3": (".jpg", _pil(2, 3, quality=90)),
    "pil_422_1x1_progressive": (".jpg", _pil(1, 1, quality=90, subsampling=1, progressive=True)),
    "pil_gray": (".jpg", _pil(37, 53, gray=True, quality=50)),
    "pil_gray_progressive": (".jpg", _pil(37, 53, gray=True, quality=95, progressive=True)),
    "pil_gray_1x1": (".jpeg", _pil(1, 1, gray=True, quality=95)),
    # RGB stored without the YCbCr transform (an Adobe marker, transform 0)
    "pil_rgb_adobe": (".jpg", _pil(37, 53, quality=80, keep_rgb=True)),
    "pil_rgb_adobe_progressive": (".jpg", _pil(37, 53, quality=80, keep_rgb=True,
                                               progressive=True)),
    # OpenCV, as the JAX package's tests write JPEGs
    "cv2_default": (".jpg", _cv2(37, 53)),
    "cv2_440": (".jpg", _cv2(37, 53, factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)),
    "cv2_440_progressive": (".jpg", _cv2(37, 53, factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                                         progressive=1)),
    "cv2_440_2x3": (".jpg", _cv2(2, 3, factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)),
    "cv2_422_restart": (".jpg", _cv2(17, 33, factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                                     rst=1, quality=95)),
    "cv2_444_progressive_restart": (".jpg", _cv2(17, 33,
                                                 factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                                                 progressive=1, rst=2)),
    "cv2_gray": (".jpg", _cv2(17, 33, gray=True, quality=50)),
    # binary netpbm, as PIL reads it
    "ppm_p5_255": (".ppm", _ppm("P5", 5, 7, 255)),
    "ppm_p5_100": (".ppm", _ppm("P5", 5, 7, 100)),
    "ppm_p5_65535": (".ppm", _ppm("P5", 5, 7, 65535)),
    "ppm_p5_1000": (".ppm", _ppm("P5", 5, 7, 1000)),
    "ppm_p6_255": (".ppm", _ppm("P6", 5, 7, 255)),
    "ppm_p6_200": (".ppm", _ppm("P6", 5, 7, 200)),
    "ppm_p6_65535": (".ppm", _ppm("P6", 5, 7, 65535)),
    "ppm_p6_4095": (".ppm", _ppm("P6", 5, 7, 4095)),
    "pil_metadata_q5": (".jpg", _with_metadata),
    # PIL tells formats by their content
    "png_named_jpg": (".jpg", _png_named_jpg),
    "jpg_named_png": (".png", _jpg_named_png),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_gen_is_pil_bit_for_bit(tmp_path, case):
    ext, write = CASES[case]
    path = str(tmp_path / f"{case}{ext}")
    write(path, seed=sorted(CASES).index(case))
    ref = np.array(Image.open(path))
    ours = frame_utils.read_gen(path)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def _baseline(**kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_pixels(16, 24, 0)).save(buf, "JPEG", quality=90, **kw)
    return buf.getvalue()


def _patch_sof(data: bytes, marker: int, precision: int = 8) -> bytes:
    """The same file with its frame header's marker (and sample precision)
    replaced: a header of a kind PIL's encoder does not write."""
    at = max(data.find(b"\xff\xc0"), data.find(b"\xff\xc2"))
    out = bytearray(data)
    out[at + 1] = marker
    out[at + 4] = precision
    return bytes(out)


def _without_last_scan(data: bytes) -> bytes:
    """A progressive file whose last scan (a refinement) is cut out."""
    return data[:data.rfind(b"\xff\xda")] + b"\xff\xd9"


def _cmyk() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_pixels(16, 24, 0)).convert("CMYK").save(buf, "JPEG")
    return buf.getvalue()


def _411() -> bytes:
    ok, buf = cv2.imencode(".jpg", _pixels(16, 24, 0), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    return buf.tobytes()


REFUSED = {
    "cmyk": (_cmyk, r"4-component \(CMYK/YCCK\)"),
    "arithmetic_sequential": (lambda: _patch_sof(_baseline(), 0xC9), r"arithmetic-coded.*SOF9"),
    "arithmetic_progressive": (lambda: _patch_sof(_baseline(progressive=True), 0xCA),
                               r"arithmetic-coded.*SOF10"),
    "12_bit": (lambda: _patch_sof(_baseline(), 0xC1, precision=12), r"12-bit samples"),
    "lossless": (lambda: _patch_sof(_baseline(), 0xC3), r"lossless"),
    "sampling_4x1": (_411, r"sampling factor 4x1"),
    "unrefined_progressive": (lambda: _without_last_scan(_baseline(progressive=True)),
                              r"unrefined.*block smoothing"),
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refused_kinds_raise_not_implemented(tmp_path, kind):
    make, pattern = REFUSED[kind]
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(make())
    with pytest.raises(NotImplementedError, match=pattern):
        jpeg.read_jpeg(str(path))
    if kind in ("cmyk", "sampling_4x1", "unrefined_progressive"):
        np.array(Image.open(path))  # files PIL decodes: never skipped, never approximated


@pytest.mark.parametrize("keep", [2, 40, 400, -30, -2])
def test_truncated_file_raises_value_error(tmp_path, keep):
    data = _baseline()
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:keep])
    with pytest.raises(ValueError, match="cut.jpg"):
        jpeg.read_jpeg(str(path))
    with pytest.raises(OSError):
        np.array(Image.open(path))


def test_decoder_builds_once_under_its_hash():
    lib = native_io.library_path(jpeg.SOURCE, ())
    assert lib.name.startswith("libjpeg_decode-") and lib.parent == native_io.BUILD_DIR
    assert native_io.build(jpeg.SOURCE, ()) == lib and lib.exists()


def test_build_failure_raises_with_compiler_output(tmp_path):
    """Where g++ fails, the build raises BuildError carrying its output."""
    bad = tmp_path / "broken_decoder.cpp"
    bad.write_text("int main( {\n")
    with pytest.raises(native_io.BuildError, match="broken_decoder.cpp"):
        native_io.build(bad, ())
    assert not native_io.library_path(bad, ()).exists()
