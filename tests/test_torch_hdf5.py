"""`utils/hdf5.py` (numpy and zlib only) against h5py, exactly.

Every case is a file h5py writes in the test with its default format
(libver "earliest": superblock 0, version-1 object headers, symbol-table
groups, layout message 3); `read_dataset(path, name)` must return
`np.asarray(h5py.File(path)[name])`: dtype (byte order included), shape
and every value equal (tolerance 0). Storage: contiguous, compact,
chunked, chunked with gzip, shuffle + gzip + fletcher32, ragged last
chunks, chunks never written (the fill value message's value, or 0), and a
chunk B-tree of more than one level; dtypes uint8, uint16, int16, float16,
float32, float64 in both byte orders; nested groups and names with `/`; a
group with more than one B-tree node; an object header continued in a
second block. A `libver="latest"` file, an lzf-filtered dataset, a string
dataset and a damaged fletcher32 chunk are refused, each naming what it
found.
"""

import h5py
import numpy as np
import pytest

from d3roma_tpu_torch.utils import hdf5

DTYPES = ["|u1", "<u2", ">u2", "<i2", ">i2", "<f2", ">f2", "<f4", ">f4", "<f8", ">f8", "<i8"]


def _data(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.normal(0, 100, shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(max(info.min, -30000), min(info.max, 60000), shape).astype(dt)


def _compact(f, name, data):
    space = h5py.h5s.create_simple(data.shape)
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    tid = h5py.h5t.py_create(data.dtype)
    parent, leaf = name.rsplit("/", 1)
    dsid = h5py.h5d.create(f.require_group(parent).id, leaf.encode(), tid, space, dcpl=dcpl)
    dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, data)


def _partial(f, name, data, fill):
    d = f.create_dataset(name, shape=data.shape, dtype=data.dtype, chunks=(4, 4),
                         **({} if fill is None else dict(fillvalue=fill)))
    d[1:6, 2:7] = data[1:6, 2:7]  # four chunks written, the rest never


STORAGE = {
    "contiguous": lambda f, n, d: f.create_dataset(n, data=d),
    "compact": _compact,
    "chunked": lambda f, n, d: f.create_dataset(n, data=d, chunks=(4, 3)),
    "chunked_gzip": lambda f, n, d: f.create_dataset(n, data=d, chunks=(5, 4),
                                                     compression="gzip"),
    "shuffle_gzip_fletcher32": lambda f, n, d: f.create_dataset(
        n, data=d, chunks=(3, 5), compression="gzip", shuffle=True, fletcher32=True),
    "fletcher32_only": lambda f, n, d: f.create_dataset(n, data=d, chunks=(4, 4),
                                                        fletcher32=True),
    "partial_fill_value": lambda f, n, d: _partial(f, n, d, fill=7),
    "partial_default_fill": lambda f, n, d: _partial(f, n, d, fill=None),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("storage", sorted(STORAGE))
def test_dataset_equals_h5py(tmp_path, storage, dtype):
    path = str(tmp_path / "x.h5")
    data = _data((11, 13), dtype, seed=len(storage) + DTYPES.index(dtype))  # ragged chunks
    with h5py.File(path, "w") as f:
        STORAGE[storage](f, "group/sub/data", data)
    with h5py.File(path, "r") as f:
        ref = np.asarray(f["group/sub/data"])
    ours = hdf5.read_dataset(path, "group/sub/data")
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def _btree_level(f: hdf5.File, header: int, chunked: bool = False) -> int:
    """The root level of a group's (or a chunked dataset's) B-tree."""
    for mtype, _, body in f._messages(header):
        if mtype == (0x0008 if chunked else 0x0011):
            addr = f._addr_in(body, 3 if chunked else 0)
            return f._bytes(addr, 8)[5]
    raise AssertionError("no B-tree")


def test_structures_equal_h5py(tmp_path):
    """Many datasets in one group (a group B-tree of two levels), a chunk
    B-tree of two levels, an object header with a continuation block, a
    scalar, 1-D and 3-D shapes, every name found by its path."""
    path = str(tmp_path / "s.h5")
    with h5py.File(path, "w") as f:
        for i in range(300):
            f[f"many/d{i:03d}"] = np.int64(i * 7)
        f.create_dataset("deep/a/b/c/chunks", data=_data((90, 80), "<u2", 1), chunks=(5, 5),
                         compression="gzip", shuffle=True)
        d = f.create_dataset("continued", data=_data((6, 5, 4), "<f4", 2))
        for i in range(60):
            d.attrs[f"attribute_{i}"] = np.arange(20)
        f["scalar"] = np.float32(2.5)
        f["line"] = np.arange(17, dtype=np.int16)
    port = hdf5.File(path)
    assert _btree_level(port, port._lookup("many")) >= 1
    assert _btree_level(port, port._lookup("deep/a/b/c/chunks"), chunked=True) >= 1
    assert any(t == 0x0010 for t, _, _ in port._messages(port._lookup("continued")))
    with h5py.File(path, "r") as f:
        names = []
        f.visititems(lambda n, o: names.append(n) if isinstance(o, h5py.Dataset) else None)
        assert len(names) == 304
        for name in names:
            ref = np.asarray(f[name])
            ours = port[name]
            assert ours.dtype == ref.dtype and ours.shape == ref.shape, name
            np.testing.assert_array_equal(ours, ref, err_msg=name)
    assert sorted(port.keys()) == ["continued", "deep", "line", "many", "scalar"]
    with pytest.raises(KeyError, match="deep/a/nothing"):
        port["deep/a/nothing"]


def _latest(path):
    with h5py.File(path, "w", libver="latest") as f:
        f["x"] = np.arange(4)


def _lzf(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(100), chunks=(10,), compression="lzf")


def _string(path):
    with h5py.File(path, "w") as f:
        f["x"] = np.array([b"abc", b"de"])


REFUSED = {"latest": (_latest, r"superblock version 3 \(libver \"latest\"\)"),
           "lzf": (_lzf, r"filter 32000 \(lzf\)"),
           "string": (_string, r"string datatype")}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refused_features_are_named(tmp_path, kind):
    write, pattern = REFUSED[kind]
    path = str(tmp_path / f"{kind}.h5")
    write(path)
    with pytest.raises(NotImplementedError, match=pattern):
        hdf5.read_dataset(path, "x")


def test_damaged_fletcher32_chunk_raises(tmp_path):
    path = tmp_path / "f.h5"
    data = np.arange(64, dtype=np.float32).reshape(8, 8)
    with h5py.File(path, "w") as f:
        d = f.create_dataset("x", data=data, chunks=(8, 8), fletcher32=True)
        offset = d.id.get_chunk_info(0).byte_offset
    raw = bytearray(path.read_bytes())
    raw[offset + 5] ^= 0x10
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="fletcher32 checksum mismatch"):
        hdf5.read_dataset(str(path), "x")
