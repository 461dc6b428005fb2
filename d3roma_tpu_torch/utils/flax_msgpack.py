"""Read and write `params.msgpack`, the parameter files of the JAX package's
pipeline directories, without the msgpack package.

`flax.serialization.to_bytes` writes a parameter tree as msgpack: nested
maps with str keys whose leaves are msgpack ext values, type 1 for an
ndarray and type 3 for a numpy scalar, each holding a msgpack array
(shape, dtype name, raw C-order bytes). A leaf of more than
`MAX_CHUNK_SIZE` bytes is written as a map {"__msgpack_chunked_array__":
True, "shape": {"0": d0, ...}, "chunks": {"0": flat piece, ...}}. This
module decodes and encodes that subset of msgpack in plain Python.

Leaves come back as CPU torch tensors: `bfloat16` (which numpy lacks) is
read as uint16 and viewed as torch.bfloat16. The writer takes torch tensors
or numpy arrays.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE, bytes
_CHUNKED = "__msgpack_chunked_array__"

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}  # str
        if b in lengths:
            return str(self.take(self.unpack(lengths[b])), "utf-8")
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        lengths = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext
        if b in lengths:
            return self.ext(self.unpack(lengths[b]))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not a flax array")
        inner = _Reader(payload)
        shape, name, buf = inner.value()
        name = name.decode() if isinstance(name, bytes) else name
        return _tensor(tuple(shape), name, buf)


def _tensor(shape: Tuple[int, ...], name: str, buf: bytes) -> torch.Tensor:
    if name == "bfloat16":
        arr = np.frombuffer(buf, dtype=np.uint16).copy()
        return torch.from_numpy(arr).view(torch.bfloat16).reshape(shape)
    if name not in _TORCH_DTYPES:
        raise ValueError(f"array dtype {name!r} is not supported")
    arr = np.frombuffer(buf, dtype=np.dtype(name)).copy()
    return torch.from_numpy(arr).reshape(shape)


def _unchunk(tree: Any, path: str = "") -> Any:
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if not all(isinstance(c, torch.Tensor) for c in chunks):
            raise ValueError(f"chunked leaf {path or '/'} holds a non-array chunk")
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v, f"{path}/{k}") for k, v in tree.items()}


def loads(data: bytes) -> Any:
    """Decode `flax.serialization.to_bytes` output: nested dicts with CPU
    torch tensor leaves (chunked leaves joined)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack value")
    return _unchunk(tree)


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return loads(f.read())


def _pack_int(out: bytearray, n: int) -> None:
    if 0 <= n <= 0x7F:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for mark, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if n <= limit:
                out.append(mark)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"integer {n} too large for msgpack")
    else:
        for mark, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                 (0xD2, ">i", -0x80000000), (0xD3, ">q", -2**63)):
            if n >= limit:
                out.append(mark)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"integer {n} too small for msgpack")


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    if len(b) < 32:
        out.append(0xA0 | len(b))
    elif len(b) <= 0xFF:
        out += bytes((0xD9, len(b)))
    elif len(b) <= 0xFFFF:
        out.append(0xDA)
        out += struct.pack(">H", len(b))
    else:
        out.append(0xDB)
        out += struct.pack(">I", len(b))
    out += b


def _pack_bin(out: bytearray, b: bytes) -> None:
    for mark, fmt, limit in ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                             (0xC6, ">I", 0xFFFFFFFF)):
        if len(b) <= limit:
            out.append(mark)
            out += struct.pack(fmt, len(b))
            out += b
            return
    raise ValueError("binary value too large for msgpack")


def _pack_header(out: bytearray, n: int, fix: int, m16: int, m32: int) -> None:
    if n < 16:
        out.append(fix | n)
    elif n <= 0xFFFF:
        out.append(m16)
        out += struct.pack(">H", n)
    else:
        out.append(m32)
        out += struct.pack(">I", n)


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    if n in fixext:
        out.append(fixext[n])
    elif n <= 0xFF:
        out += bytes((0xC7, n))
    elif n <= 0xFFFF:
        out.append(0xC8)
        out += struct.pack(">H", n)
    else:
        out.append(0xC9)
        out += struct.pack(">I", n)
    out += struct.pack(">b", code)
    out += payload


def _array_bytes(x) -> Tuple[Tuple[int, ...], str, bytes]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        x = t.numpy()
    x = np.asarray(x)  # not ascontiguousarray, which makes a 0-d array 1-d
    return tuple(x.shape), x.dtype.name, x.tobytes("C")


def _pack_leaf(out: bytearray, x) -> None:
    shape, name, buf = _array_bytes(x)
    inner = bytearray()
    _pack_header(inner, 3, 0x90, 0xDC, 0xDD)
    _pack_header(inner, len(shape), 0x90, 0xDC, 0xDD)
    for d in shape:
        _pack_int(inner, int(d))
    _pack_str(inner, name)
    _pack_bin(inner, buf)
    _pack_ext(out, EXT_NDARRAY, bytes(inner))


def _chunked(x) -> Dict[str, Any]:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, order="C"))
    flat = t.detach().cpu().contiguous().reshape(-1)
    step = max(1, MAX_CHUNK_SIZE // flat.element_size())
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(t.shape)},
            "chunks": {str(i): flat[s:s + step] for i, s in enumerate(range(0, flat.numel(),
                                                                          step))}}


def _pack(out: bytearray, v: Any) -> None:
    if isinstance(v, Mapping):
        _pack_header(out, len(v), 0x80, 0xDE, 0xDF)
        for k, item in v.items():
            _pack_str(out, str(k))
            _pack(out, _maybe_chunk(item))
    elif isinstance(v, (torch.Tensor, np.ndarray)):
        _pack_leaf(out, v)
    elif isinstance(v, bool):
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        _pack_str(out, v)
    elif v is None:
        out.append(0xC0)
    else:
        raise TypeError(f"cannot pack {type(v).__name__} as a flax msgpack value")


def _maybe_chunk(v: Any) -> Any:
    if isinstance(v, torch.Tensor) and v.numel() * v.element_size() > MAX_CHUNK_SIZE:
        return _chunked(v)
    if isinstance(v, np.ndarray) and v.nbytes > MAX_CHUNK_SIZE:
        return _chunked(v)
    return v


def dumps(tree: Mapping) -> bytes:
    """Encode a nested dict of arrays (torch tensors or numpy arrays) as
    `flax.serialization.to_bytes` does, so that `msgpack_restore` reads it."""
    out = bytearray()
    _pack(out, _maybe_chunk(tree))
    return bytes(out)


def dump(tree: Mapping, path: str) -> None:
    with open(path, "wb") as f:
        f.write(dumps(tree))
