"""Read datasets of HDF5 files without h5py: numpy and the standard library.

The machine with the card has no h5py, and the NYUv2 and HyperSim depth
files are HDF5 (`data/mono_datasets.py`). `read_dataset(path, name)`
returns `np.asarray(h5py.File(path)[name])`: the same values, shape and
dtype, the file's byte order kept, as h5py returns them. `File(path)`
gives the same through `f[name]` for code that reads several datasets.

What it reads is what h5py writes by default (libver "earliest"), after
the HDF5 File Format Specification 3.0:

- superblock version 0 or 1;
- version-1 object headers, with continuation messages;
- symbol-table groups (version-1 group B-trees, local heaps, SNOD nodes),
  nested, names with `/`;
- dataspace messages 1 and 2 (scalar and simple);
- datatypes: fixed-point (signed or unsigned, 1-8 bytes, either byte
  order) and IEEE floats of 2, 4 and 8 bytes;
- data layout message 3: compact, contiguous, and chunked through the
  version-1 chunk B-tree; chunks never written take the fill value
  message's value, or 0;
- the filters deflate, shuffle and fletcher32 (the checksum is checked,
  in both of the byte orders HDF5 accepts).

Anything else raises NotImplementedError naming what was found:
superblock versions 2 and 3 and version-2 object headers (libver
"latest"), link messages (new-style groups), layout version 4 chunk
indexes, other filters (szip, lzf, scale-offset, n-bit, ...), shared or
committed datatypes, compound, string, reference, enum, array and
variable-length types. A malformed file raises ValueError.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["File", "read_dataset"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 32000: "lzf", 32001: "blosc", 32004: "lz4",
                 32008: "bitshuffle", 32015: "zstd"}
_CLASS_NAMES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum", 9: "variable-length", 10: "array"}
_MSG_NAMES = {0x0002: "a link info message (new-style group)",
              0x0006: "a link message (new-style group)",
              0x000A: "a group info message (new-style group)",
              0x0015: "an attribute info message (new-style object header)"}


def _fletcher32(data: bytes) -> int:
    """H5_checksum_fletcher32: big-endian 16-bit words, reduced every 360."""
    n = len(data) // 2
    words = np.frombuffer(data[: 2 * n], ">u2").astype(np.uint64)
    sum1 = sum2 = 0
    for start in range(0, n, 360):
        w = words[start: start + 360]
        t = w.size
        # sum2 gains sum1 after each word: t * sum1 + sum_k (t - k) * w_k
        sum2 += t * sum1 + int((w * np.arange(t, 0, -1, dtype=np.uint64)).sum())
        sum1 += int(w.sum())
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if len(data) % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return ((sum2 << 16) | sum1) & 0xFFFFFFFF


class _Dataset:
    """What the object header of a dataset says."""

    def __init__(self):
        self.shape: Optional[Tuple[int, ...]] = None
        self.dtype: Optional[np.dtype] = None
        self.layout: Optional[tuple] = None
        self.filters: List[Tuple[int, Tuple[int, ...]]] = []
        self.fill: Optional[bytes] = None


class File:
    """A read-only HDF5 file: `File(path)[name]` is h5py's array.

    Usable as a context manager, as h5py.File is; the file is read into
    memory once, on open.
    """

    def __init__(self, path):
        self.path = str(path)
        with open(self.path, "rb") as f:
            self._d = f.read()
        self._root = self._superblock()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    # ------------------------------------------------------------ raw --
    def _err(self, what: str) -> ValueError:
        return ValueError(f"{self.path}: malformed HDF5 file: {what}")

    def _unsupported(self, what: str) -> NotImplementedError:
        return NotImplementedError(f"{self.path}: {what} is not read without h5py")

    def _bytes(self, addr: int, n: int) -> bytes:
        if addr < 0 or addr + n > len(self._d) or addr == _UNDEF:
            raise self._err(f"{n} bytes at {addr} past the end of the file")
        return self._d[addr: addr + n]

    def _uint(self, addr: int, n: int) -> int:
        return int.from_bytes(self._bytes(addr, n), "little")

    # ----------------------------------------------------- superblock --
    def _superblock(self) -> int:
        pos = 0
        while True:  # the signature sits at 0, 512, 1024, 2048, ...
            if self._d[pos: pos + 8] == _SIGNATURE:
                break
            pos = 512 if pos == 0 else pos * 2
            if pos + 8 > len(self._d):
                raise self._err("no HDF5 signature")
        version = self._d[pos + 8]
        if version in (2, 3):
            raise self._unsupported(f"superblock version {version} (libver \"latest\")")
        if version not in (0, 1):
            raise self._unsupported(f"superblock version {version}")
        self._so = self._d[pos + 13]  # size of offsets
        self._sl = self._d[pos + 14]  # size of lengths
        if self._so not in (2, 4, 8) or self._sl not in (2, 4, 8):
            raise self._err("bad offset or length size")
        p = pos + 24 + (4 if version == 1 else 0)
        self._base = self._uint(p, self._so)
        p += 4 * self._so  # the base, free-space, end-of-file and VFD-block addresses
        # root group symbol table entry: link name offset, object header address
        return self._addr(p + self._so)

    def _addr(self, p: int) -> int:
        """A file address stored at p (relative to the base address)."""
        v = self._uint(p, self._so)
        if v == (1 << (8 * self._so)) - 1:
            return _UNDEF
        return v + self._base

    # ---------------------------------------------------- object header --
    def _messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """(type, flags, body) of every message of a version-1 object header."""
        head = self._bytes(addr, 16)
        if head[:4] == b"OHDR":
            raise self._unsupported("a version-2 object header (libver \"latest\")")
        if head[0] != 1:
            raise self._unsupported(f"object header version {head[0]}")
        nmsg = struct.unpack_from("<H", head, 2)[0]
        size = struct.unpack_from("<I", head, 8)[0]
        blocks = [(addr + 16, size)]
        out = []
        while blocks and len(out) < nmsg:
            start, length = blocks.pop(0)
            p, end = start, start + length
            while p + 8 <= end and len(out) < nmsg:
                mtype, msize, flags = struct.unpack_from("<HHB", self._bytes(p, 5))
                body = self._bytes(p + 8, msize)
                p += 8 + msize
                if mtype == 0x0010:  # continuation
                    blocks.append((self._addr_in(body, 0), self._len_in(body, self._so)))
                out.append((mtype, flags, body))
        return out

    def _addr_in(self, body: bytes, p: int) -> int:
        v = int.from_bytes(body[p: p + self._so], "little")
        return _UNDEF if v == (1 << (8 * self._so)) - 1 else v + self._base

    def _len_in(self, body: bytes, p: int) -> int:
        return int.from_bytes(body[p: p + self._sl], "little")

    # -------------------------------------------------------------- groups --
    def _children(self, header: int) -> Dict[str, int]:
        """Name -> object header address of a symbol-table group's members."""
        table = None
        for mtype, _, body in self._messages(header):
            if mtype in _MSG_NAMES:
                raise self._unsupported(_MSG_NAMES[mtype])
            if mtype == 0x0011:
                table = (self._addr_in(body, 0), self._addr_in(body, self._so))
        if table is None:
            raise KeyError("not a group")
        btree, heap = table
        hb = self._bytes(heap, 8 + 2 * self._sl + self._so)
        if hb[:4] != b"HEAP":
            raise self._err("bad local heap signature")
        heap_data = self._addr(heap + 8 + 2 * self._sl)
        out: Dict[str, int] = {}
        for snod in self._btree_leaves(btree, 0):
            sb = self._bytes(snod, 8)
            if sb[:4] != b"SNOD":
                raise self._err("bad symbol node signature")
            count = struct.unpack_from("<H", sb, 6)[0]
            entry = 2 * self._so + 24
            for i in range(count):
                p = snod + 8 + i * entry
                name_off = self._len_in(self._bytes(p, self._so), 0)
                q = heap_data + name_off
                end = self._d.index(b"\0", q)
                out[self._d[q:end].decode()] = self._addr(p + self._so)
        return out

    def _btree_leaves(self, addr: int, node_type: int, ndim: int = 0):
        """Children of a version-1 B-tree's leaf level, in key order; for
        chunk trees (type 1) each with its key: (addr, size, mask, offsets)."""
        head = self._bytes(addr, 8)
        if head[:4] != b"TREE":
            raise self._err("bad B-tree signature")
        if head[4] != node_type:
            raise self._err("B-tree of the wrong type")
        level = head[5]
        used = struct.unpack_from("<H", head, 6)[0]
        p = addr + 8 + 2 * self._so
        key = self._sl if node_type == 0 else 8 + 8 * (ndim + 1)
        for i in range(used):
            kp = p + i * (key + self._so)
            child = self._addr(kp + key)
            if level > 0:
                yield from self._btree_leaves(child, node_type, ndim)
            elif node_type == 0:
                yield child
            else:
                kb = self._bytes(kp, key)
                size, mask = struct.unpack_from("<II", kb, 0)
                offsets = struct.unpack_from(f"<{ndim + 1}Q", kb, 8)
                yield child, size, mask, offsets[:ndim]

    def _lookup(self, name: str) -> int:
        addr = self._root
        for part in [p for p in name.split("/") if p]:
            children = self._children(addr)
            if part not in children:
                raise KeyError(f"{name!r} not in {self.path}")
            addr = children[part]
        return addr

    # ------------------------------------------------------------- datasets --
    def __getitem__(self, name: str) -> np.ndarray:
        return self._read(self._dataset(self._lookup(name)), name)

    def keys(self):
        return list(self._children(self._root))

    def _dataset(self, header: int) -> _Dataset:
        ds = _Dataset()
        for mtype, flags, body in self._messages(header):
            if mtype in _MSG_NAMES:
                raise self._unsupported(_MSG_NAMES[mtype])
            if flags & 0x02 and mtype in (0x0001, 0x0003, 0x0005, 0x000B):
                raise self._unsupported(f"a shared message (type {mtype})")
            if mtype == 0x0001:
                ds.shape = self._dataspace(body)
            elif mtype == 0x0003:
                ds.dtype = self._datatype(body)
            elif mtype == 0x0008:
                ds.layout = self._layout(body)
            elif mtype == 0x000B:
                ds.filters = self._pipeline(body)
            elif mtype == 0x0005:
                ds.fill = self._fill(body)
            elif mtype == 0x0004 and ds.fill is None:
                size = struct.unpack_from("<I", body, 0)[0]
                ds.fill = body[4: 4 + size] if size else None
        if ds.shape is None or ds.dtype is None or ds.layout is None:
            raise KeyError("not a dataset")
        return ds

    def _dataspace(self, body: bytes) -> Tuple[int, ...]:
        version, ndim, flags = body[0], body[1], body[2]
        if version == 1:
            p = 8
        elif version == 2:
            if body[3] == 2:
                raise self._unsupported("a null dataspace")
            p = 4
        else:
            raise self._unsupported(f"dataspace message version {version}")
        return tuple(self._len_in(body, p + i * self._sl) for i in range(ndim))

    def _datatype(self, body: bytes) -> np.dtype:
        cls, version = body[0] & 0x0F, body[0] >> 4
        bits = body[1] | (body[2] << 8) | (body[3] << 16)
        size = struct.unpack_from("<I", body, 4)[0]
        if cls in _CLASS_NAMES:
            raise self._unsupported(f"the {_CLASS_NAMES[cls]} datatype class")
        if cls not in (0, 1):
            raise self._unsupported(f"datatype class {cls}")
        if version not in (1, 2, 3):
            raise self._unsupported(f"datatype message version {version}")
        order = ">" if bits & 0x01 else "<"
        offset, precision = struct.unpack_from("<HH", body, 8)
        if cls == 0:
            if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
                raise self._unsupported(f"a {precision}-bit integer at bit {offset} of {size} bytes")
            kind = "i" if bits & 0x08 else "u"
            return np.dtype(f"{order if size > 1 else '|'}{kind}{size}")
        if bits & 0x40:
            raise self._unsupported("a VAX-order float")
        eloc, esize, mloc, msize = body[12:16]
        ieee = {2: (10, 5, 5, 10), 4: (23, 8, 8, 23), 8: (52, 11, 11, 52)}
        if size not in ieee or (eloc, esize, mloc, msize) != (ieee[size][0], ieee[size][1], 0,
                                                                ieee[size][3]):
            raise self._unsupported(f"a {size}-byte float that is not IEEE 754")
        return np.dtype(f"{order}f{size}")

    def _layout(self, body: bytes) -> tuple:
        version = body[0]
        if version == 4:
            raise self._unsupported("data layout message version 4 (chunk indexes of "
                                    "libver \"latest\")")
        if version != 3:
            raise self._unsupported(f"data layout message version {version}")
        kind = body[1]
        if kind == 0:
            size = struct.unpack_from("<H", body, 2)[0]
            return ("compact", body[4: 4 + size])
        if kind == 1:
            return ("contiguous", self._addr_in(body, 2), self._len_in(body, 2 + self._so))
        if kind == 2:
            ndim = body[2] - 1
            btree = self._addr_in(body, 3)
            p = 3 + self._so
            dims = struct.unpack_from(f"<{ndim + 1}I", body, p)
            return ("chunked", btree, tuple(dims[:ndim]))
        raise self._unsupported(f"layout class {kind}")

    def _pipeline(self, body: bytes) -> List[Tuple[int, Tuple[int, ...]]]:
        version, n = body[0], body[1]
        if version not in (1, 2):
            raise self._unsupported(f"filter pipeline message version {version}")
        p = 8 if version == 1 else 2
        out = []
        for _ in range(n):
            fid = struct.unpack_from("<H", body, p)[0]
            p += 2
            name_len = 0
            if version == 1 or fid >= 256:
                name_len = struct.unpack_from("<H", body, p)[0]
                p += 2
            flags, nvals = struct.unpack_from("<HH", body, p)
            p += 4
            if version == 1:
                name_len = (name_len + 7) // 8 * 8
            p += name_len
            vals = struct.unpack_from(f"<{nvals}I", body, p)
            p += 4 * nvals
            if version == 1 and nvals % 2:
                p += 4
            if fid not in (1, 2, 3):
                name = _FILTER_NAMES.get(fid, "unknown")
                raise self._unsupported(f"filter {fid} ({name})")
            out.append((fid, vals))
        return out

    def _fill(self, body: bytes) -> Optional[bytes]:
        version = body[0]
        if version in (1, 2):
            defined = body[3]
            if version == 1 or defined:
                size = struct.unpack_from("<I", body, 4)[0]
                return body[8: 8 + size] if size else None
            return None
        if version == 3:
            flags = body[1]
            if flags & 0x20:  # fill value defined
                size = struct.unpack_from("<I", body, 2)[0]
                return body[6: 6 + size] if size else None
            return None
        raise self._unsupported(f"fill value message version {version}")

    def _unfilter(self, data: bytes, filters, mask: int, where: str) -> bytes:
        for i in range(len(filters) - 1, -1, -1):
            if mask & (1 << i):
                continue
            fid, vals = filters[i]
            if fid == 1:
                try:
                    data = zlib.decompress(data)
                except zlib.error as e:
                    raise self._err(f"deflate of {where}: {e}") from e
            elif fid == 2:
                size = vals[0] if vals else 1
                n = len(data) // size
                if size > 1 and n > 1:
                    body = np.frombuffer(data[: n * size], np.uint8).reshape(size, n)
                    data = body.T.tobytes() + data[n * size:]
            elif fid == 3:
                if len(data) < 4:
                    raise self._err(f"fletcher32 of {where}: too short")
                body, stored = data[:-4], int.from_bytes(data[-4:], "little")
                fl = _fletcher32(body)
                swapped = ((fl & 0x00FF00FF) << 8) | ((fl >> 8) & 0x00FF00FF)
                if stored not in (fl, swapped):
                    raise self._err(f"fletcher32 checksum mismatch in {where}")
                data = body
        return data

    def _read(self, ds: _Dataset, name: str) -> np.ndarray:
        dtype, shape = ds.dtype, ds.shape
        count = int(np.prod(shape, dtype=np.int64))
        kind = ds.layout[0]
        if kind == "compact":
            raw = ds.layout[1]
            return np.frombuffer(raw[: count * dtype.itemsize], dtype).reshape(shape).copy()
        if kind == "contiguous":
            addr = ds.layout[1]
            if addr == _UNDEF:  # never written
                return self._filled(ds, shape)
            raw = self._bytes(addr, count * dtype.itemsize)
            return np.frombuffer(raw, dtype).reshape(shape).copy()
        _, btree, chunk = ds.layout
        out = self._filled(ds, shape)
        if btree == _UNDEF:
            return out
        ndim = len(shape)
        csize = int(np.prod(chunk, dtype=np.int64)) * dtype.itemsize
        for addr, size, mask, offsets in self._btree_leaves(btree, 1, ndim):
            raw = self._unfilter(self._bytes(addr, size), ds.filters, mask,
                                 f"the chunk at {offsets} of {name!r}")
            if len(raw) < csize:
                raise self._err(f"chunk at {offsets} of {name!r} is short")
            block = np.frombuffer(raw[:csize], dtype).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, shape))
            src = tuple(slice(0, d.stop - d.start) for d in dst)
            out[dst] = block[src]
        return out

    def _filled(self, ds: _Dataset, shape) -> np.ndarray:
        out = np.zeros(shape, ds.dtype)
        if ds.fill is not None and len(ds.fill) == ds.dtype.itemsize:
            out[...] = np.frombuffer(ds.fill, ds.dtype)[0]
        return out


def read_dataset(path, name: str) -> np.ndarray:
    """`np.asarray(h5py.File(path, "r")[name])` without h5py."""
    return File(path)[name]
