"""A reader for `.safetensors` files with the standard library and torch only.

The format: an 8-byte little-endian header length N, a JSON header of N
bytes, `{name: {"dtype", "shape", "data_offsets": [begin, end]}}` (offsets
into the data that follows the header; `__metadata__` is skipped), then the
raw little-endian bytes of every tensor.

`load_file` maps the file instead of reading it (a full SD2.1 UNet is 3.5 GB
in fp32): every tensor is a view of one private copy-on-write mapping, so a
page is read from disk when a tensor's data is first touched, and writing to
a tensor never reaches the file. BF16 comes back as torch.bfloat16 (numpy,
which the `safetensors` package's numpy reader goes through, has no
bfloat16).
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
# the unsigned types past 8 bits exist in PyTorch since 2.3
DTYPES.update({k: getattr(torch, n) for k, n in (("U16", "uint16"), ("U32", "uint32"),
                                                 ("U64", "uint64")) if hasattr(torch, n)})


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a `.safetensors` file, as CPU tensors in the file's
    dtypes and shapes, in header order."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = f.seek(0, 2)
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else b""
    header.pop("__metadata__", None)
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']!r}, which this reader "
                             f"does not take (one of {sorted(DTYPES)})")
        dtype, shape = DTYPES[info["dtype"]], tuple(int(d) for d in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = 1
        for d in shape:
            count *= d
        if end - begin != count * itemsize or base + end > size:
            raise ValueError(f"{path}: {name} spans bytes [{begin}, {end}), which does not "
                             f"hold {shape} of {info['dtype']} inside the file")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (base + begin) % itemsize:  # unaligned: a copy of its bytes
            raw = bytearray(mapped[base + begin: base + end])
            out[name] = torch.frombuffer(raw, dtype=dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(mapped, dtype=dtype, count=count,
                                         offset=base + begin).reshape(shape)
    return out
