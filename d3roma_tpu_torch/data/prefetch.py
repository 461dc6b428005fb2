"""Host -> device input prefetching.

Port of `d3roma_tpu/data/prefetch.py`: up to `size` batches are prepared
ahead of the one the caller consumes. With `to_device`, a prepared batch's
arrays are copied from pinned host memory with non_blocking copies, so on
CUDA the copy of the next batch overlaps the current step's compute.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch


def to_device(raw: dict, device) -> dict:
    """The batch's arrays as tensors on `device` (lists of paths and device
    names are dropped); on CUDA through pinned memory, non_blocking."""
    device = torch.device(device)
    out = {}
    for k, v in raw.items():
        if isinstance(v, (list, str)):
            continue
        t = torch.as_tensor(np.asarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def device_prefetch(
    iterator: Iterable,
    prepare: Optional[Callable] = None,
    size: int = 2,
) -> Iterator:
    """Yield items with up to `size` batches already prepared (`prepare`
    maps a raw host batch to device tensors, e.g. `to_device` then the
    on-device preprocessing; the copies and the kernels it enqueues run
    ahead of the consumer)."""
    queue = collections.deque()
    it = iter(iterator)

    def enqueue(n):
        for _ in range(n):
            try:
                item = next(it)
            except StopIteration:
                return
            queue.append(prepare(item) if prepare is not None else item)

    enqueue(size)
    while queue:
        yield queue.popleft()
        enqueue(1)
