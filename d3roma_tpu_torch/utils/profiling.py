"""Tracing / profiling helpers.

Port of `d3roma_tpu/utils/profiling.py`: `trace` is `torch.profiler` (CPU
and, where there is a card, CUDA activity) writing a Chrome trace, which
opens in Perfetto or chrome://tracing; `StepTimer` accumulates wall-clock
phases and synchronizes the devices of the tensors it is told to wait for,
the counterpart of `jax.block_until_ready`."""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a torch.profiler trace around a block; the Chrome trace is
    written to `log_dir/trace_<pid>_<ns>.json` when the block ends
    (`log_dir` defaults to `d3roma_trace` in the temporary directory)."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "d3roma_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def _sync_devices(tree) -> None:
    """Synchronize the CUDA device of every tensor in a nested structure."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Accumulating wall-clock timer for loop phases; waits for the device
    results in `block_on` so device time is attributed to the right phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            _sync_devices(block_on)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {
            k: self.totals[k] / max(1, self.counts[k]) for k in self.totals
        }

    def log(self):
        for k, v in sorted(self.summary().items()):
            logger.info("phase %-20s %8.2f ms/it (n=%d)", k, v * 1e3, self.counts[k])
