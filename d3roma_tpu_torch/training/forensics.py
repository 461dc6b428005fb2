"""Abnormal-loss forensics.

Port of `d3roma_tpu/training/forensics.py` (numpy only; torch tensors in
the batch or the metrics are moved to the host when dumped). Rebuild of the reference's training failure detection
(reference: train.py:65-90, 419-515): when the step loss exceeds
`ratio x running-average` (or is NaN/Inf), log the offending sample paths,
dump the full batch tensors + grad norm to `checkpoints/<step>_dump`, and
save an emergency `_storm` checkpoint. The reference then drops into
`breakpoint()`; here the policy is configurable (raise or continue) since
jobs run without a terminal.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


def _host(v) -> np.ndarray:
    """numpy array of a numpy value or a torch tensor on any device."""
    if hasattr(v, "detach"):
        v = v.detach().float().cpu() if v.is_floating_point() else v.detach().cpu()
        return v.numpy()
    return np.asarray(v)


class AbnormalLossDetector:
    def __init__(
        self,
        out_dir: str,
        ratio: float = 100.0,
        min_history: int = 10,
        on_abnormal: str = "dump",  # "dump" | "raise" | "ignore"
        max_dumps: int = 5,
    ):
        self.out_dir = out_dir
        self.ratio = ratio
        self.min_history = min_history
        self.on_abnormal = on_abnormal
        # a persistent failure (e.g. every step NaN) must not fill the
        # disk with one multi-GB batch dump per step; after max_dumps
        # the detector still reports abnormal but only logs
        self.max_dumps = max_dumps
        self.num_dumps = 0

    def check(
        self,
        loss: float,
        avg_loss: float,
        history_len: int,
        global_step: int,
        batch: Optional[Dict] = None,
        metrics: Optional[Dict] = None,
        paths=None,
    ) -> bool:
        """Returns True if the step was abnormal."""
        is_nan = not np.isfinite(loss)
        is_storm = (
            history_len >= self.min_history
            and avg_loss > 0
            and loss > self.ratio * avg_loss
        )
        if not (is_nan or is_storm):
            return False
        kind = "nan" if is_nan else "storm"
        logger.error(
            "abnormal loss at step %d: loss=%g avg=%g (%s)",
            global_step, loss, avg_loss, kind,
        )
        if paths:
            for p in paths:
                logger.error("  offending sample: %s", p)
        if self.on_abnormal == "raise":
            raise FloatingPointError(f"abnormal loss {loss} at step {global_step}")
        if self.on_abnormal == "dump":
            if self.num_dumps >= self.max_dumps:
                logger.error("forensic dump suppressed (%d already written)",
                             self.num_dumps)
                return True
            self.num_dumps += 1
            dump_dir = os.path.join(self.out_dir, "checkpoints", f"{global_step}_dump")
            os.makedirs(dump_dir, exist_ok=True)
            arrays = {}
            if batch is not None:
                for k, v in batch.items():
                    if isinstance(v, (list, str)):
                        continue
                    arrays[f"batch_{k}"] = _host(v)
            if metrics is not None:
                for k, v in metrics.items():
                    arrays[f"metric_{k}"] = _host(v)
            np.savez_compressed(os.path.join(dump_dir, "dump.npz"), **arrays)
            if paths:
                with open(os.path.join(dump_dir, "paths.txt"), "w") as f:
                    f.write("\n".join(str(p) for p in paths))
            logger.error("forensic dump written to %s", dump_dir)
        return True
