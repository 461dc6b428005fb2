"""Running metric averager with anomaly detection.

Port of `d3roma_tpu/evaluation/averager.py` (a copy). Rebuild of the reference's `RunningAverager`
(reference: utils_d3roma/utils.py:673-748): accumulates metric dicts,
rejects samples whose watched metric exceeds a ratio of the running
average, and reports the abnormal indexes (reference: evaluate.py:414-427).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional


class RunningAverager:
    def __init__(self, horizon: int = 5, detect_anomaly: Optional[Dict[str, float]] = None):
        self.horizon = horizon
        self.detect_anomaly = detect_anomaly or {}
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._recent: Dict[str, List[float]] = defaultdict(list)
        self.abnormal_indexes: List = []
        self.num_rejected = 0

    def _is_abnormal(self, metrics: Dict[str, float]) -> bool:
        for key, ratio in self.detect_anomaly.items():
            if key not in metrics or self._counts[key] < self.horizon:
                continue
            avg = self._sums[key] / self._counts[key]
            if avg > 0 and metrics[key] > ratio * avg:
                return True
        return False

    def append(self, metrics: Dict[str, float], index=None) -> bool:
        """Returns False (and rejects the sample) when anomalous."""
        metrics = {k: float(v) for k, v in metrics.items()}
        if self._is_abnormal(metrics):
            self.num_rejected += 1
            if index is not None:
                self.abnormal_indexes.append(index)
            return False
        for k, v in metrics.items():
            self._sums[k] += v
            self._counts[k] += 1
            self._recent[k].append(v)
            if len(self._recent[k]) > self.horizon:
                self._recent[k].pop(0)
        return True

    def average(self) -> Dict[str, float]:
        return {k: self._sums[k] / max(1, self._counts[k]) for k in self._sums}

    def recent_average(self) -> Dict[str, float]:
        return {
            k: sum(v) / len(v) for k, v in self._recent.items() if v
        }

    def __len__(self):
        return max(self._counts.values()) if self._counts else 0
