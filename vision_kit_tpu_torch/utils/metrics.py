"""Generic metric meters: the port's copy of
vision_kit_tpu/utils/metrics.py (host only).

smooth / smooth_bce live with their consumers (train.evaluator.smooth,
train.losses.smooth_bce); re-exported here, as the JAX package does.
"""

from __future__ import annotations

from collections import defaultdict, deque

import numpy as np

from vision_kit_tpu_torch.train.evaluator import smooth  # noqa: F401
from vision_kit_tpu_torch.train.losses import smooth_bce  # noqa: F401


class AverageMeter:
    """Track a series of values and provide smoothed access
    (reference metrics.py:23-67)."""

    def __init__(self, window_size: int = 50):
        self._deque: deque = deque(maxlen=window_size)
        self._total = 0.0
        self._count = 0

    def update(self, value):
        self._deque.append(float(value))
        self._count += 1
        self._total += float(value)

    @property
    def median(self) -> float:
        return float(np.median(self._deque)) if self._deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self._deque)) if self._deque else 0.0

    @property
    def global_avg(self) -> float:
        return self._total / max(self._count, 1)

    @property
    def latest(self) -> float:
        return self._deque[-1] if self._deque else float("nan")

    @property
    def total(self) -> float:
        return self._total

    def reset(self):
        self._deque.clear()
        self._total = 0.0
        self._count = 0

    def clear(self):
        self._deque.clear()


class MeterBuffer(defaultdict):
    """Dict of AverageMeters with filtered views (reference metrics.py:70-95)."""

    def __init__(self, window_size: int = 20):
        super().__init__(lambda: AverageMeter(window_size=window_size))

    def reset(self):
        for v in self.values():
            v.reset()

    def get_filtered_meter(self, filter_key: str = "time"):
        return {k: v for k, v in self.items() if filter_key in k}

    def update(self, values=None, **kwargs):
        if values is None:
            values = {}
        values.update(kwargs)
        for k, v in values.items():
            self[k].update(v)

    def clear_meters(self):
        for v in self.values():
            v.clear()
