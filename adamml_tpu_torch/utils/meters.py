"""Running-average meters (reference utils/utils.py:24-39); the port's copy
of ``adamml_tpu/utils/meters.py``."""

from __future__ import annotations


class AverageMeter:
    """Tracks current value, running sum, and mean."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(1, self.count)
