"""Progress meters and the remaining-time estimate (counterpart of
`pmf_tpu/utils/meters.py`)."""
from __future__ import annotations


class AverageMeter:
    """Running average of a scalar, weighted by sample count."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class RunningAvgMeter:
    """Exponential moving average of a scalar."""

    def __init__(self, alpha: float = 0.95):
        self.alpha = alpha
        self.val = 0.0
        self.avg = None

    def update(self, val: float):
        self.val = float(val)
        self.avg = self.val if self.avg is None else \
            self.alpha * self.avg + (1.0 - self.alpha) * self.val


class RemainTime:
    """The remaining wall time of a run, from the moving average of each
    mode's (Train, Validation) time per iteration."""

    def __init__(self, n_epochs: int):
        self.n_epochs = n_epochs
        self.cost_time: dict[str, RunningAvgMeter] = {}

    def update(self, cost_time: float, mode: str = "Train"):
        self.cost_time.setdefault(mode, RunningAvgMeter(0.95)).update(cost_time)

    def getRemainTime(self, epoch: int, iters: int, total_iter: int, mode: str = "Train") -> float:
        remain = 0.0
        for m, meter in self.cost_time.items():
            if m == mode:
                rest = total_iter - iters - 1 + (self.n_epochs - epoch - 1) * total_iter
            else:
                rest = (self.n_epochs - epoch - 1) * total_iter
            remain += meter.avg * max(rest, 0)
        return remain
