"""IoU / accuracy / recall from a confusion matrix (counterpart of
`pmf_tpu/metrics/iou.py`).

conf[pred, gt] accumulates over batches (rows = pred, cols = gt); ignore
classes are zeroed on both rows and columns before the statistics;
IoU = tp / (tp + fp + fn + 1e-15), means over the included classes.
"""
from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor, n_classes: int,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """[C, C] float32 matrix conf[pred, gt] of two integer tensors; entries
    outside [0, C) and invalid ones count nowhere."""
    if pred.numel() > 2 ** 24:
        # the cells are float32, exact only up to 2^24
        raise ValueError(
            f"confusion_matrix: {pred.numel()} elements/call can overflow "
            "exact f32 cell counts (> 2^24); split the batch across calls")
    p = pred.reshape(-1).long()
    t = target.reshape(-1).long()
    ok = (p >= 0) & (p < n_classes) & (t >= 0) & (t < n_classes)
    if valid is not None:
        ok &= valid.reshape(-1).bool()
    counts = torch.bincount(p[ok] * n_classes + t[ok], minlength=n_classes ** 2)
    return counts.reshape(n_classes, n_classes).float()


class IOUEval:
    """Stateful accumulator with the reference IOUEval API; the confusion
    matrix accumulates in float64 on the host."""

    def __init__(self, n_classes: int, ignore=()):
        self.n_classes = n_classes
        self.ignore = [ignore] if isinstance(ignore, int) else list(ignore)
        self.include = [c for c in range(n_classes) if c not in self.ignore]
        self.reset()

    def reset(self):
        self.conf = np.zeros((self.n_classes, self.n_classes), dtype=np.float64)

    def addBatch(self, pred, target, valid=None):
        as_t = lambda a: a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        conf = confusion_matrix(as_t(pred), as_t(target), self.n_classes,
                                None if valid is None else as_t(valid))
        self.conf += conf.cpu().numpy().astype(np.float64)

    def addBatchConf(self, conf):
        """Add a [C, C] confusion matrix (a tensor on any device, or an array)."""
        conf = conf.cpu().numpy() if torch.is_tensor(conf) else np.asarray(conf)
        self.conf += conf.astype(np.float64)

    def _stats(self):
        conf = self.conf.copy()
        if self.ignore:
            conf[self.ignore, :] = 0
            conf[:, self.ignore] = 0
        tp = np.diag(conf)
        return tp, conf.sum(axis=1) - tp, conf.sum(axis=0) - tp

    def getIoU(self):
        tp, fp, fn = self._stats()
        iou = tp / (tp + fp + fn + 1e-15)
        return iou[self.include].mean(), iou

    def getAcc(self):
        tp, fp, fn = self._stats()
        acc = tp / (tp + fp + 1e-15)
        return acc[self.include].mean(), acc

    def getRecall(self):
        tp, fp, fn = self._stats()
        recall = tp / (tp + fn + 1e-15)
        return recall[self.include].mean(), recall

    def getFwIoU(self):
        """Frequency-weighted IoU."""
        tp, fp, fn = self._stats()
        iou = tp / (tp + fp + fn + 1e-15)
        freq = (tp + fn) / max((tp + fn).sum(), 1e-15)
        return (freq[self.include] * iou[self.include]).sum()
