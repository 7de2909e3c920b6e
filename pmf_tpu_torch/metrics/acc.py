"""Top-k accuracy (counterpart of `pmf_tpu/metrics/acc.py`)."""
from __future__ import annotations

import numpy as np
import torch


def topk_accuracy(logits: torch.Tensor, target: torch.Tensor, k: int = 1) -> torch.Tensor:
    """The share of rows [..., C] whose target is among the top-k logits
    (float32: the count times 1/rows, as XLA computes pmf_tpu's mean)."""
    logits = logits.reshape(-1, logits.shape[-1])
    topk = torch.topk(logits, k, dim=-1).indices
    hit = (topk == target.reshape(-1, 1)).any(dim=1).float()
    return hit.sum() * (1.0 / hit.numel())


class AccEval:
    """Streaming top-k accuracy over batches."""

    def __init__(self, topk: int = 1):
        self.topk = topk
        self.reset()

    def reset(self):
        self._correct = 0.0
        self._total = 0

    def addBatch(self, logits, target):
        as_t = lambda a: a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        target = as_t(target)
        n = int(np.prod(tuple(target.shape)))
        self._correct += float(topk_accuracy(as_t(logits), target, self.topk)) * n
        self._total += n

    def getAcc(self):
        return self._correct / max(self._total, 1)
