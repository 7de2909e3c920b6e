"""Weighted smooth-L1 (Huber) loss (counterpart of
`pmf_tpu/losses/weighted_smoothl1.py`): beta = 1/sigma², quadratic inside
|d| < beta, linear outside; an optional weight, and an optional mask whose
masked mean divides by mask.sum()."""
from __future__ import annotations

import torch


def weighted_smooth_l1(x: torch.Tensor, target: torch.Tensor, sigma: float = 3.0,
                       weight: torch.Tensor | None = None,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    diff = (x - target).abs()
    beta = 1.0 / (sigma ** 2)
    loss = torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)
    if weight is not None:
        loss = loss * weight
    if mask is not None:
        m = torch.broadcast_to(mask, loss.shape).to(loss.dtype)
        return (loss * m).sum() / m.sum().clamp(min=1e-12)
    return loss.mean()
