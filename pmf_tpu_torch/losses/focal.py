"""Focal softmax loss (counterpart of `pmf_tpu/losses/focal.py`).

  p_t  = probs[target]
  loss = -(1 - p_t)^gamma · log(max(p_t, 1e-6)) · alpha[target]
reduced as a mean, or as sum(loss · mask) / sum(mask) with a mask.
"""
from __future__ import annotations

import torch


def one_hot(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """float32 one-hot of integer `labels` ([...] → [..., C]); a label
    outside [0, C) gives a row of zeros, as jax.nn.one_hot does."""
    iota = torch.arange(n_classes, device=labels.device)
    return (labels[..., None] == iota).float()


def focal_softmax_loss(probs: torch.Tensor, target: torch.Tensor,
                       alpha: torch.Tensor, gamma: float = 2.0,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """probs [..., C] class probabilities, target [...] integer labels,
    alpha [C] per-class weights, mask [...] optional weights."""
    C = probs.shape[-1]
    p = probs.reshape(-1, C)
    t = target.reshape(-1)
    pt = (p * one_hot(t, C).to(p.dtype)).sum(dim=-1)
    log_pt = torch.log(pt.clamp(min=1e-6))
    a = alpha.to(p.dtype)[t.long()]
    loss = -((1.0 - pt) ** gamma) * log_pt * a
    if mask is None:
        return loss.mean()
    m = mask.reshape(-1).to(loss.dtype)
    return (loss * m).sum() / m.sum().clamp(min=1e-12)
