"""Dice losses (counterpart of `pmf_tpu/losses/dice.py`).

As the reference has them: `dice_loss` returns the soft dice
*coefficient* (not 1 - dice), its per-class sums run over every pixel of
the batch (the global batch while a process group is up), and the classes
are then averaged; `explog_dice_loss` is
(-log(max(dice, 1e-6)))^gamma with gamma 0.3, which SensatUrban adds to
both focal terms.
"""
from __future__ import annotations

import torch

from ..parallel import global_sum
from .focal import one_hot

_EPS = 1e-6


def dice_loss(probs: torch.Tensor, target: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """probs [..., C] class probabilities, target [...] integer labels, mask
    [...] optional 0/1 weights (masked pixels count as class 0 with zero
    probabilities)."""
    C = probs.shape[-1]
    p = probs.reshape(-1, C)
    t = target.reshape(-1)
    if mask is not None:
        m = mask.reshape(-1).to(p.dtype)
        t = (t * m).to(t.dtype)
        p = p * m[:, None]
    oh = one_hot(t, C).to(p.dtype)
    inter, total = global_sum(torch.stack([(p * oh).sum(dim=0), (p + oh).sum(dim=0)]))
    intersect = 2.0 * inter + _EPS
    denom = total + _EPS
    return (intersect / denom).mean()


def explog_dice_loss(probs: torch.Tensor, target: torch.Tensor,
                     mask: torch.Tensor | None = None, gamma: float = 0.3) -> torch.Tensor:
    d = dice_loss(probs, target, mask)
    return (-torch.log(d.clamp(min=1e-6))) ** gamma
