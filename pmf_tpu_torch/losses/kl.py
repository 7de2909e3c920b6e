"""Pointwise KL divergence as torch.nn.KLDivLoss(reduction='none') computes
it (counterpart of `pmf_tpu/losses/kl.py`): target · (log target − log_pred),
with 0 · log 0 = 0."""
from __future__ import annotations

import torch


def kl_div(log_pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    t_log_t = torch.where(target > 0, target * torch.log(target.clamp(min=1e-12)), 0.0)
    return t_log_t - target * log_pred
