"""Learned uncertainty weighting of several losses (counterpart of
`pmf_tpu/losses/multi_task.py`): total = Σ lᵢ / (2σᵢ²) + log(σᵢ² + 1),
with σ a learned vector that starts at ones(n) / n."""
from __future__ import annotations

import torch


def init_multi_task_params(n_losses: int, device=None) -> torch.Tensor:
    """σ's start, ones(n) / n, float32."""
    return torch.ones(n_losses, device=device) / n_losses


def multi_task_loss(sigma: torch.Tensor, losses) -> torch.Tensor:
    s2 = sigma ** 2
    return (torch.stack(list(losses)) / (2.0 * s2) + torch.log(s2 + 1.0)).sum()
