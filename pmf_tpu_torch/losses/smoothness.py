"""Laplacian smoothness and gradient-guide losses (counterpart of
`pmf_tpu/losses/smoothness.py`): the divergence map is a depthwise 3×3
Laplacian (centre 1, ring -1/8, zero padding), a grouped convolution on
NCHW tensors; the guide loss matches the maps of a prediction and of a
target (no gradient) with smooth-L1."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .weighted_smoothl1 import weighted_smooth_l1

_LAPLACIAN = ((-0.125, -0.125, -0.125), (-0.125, 1.0, -0.125), (-0.125, -0.125, -0.125))


def divergence_map(x: torch.Tensor) -> torch.Tensor:
    """The depthwise 3×3 Laplacian of [N, C, H, W] `x`, same size."""
    C = x.shape[1]
    k = torch.tensor(_LAPLACIAN, dtype=x.dtype, device=x.device).expand(C, 1, 3, 3)
    return F.conv2d(x, k, padding=1, groups=C)


def smoothness_loss(x: torch.Tensor, size_average: bool = True) -> torch.Tensor:
    """mean |Laplacian(x)|, or the map itself without `size_average`."""
    div = divergence_map(x)
    return div.abs().mean() if size_average else div


def grad_guide_loss(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """smooth-L1 between the Laplacians of `x` and of `target` (detached)."""
    return weighted_smooth_l1(divergence_map(x), divergence_map(target).detach())
