"""Resize and reshuffle primitives of the models, on NCHW tensors
(counterparts of `pmf_tpu/ops/resize.py`, which works on NHWC)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_bilinear(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (align_corners=False); at the
    edges this equals `jax.image.resize(..., "bilinear")` for upsampling."""
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=False)


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """[N, C*r*r, H, W] → [N, C, H*r, W*r], input channel c*r*r + i*r + j
    going to row offset i and column offset j (torch's nn.PixelShuffle)."""
    return F.pixel_shuffle(x, r)
