"""Resize and reshuffle primitives of the models, on NCHW tensors
(counterparts of `pmf_tpu/ops/resize.py`, which works on NHWC). Under a row
split (`parallel/spatial.py`) each computes this rank's output rows from
the input rows they read."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial


def upsample_bilinear(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (align_corners=False); at the
    edges this equals `jax.image.resize(..., "bilinear")` for upsampling.
    Output row o reads input rows ⌊(o + ½)/scale − ½⌋ and the next, clamped
    to the tensor's rows: under a row split the block of those rows is
    resized and cut to this rank's output rows (the clamp at a block's edge
    lands only on rows cut away)."""
    up = lambda block: F.interpolate(block, scale_factor=scale, mode="bilinear",
                                     align_corners=False)
    if spatial.active() is None:
        return up(x)
    H = spatial.height(x)
    src = lambda o: (2 * o + 1 - scale) // (2 * scale)
    return spatial.rows_op(x, H * scale,
                           lambda lo, hi: (max(src(lo), 0), min(src(hi - 1) + 2, H)),
                           up, lambda a: a * scale)


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """[N, C*r*r, H, W] → [N, C, H*r, W*r], input channel c*r*r + i*r + j
    going to row offset i and column offset j (torch's nn.PixelShuffle)."""
    if spatial.active() is None:
        return F.pixel_shuffle(x, r)
    return spatial.rows_op(x, spatial.height(x) * r, lambda lo, hi: (lo // r, (hi - 1) // r + 1),
                           lambda block: F.pixel_shuffle(block, r), lambda a: a * r)


class PixelShuffle(nn.Module):
    """nn.PixelShuffle through `pixel_shuffle` (no parameters: a module of
    an nn.Sequential keeps its place)."""

    def __init__(self, r: int):
        super().__init__()
        self.r = r

    def forward(self, x):
        return pixel_shuffle(x, self.r)
