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
    going to row offset i and column offset j (torch's nn.PixelShuffle). A
    channels-last x gives a channels-last output (one copy, as
    F.pixel_shuffle's, differentiable), so that the convs after it keep that
    layout and their epilogues (`layers.conv_block`) stay on the kernels, in
    inference and in training."""
    if spatial.active() is None:
        if not x.is_contiguous(memory_format=torch.channels_last):
            return F.pixel_shuffle(x, r)
        n, c, h, w = x.shape
        shuffled = x.permute(0, 2, 3, 1).reshape(n, h, w, c // (r * r), r, r)
        return shuffled.permute(0, 1, 4, 2, 5, 3).reshape(n, h * r, w * r, c // (r * r)).permute(
            0, 3, 1, 2)
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
