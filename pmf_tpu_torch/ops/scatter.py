"""Deterministic z-buffer of points onto an image grid (per-scan path).

Counterpart of `pmf_tpu/ops/scatter.py`. The nearest point wins each pixel
and the lowest point index wins ties, through one scatter-min of packed
int32 keys (quantized depth << nbits | index). On CUDA the key image comes
from the K1 kernel (`ops/zbuffer.py`); the fill is a plain gather of the
winners' rows.
"""
from __future__ import annotations

import math

import torch

from .zbuffer import IMAX, zbuffer_keys


def flat_pixels(rows, cols, keep, H: int, W: int) -> torch.Tensor:
    """Flat pixel id r*W + c of each point (clamped into the image), H*W for
    points not kept."""
    r = rows.to(torch.int32).clamp(0, H - 1)
    c = cols.to(torch.int32).clamp(0, W - 1)
    return torch.where(keep, r * W + c, H * W)


def packed_keys(rows, cols, depth, keep, H: int, W: int, depth_quant: float):
    """(pix, key, nbits): the point index takes the low nbits = ceil(log2 N)
    bits of the key, the depth quantized to `depth_quant` the rest, clipped
    at 2^(31 - nbits) - 1 quanta (pmf_tpu/ops/scatter.py:45-58)."""
    N = depth.shape[-1]
    nbits = max(math.ceil(math.log2(max(N, 2))), 1)
    if 31 - nbits < 10:
        raise ValueError(f"too many points for packed z-buffer: {N}")
    max_q = (1 << (31 - nbits)) - 1
    pix = flat_pixels(rows, cols, keep, H, W)
    dq = (depth.float() / depth_quant).clamp(0, max_q).to(torch.int32)
    idx = torch.arange(N, dtype=torch.int32, device=depth.device)
    key = torch.where(keep, (dq << nbits) | idx, IMAX)
    return pix, key, nbits


def zbuffer_scatter_packed(rows, cols, depth, keep, H: int, W: int,
                           depth_quant: float = 1.0 / 64.0):
    """rows/cols/depth/keep [N] → (winner [H, W] int32, -1 where empty;
    mask [H, W] bool)."""
    pix, key, nbits = packed_keys(rows, cols, depth, keep, H, W, depth_quant)
    key_img = zbuffer_keys(pix[None].contiguous(), key[None].contiguous(), H, W)[0]
    mask = key_img != IMAX
    winner = torch.where(mask, key_img & ((1 << nbits) - 1), -1)
    return winner, mask


def point_winner_flags(rows, cols, depth, keep, H: int, W: int,
                       depth_quant: float = 1.0 / 64.0):
    """Per point (flat pixel id in [0, H*W], H*W for invalid; did it win its
    pixel), by the same packed-key z-test as `zbuffer_scatter_packed`."""
    pix, key, _ = packed_keys(rows, cols, depth, keep, H, W, depth_quant)
    key_img = zbuffer_keys(pix[None].contiguous(), key[None].contiguous(), H, W)
    flat = torch.cat([key_img.reshape(-1), key_img.new_full((1,), IMAX)])
    return pix, keep & (flat[pix.long()] == key)


def fill_canvas(values: torch.Tensor, winner: torch.Tensor, mask: torch.Tensor,
                fill: float = 0.0) -> torch.Tensor:
    """Each occupied pixel takes its winner's row of `values` [N, F]:
    [H, W, F], `fill` at empty pixels."""
    H, W = winner.shape
    rows = values[winner.clamp(min=0).reshape(-1).long()].reshape(H, W, -1)
    return torch.where(mask[..., None], rows, fill)
