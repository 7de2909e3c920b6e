"""Deterministic z-buffer of points onto an image grid (per-scan path).

Counterpart of `pmf_tpu/ops/scatter.py`. The nearest point wins each pixel
and the lowest point index wins ties, through one scatter-min of packed
int32 keys (quantized depth << nbits | index). On CUDA the key image comes
from the K1 kernel (`ops/zbuffer.py`); the fill is a plain gather of the
winners' rows. `point_winner_flags` gives the train path's per-point winner
flags, and `rasterize_unique` places per-point rows back on the canvas.
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
                       depth_quant: float = 1.0 / 64.0, keys=zbuffer_keys):
    """Per point of a batch of scans (rows/cols/depth/keep [B, N]): its flat
    pixel id in [0, H*W] (H*W for points not kept) and whether it won its
    pixel, by the same packed-key z-test as `zbuffer_scatter_packed`. The
    key image of the whole batch is one call of `keys` (the K1 wrapper, or
    its plain version where the two are compared)."""
    pix, key, _ = packed_keys(rows, cols, depth, keep, H, W, depth_quant)
    key_img = keys(pix.contiguous(), key.contiguous(), H, W)
    flat = torch.cat([key_img.reshape(pix.shape[0], -1),
                      key_img.new_full((pix.shape[0], 1), IMAX)], dim=1)
    return pix, keep & (flat.gather(1, pix.long()) == key)


def rasterize_unique(pix, ok, values, H: int, W: int):
    """Place the rows of `values` [B, N, F] at their flat pixels `pix`
    [B, N] where `ok` [B, N], whose pixels are unique within a scan (z-buffer
    winners): (canvas [B, H, W, F] float32, zeros elsewhere; mask [B, H, W]).
    The JAX version sorts and places tiles; with unique pixels a plain
    scatter is the same function."""
    B, N, F = values.shape
    b = torch.arange(B, device=pix.device)[:, None].expand(B, N)[ok]
    p = pix[ok].long()
    canvas = values.new_zeros((B, H * W, F), dtype=torch.float32)
    mask = torch.zeros((B, H * W), dtype=torch.bool, device=pix.device)
    canvas[b, p] = values[ok].float()
    mask[b, p] = True
    return canvas.reshape(B, H, W, F), mask.reshape(B, H, W)


def fill_canvas(values: torch.Tensor, winner: torch.Tensor, mask: torch.Tensor,
                fill: float = 0.0) -> torch.Tensor:
    """Each occupied pixel takes its winner's row of `values` [N, F]:
    [H, W, F], `fill` at empty pixels."""
    H, W = winner.shape
    rows = values[winner.clamp(min=0).reshape(-1).long()].reshape(H, W, -1)
    return torch.where(mask[..., None], rows, fill)
