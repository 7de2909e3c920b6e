"""ASPP's four conv branches (1×1, and 3×3 dilated three ways) in one launch.

The CUDA kernel is `csrc/aspp.cu`. It replaces no TPU kernel: the JAX
package leaves these convs to XLA. It was added because cuDNN runs the
dilated 3×3 convs of EPMF's camera-decoder ASPP (512 channels on layer4's
20×80 map, batch 8) on its direct kernel, which held 112 of 174 ms of an
EPMF eval call (65 %) on an H100.

What bounds it: operations. On a map of few rows most taps of a wide
dilation read only zero padding; the products of the taps that reach the
map come to about 106 GFLOP at EPMF's camera shape, 0.11 ms at the card's
989 TFLOP/s in bf16, while its bytes (input, weights, the four outputs:
about 80 MB) take 24 us at 3.35 TB/s.

Design: an implicit GEMM over NHWC bf16. M is the output pixels (N·H·W),
N the 4 branches × C output channels, K the live taps × C input channels.
Each block computes one tile of 128 pixels by 128 or 256 channels of one
branch, and walks only the taps that `aspp_plan` found live for its pixels:
those that read at least one in-map pixel for some pixel of the tile. A
live tap's out-of-map reads load as zeros (cp.async zero fill), exactly as
the padding does, so skipping a dead tap drops only products with zero.
Operands go by cp.async into a ring of 128-byte-swizzled shared-memory
stages and into `wgmma` (m64nNk16, bf16 in, fp32 sums) on two warpgroups.
The epilogue adds the fp32 bias, rounds once to bf16 and stores each branch
into its channel slice [C·(1+b), C·(2+b)) of the caller's NHWC
[N, H, W, 5C] concat buffer, whose slice [0, C) takes the pooled branch:
no `torch.cat`. Tiles go heavy-first (most live taps first), so the last
wave is not the 9-tap edge tiles alone.

`aspp_branches_plain` is the same function in plain PyTorch (the four
convs, written into the same slices): the CPU path and the yardstick the
kernel is held to on the card.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import kernels

BM = 128  # output pixels a tile


def tap_offsets(branch: int, dilations) -> list[tuple[int, int]]:
    """(dy, dx) of each tap of `branch` (0: the 1×1, then one per dilation),
    taps in row-major order of the 3×3 kernel."""
    if branch == 0:
        return [(0, 0)]
    d = dilations[branch - 1]
    return [((t // 3 - 1) * d, (t % 3 - 1) * d) for t in range(9)]


def tile_n(m: int, c: int, sms: int) -> int:
    """Output channels a tile: 256 where 128x256 tiles still give each of the
    card's `sms` multiprocessors two, else 128 (more tiles for small maps
    and batches)."""
    if c % 256 == 0 and -(-m // BM) * 4 * (c // 256) >= 2 * sms:
        return 256
    return 128


def live_flops(nb: int, h: int, w: int, c: int, dilations) -> int:
    """The products the four branches need: 2·C·C for each (output pixel,
    tap) whose read lies in the map; the kernel's least work, whatever its
    tiles."""
    y, x = np.arange(h)[:, None], np.arange(w)[None, :]
    live = sum(int(((y + dy >= 0) & (y + dy < h) & (x + dx >= 0) & (x + dx < w)).sum())
               for b in range(4) for dy, dx in tap_offsets(b, dilations))
    return 2 * c * c * nb * live


def aspp_plan(nb: int, h: int, w: int, c: int, dilations, bm: int = BM,
              bn: int = 128) -> np.ndarray:
    """The kernel's work list: one row (pixel tile, branch, channel tile,
    live-tap mask) a block, int32 [items, 4]. Tile i holds the flat output
    pixels [i·bm, (i+1)·bm) of N·H·W; bit t of the mask is set when tap t
    (the 1×1 branch: bit 4, the centre) reads an in-map pixel for at least
    one pixel of the tile. Rows are ordered by live taps, most first."""
    m = nb * h * w
    p = np.arange(m)
    y, x = (p // w) % h, p % w
    starts = np.arange(0, m, bm)
    rows = []
    for branch in range(4):
        taps = [4] if branch == 0 else range(9)
        mask = np.zeros(len(starts), np.int64)
        for t, (dy, dx) in zip(taps, tap_offsets(branch, dilations)):
            ok = (y + dy >= 0) & (y + dy < h) & (x + dx >= 0) & (x + dx < w)
            mask |= np.logical_or.reduceat(ok, starts).astype(np.int64) << t
        for nt in range(c // bn):
            rows.append(np.stack([np.arange(len(starts)), np.full(len(starts), branch),
                                  np.full(len(starts), nt), mask], 1))
    plan = np.concatenate(rows)
    live = np.array([bin(int(v)).count("1") for v in plan[:, 3]])
    return plan[np.argsort(-live, kind="stable")].astype(np.int32)


def aspp_branches_plain(x: torch.Tensor, weights, biases, dilations,
                        out: torch.Tensor) -> torch.Tensor:
    """x [N, C, H, W]; weights/biases: the 1×1 branch's and those of the 3×3
    branches dilated `dilations`; out [N, H, W, 5C]. Writes branch b's conv
    (weights and bias cast to x's dtype, as `layers.Conv2d` runs it) into
    out[..., C·(1+b):C·(2+b)] and returns out."""
    c = x.shape[1]
    for b, (wt, bias) in enumerate(zip(weights, biases)):
        d = dilations[b - 1] if b else 1
        y = F.conv2d(x, wt.to(x.dtype), bias.to(x.dtype), padding=d if b else 0, dilation=d)
        out[..., c * (1 + b):c * (2 + b)] = y.permute(0, 2, 3, 1)
    return out


@functools.lru_cache(maxsize=32)
def _plan_on(device: torch.device, nb: int, h: int, w: int, c: int, dilations: tuple,
             bn: int) -> torch.Tensor:
    return torch.from_numpy(aspp_plan(nb, h, w, c, dilations, BM, bn)).to(device)


def pack_weights(weights, biases) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's operands: bf16 [1 + 27, C, C] (the 1×1 branch's kernel,
    then each dilated branch's 9 taps, row-major; each [Cout, Cin]) and the
    float32 biases [4, C]."""
    c = weights[0].shape[0]
    packed = weights[0].new_empty((28, c, c), dtype=torch.bfloat16)
    packed[0].copy_(weights[0].reshape(c, c))
    for b in range(1, 4):
        packed[1 + 9 * (b - 1):1 + 9 * b].copy_(weights[b].permute(2, 3, 0, 1).reshape(9, c, c))
    return packed, torch.stack([b.float() for b in biases])


def aspp_takes(x: torch.Tensor) -> bool:
    """Whether the kernel takes x: a CUDA bf16 [N, C, H, W] with C a
    multiple of 128 (its channel tiles)."""
    return x.is_cuda and x.dtype == torch.bfloat16 and x.shape[1] % 128 == 0


def aspp_branches(x: torch.Tensor, weights, biases, dilations,
                  out: torch.Tensor) -> torch.Tensor:
    """`aspp_branches_plain` on the CPU; on CUDA tensors one launch of the
    kernel, which takes bf16 x with C a multiple of 128, a 1×1 branch and
    three 3×3 ones of C in and out channels, and raises on anything else (it
    does not fall back)."""
    if x.is_cpu:
        return aspp_branches_plain(x, weights, biases, dilations, out)
    nb, c, h, w = x.shape
    if (not aspp_takes(x) or len(weights) != 4 or len(dilations) != 3
            or [tuple(wt.shape) for wt in weights] != [(c, c, 1, 1)] + [(c, c, 3, 3)] * 3):
        raise ValueError(f"aspp_branches takes bf16 x with C a multiple of 128, a 1x1 branch "
                         f"and three 3x3 ones of C in and out channels; got {x.dtype}, C={c}, "
                         f"{[tuple(wt.shape) for wt in weights]}")
    kernels.check(out, "out", torch.bfloat16, (nb, h, w, 5 * c), x.device)
    xh = x.permute(0, 2, 3, 1).contiguous()
    packed, bias = pack_weights(weights, biases)
    bn = tile_n(nb * h * w, c, kernels.sms(x.device))
    plan = _plan_on(x.device, nb, h, w, c, tuple(dilations), bn)
    kernels.launch("pmf_aspp_branches", x.device, xh.data_ptr(), packed.data_ptr(),
                   bias.data_ptr(), out.data_ptr(), plan.data_ptr(), plan.shape[0],
                   nb * h * w, h, w, c, *dilations, bn)
    aspp_branches.launches += 1
    return out


aspp_branches.launches = 0
