"""KNN 2D → 3D label lifting (counterpart of `pmf_tpu/ops/knn.py`).

Each point looks at the S×S window of the projected range image around its
pixel, takes the k neighbours whose range differs least from its own
(weighted by an inverse Gaussian of the window offset), and votes their
predicted classes.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .reduce import argmax_last


def gaussian_kernel2d(kernel_size: int = 3, sigma: float = 2.0) -> np.ndarray:
    """Normalized 2D Gaussian."""
    ax = np.arange(kernel_size, dtype=np.float64)
    xx, yy = np.meshgrid(ax, ax, indexing="xy")
    mean = (kernel_size - 1) / 2.0
    var = sigma ** 2
    k = (1.0 / (2.0 * np.pi * var)) * np.exp(
        -((xx - mean) ** 2 + (yy - mean) ** 2) / (2.0 * var))
    return (k / k.sum()).astype(np.float32)


def _windows(img: torch.Tensor, search: int, idx: torch.Tensor) -> torch.Tensor:
    """The S×S zero-padded window of [H, W] `img` around each flat pixel
    `idx` [P], row-major over the window: [P, S*S]."""
    patches = F.unfold(img[None, None], search, padding=search // 2)[0]  # [S², HW]
    return patches.t()[idx]


def knn_postprocess(proj_range, unproj_range, proj_argmax, px, py, valid=None,
                    knn: int = 5, search: int = 5, sigma: float = 1.0,
                    cutoff: float = 1.0, nclasses: int = 20) -> torch.Tensor:
    """proj_range [H, W] (< 0 at empty pixels), unproj_range [P],
    proj_argmax [H, W] int, px/py [P] pixel col/row of each point, valid [P]
    (invalid points get class 0). Returns [P] int32 voted classes."""
    if search % 2 == 0:
        raise ValueError("Nearest neighbor kernel must be odd number")
    H, W = proj_range.shape
    center = (search * search - 1) // 2
    idx = (py.clamp(0, H - 1) * W + px.clamp(0, W - 1)).long()

    ranges = _windows(proj_range.float(), search, idx)
    ranges = torch.where(ranges < 0, torch.inf, ranges)
    ranges[:, center] = unproj_range
    inv_gauss = torch.from_numpy(
        1.0 - gaussian_kernel2d(search, sigma)).reshape(-1).to(ranges.device)
    k2 = (ranges - unproj_range[:, None]).abs() * inv_gauss

    # k smallest; the stable sort breaks ties by the lower window position,
    # as lax.top_k does
    knn_dist, knn_idx = torch.sort(k2, dim=1, stable=True)
    knn_dist, knn_idx = knn_dist[:, :knn], knn_idx[:, :knn]

    labels = _windows(proj_argmax.float(), search, idx).to(torch.int64)
    knn_argmax = labels.gather(1, knn_idx)
    if cutoff > 0:
        knn_argmax = torch.where(knn_dist > cutoff, nclasses, knn_argmax)

    # vote over classes 0..C (C: the bucket of neighbours past the cutoff),
    # never choosing unlabeled (0) or that bucket
    votes = F.one_hot(knn_argmax, nclasses + 1).sum(1).float()
    out = argmax_last(votes[:, 1:nclasses]) + 1
    if valid is not None:
        out = torch.where(valid, out, 0)
    return out.to(torch.int32)
