"""Train-time RGB ColorJitter (counterpart of `pmf_tpu/data/jitter.py`),
on a batch of image canvases, on the device they lie on.

torchvision's tensor-mode ColorJitter: factors f ~ U[max(0, 1 − s), 1 + s]
for brightness, contrast and saturation, the three ops in a random order,
each clip(f·img + (1 − f)·ref, 0, 1) with ref = 0 (brightness), the mean
grey level of the true image (contrast) or the pixel's grey level
(saturation); grey = 0.2989 R + 0.587 G + 0.114 B. The canvas is padded
beyond (img_h, img_w): the contrast mean counts only the true image and
contrast leaves the padding as it is; the other two keep it at 0.
"""
from __future__ import annotations

import torch

from ..parallel import rand_rows

_GRAY = (0.2989, 0.587, 0.114)


def _gray(img: torch.Tensor) -> torch.Tensor:
    return (img * torch.tensor(_GRAY, dtype=img.dtype, device=img.device)).sum(
        dim=-1, keepdim=True)


def color_jitter_fixed(image, img_h, img_w, factors, order):
    """image [B, Hc, Wc, 3] in [0, 1], true extent img_h/img_w [B]; factors
    [B, 3] (brightness, contrast, saturation) and order [B, 3], a
    permutation of (0, 1, 2) per scan: op order[b, i] runs i-th."""
    B, Hc, Wc, _ = image.shape
    dev = image.device
    inb = ((torch.arange(Hc, device=dev) < img_h[:, None])[:, :, None]
           & (torch.arange(Wc, device=dev) < img_w[:, None])[:, None, :])[..., None]
    n_px = (img_h * img_w).float()
    factors = factors.float()
    for i in range(3):
        op = order[:, i].view(B, 1, 1, 1)
        f = factors.gather(1, order[:, i:i + 1].long()).view(B, 1, 1, 1)
        gray = _gray(image)
        mean = torch.where(inb, gray, 0.0).sum(dim=(1, 2, 3)) / n_px
        ref = torch.where(op == 2, gray, torch.where(op == 1, mean.view(B, 1, 1, 1), 0.0))
        out = (f * image + (1.0 - f) * ref).clamp(0.0, 1.0)
        image = torch.where(inb | (op != 1), out, image)
    return image


def jitter_params(generator: torch.Generator, batch: int, strength: tuple,
                  device: torch.device):
    """(factors [B, 3], order [B, 3]) drawn from `generator` (this process's
    rows of the global batch's draws: `parallel.rand_rows`)."""
    lo = torch.tensor([max(0.0, 1.0 - s) for s in strength], device=device)
    hi = torch.tensor([1.0 + s for s in strength], device=device)
    u = rand_rows((batch, 3), generator, device)
    order = rand_rows((batch, 3), generator, device).argsort(dim=1)
    return u * (hi - lo) + lo, order


def color_jitter(generator, image, img_h, img_w, strength: tuple = (0.4, 0.4, 0.4)):
    """`color_jitter_fixed` with factors and op order drawn from `generator`."""
    return color_jitter_fixed(image, img_h, img_w,
                              *jitter_params(generator, image.shape[0], strength, image.device))
