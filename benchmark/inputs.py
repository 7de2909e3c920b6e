"""The inputs of a run, made from its seed: synthetic SemanticKITTI-like
scans and the nets' weights. Both sides of a comparison get the same.

Scans (the port's `data/synthetic.py: make_inputs`, copied): points at
x 2-70 m, y ±20 m, z -2-1 m, intensity and a train-class label uniform, all
valid; a random RGB canvas 16 columns wider than the image; a pinhole
camera looking along +x with fx = 720 and its centre in the image, which
lands about 85 % of the points in it. The cell's `scans` group sets the
counts and sizes; every seed gives the same sizes, only the draws differ.

Weights (the rule of the port's `models/convert.py: random_weights`, drawn
on the device in three calls): conv kernels N(0, 1/fan_in), BN scales and
running variances U(0.5, 1.5), every other vector N(0, 0.1²); each layer
keeps its input's scale, so the classes depend on the input.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def scans(rng: np.random.Generator, batch: int, points: int, h: int, w: int,
          x=(2.0, 70.0), y=(-20.0, 20.0), z=(-2.0, 1.0), fx: float = 720.0,
          nclasses: int = 20):
    """(points [B, N, 4], labels [B, N], valid [B, N], proj [B, 3, 4],
    image [B, h, w + 16, 3], img_h [B], img_w [B]) as numpy arrays."""
    pts = np.zeros((batch, points, 4), np.float32)
    pts[..., 0] = rng.uniform(*x, (batch, points))
    pts[..., 1] = rng.uniform(*y, (batch, points))
    pts[..., 2] = rng.uniform(*z, (batch, points))
    pts[..., 3] = rng.uniform(0, 1, (batch, points))
    labels = rng.integers(0, nclasses, (batch, points)).astype(np.int32)
    valid = np.ones((batch, points), bool)
    proj = np.tile(np.array([[w / 2, -fx, 0, 0], [h / 2, 0, -fx, 0], [1, 0, 0, 0]],
                            np.float32)[None], (batch, 1, 1))
    image = rng.random((batch, h, w + 16, 3), dtype=np.float32)
    return (pts, labels, valid, proj, image, np.full((batch,), h, np.int32),
            np.full((batch,), w, np.int32))


def scan_pool(seed: int, n: int, group: dict, nclasses: int) -> list[tuple]:
    """`n` batches of the cell's `scans` group from `seed`, as numpy."""
    rng = np.random.default_rng(seed)
    args = {k: tuple(v) for k, v in group.items() if k in ("x", "y", "z")}
    return [scans(rng, group["batch"], group["points"], *group["image"], fx=group["fx"],
                  nclasses=nclasses, **args) for _ in range(n)]


def to_device(batch, dev) -> list[torch.Tensor]:
    return [torch.from_numpy(a).to(dev) for a in batch]


def weights(template: dict, seed: int, dev) -> dict:
    """A state_dict with `template`'s keys and shapes (a dict of tensors,
    e.g. on the meta device), float tensors drawn from `seed` on `dev`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kernels = {k: v for k, v in template.items() if v.is_floating_point() and v.dim() == 4}
    scales = {k: v for k, v in template.items() if v.is_floating_point() and v.dim() < 4
              and k.endswith(("running_var", "weight"))}
    others = {k: v for k, v in template.items() if v.is_floating_point() and v.dim() < 4
              and k not in scales}
    sd = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
          for k, v in template.items() if not v.is_floating_point()}
    for group, draw in ((kernels, torch.randn), (scales, torch.rand), (others, torch.randn)):
        flat = draw(sum(v.numel() for v in group.values()), generator=g, device=dev)
        at = 0
        for k, v in group.items():
            t = flat[at:at + v.numel()].view(v.shape)
            at += v.numel()
            if group is kernels:
                t = t / math.sqrt(v[0].numel())
            elif group is scales:
                t = t + 0.5
            else:
                t = t * 0.1
            sd[k] = t
    return sd
