"""Synthetic KITTI-like scans at the eval benchmark's sizes, made from a
numpy generator.

The points, labels and image are drawn as `bench.py: make_inputs` draws
them (x 2-70 m, y ±20 m, z -2-1 m; a random RGB canvas 16 columns wider
than the image). The projection differs: bench's matrix
[[fx, -fx, 0, w·fx/2], [0, 0, -fx, h·fx/2], [1, 0, 0, 0]] sends every point
off the image (u > 6800 px on a 1232-px image), which leaves the z-buffer
nothing to do. Here it is a pinhole looking along +x with fx = 720 and its
centre at (w/2, h/2): u = w/2 − fx·y/x, v = h/2 − fx·z/x, which lands about
85% of the points in the image.
"""
from __future__ import annotations

import numpy as np

BATCH = 8
N_POINTS = 32768
H, W = 384, 1232


def make_inputs(rng: np.random.Generator, batch: int = BATCH,
                n_points: int = N_POINTS, h: int = H, w: int = W):
    """(points [B, N, 4], labels [B, N], valid [B, N], proj [B, 3, 4],
    image [B, h, w + 16, 3], img_h [B], img_w [B]) as numpy arrays."""
    pts = np.zeros((batch, n_points, 4), np.float32)
    pts[..., 0] = rng.uniform(2, 70, (batch, n_points))
    pts[..., 1] = rng.uniform(-20, 20, (batch, n_points))
    pts[..., 2] = rng.uniform(-2, 1, (batch, n_points))
    pts[..., 3] = rng.uniform(0, 1, (batch, n_points))
    labels = rng.integers(0, 20, (batch, n_points)).astype(np.int32)
    valid = np.ones((batch, n_points), bool)
    fx = 720.0
    proj = np.tile(np.array(
        [[w / 2, -fx, 0, 0], [h / 2, 0, -fx, 0], [1, 0, 0, 0]],
        np.float32)[None], (batch, 1, 1))
    image = rng.random((batch, h, w + 16, 3)).astype(np.float32)
    img_h = np.full((batch,), h, np.int32)
    img_w = np.full((batch,), w, np.int32)
    return pts, labels, valid, proj, image, img_h, img_w


def make_range_inputs(rng: np.random.Generator, batch: int, n_points: int,
                      n_valid: int | None = None):
    """(points [B, N, 4], labels [B, N], valid [B, N]) as numpy arrays: the
    returns of a 64-beam sensor all around it, at 2-80 m and pitch -26° to
    4° (a little beyond SalsaNext's 3°/-25° field of view), a tenth of them
    copies of others (ties in the z-buffer), the first `n_valid` valid (all
    by default) and the rest padding."""
    r = rng.uniform(2, 80, (batch, n_points))
    yaw = rng.uniform(-np.pi, np.pi, (batch, n_points))
    pitch = np.deg2rad(rng.uniform(-26, 4, (batch, n_points)))
    pts = np.stack([r * np.cos(pitch) * np.cos(yaw), r * np.cos(pitch) * np.sin(yaw),
                    r * np.sin(pitch), rng.uniform(0, 1, (batch, n_points))], -1).astype(np.float32)
    pts[:, n_points // 2:n_points // 2 + n_points // 10] = pts[:, :n_points // 10]
    labels = rng.integers(0, 20, (batch, n_points)).astype(np.int32)
    valid = np.zeros((batch, n_points), bool)
    valid[:, :n_points if n_valid is None else n_valid] = True
    return pts, labels, valid
