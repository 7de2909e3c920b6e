"""Synthetic nuScenes keyframes made from a seed (the rule of the port's
`data/synthetic.py: make_nuscenes_inputs`, copied, so the benchmark does
not import the port's synthetic data).

A keyframe is one sweep seen by six cameras: six (lidar, camera) items that
share its scan. The scan is a 32-beam sweep all around (pitch -30° to 10°)
of `returns` returns at 1-70 m, a tenth of them copies of others (ties in
the z-buffer), padded to `points`; labels uniform over the classes. Item
i's matrix is K · [R | 0] of a pinhole camera at the lidar's origin looking
along yaw -60° · i (fx = fy = 1266, cx = w / 2, cy = h / 2 at 1600x900):
65° of yaw each, so each camera sees about an eighth of the returns and the
six together about 70 %, with overlaps between neighbours. The image is
uniform noise in [0, 1).
"""
from __future__ import annotations

import numpy as np

YAW_DEG = -60.0                    # the six cameras' yaws, clockwise
FX = 1266.0                        # a nuScenes camera's focal length at 1600 px wide
CAMERAS = 6


def camera(yaw_deg: float, h: int, w: int):
    """(R [3, 3], K [3, 3]): R's rows the camera's right, down and forward."""
    t = np.deg2rad(yaw_deg)
    R = np.array([[np.sin(t), -np.cos(t), 0.0], [0.0, 0.0, -1.0], [np.cos(t), np.sin(t), 0.0]])
    fx = FX * w / 1600
    K = np.array([[fx, 0.0, w / 2], [0.0, fx, h / 2], [0.0, 0.0, 1.0]])
    return R, K


def keyframe(rng: np.random.Generator, points: int, returns: int, h: int, w: int,
             nclasses: int) -> list[dict]:
    """One keyframe's six items as `nuscenes_sample_reader`'s dicts (numpy:
    points [N, 4], labels [N], valid [N], proj_matrix [3, 4], image
    [h, w, 3], img_h, img_w); the items share the scan's arrays."""
    N = returns
    r = rng.uniform(1, 70, N)
    yaw = rng.uniform(-np.pi, np.pi, N)
    pitch = np.deg2rad(np.linspace(-30, 10, 32))[rng.integers(0, 32, N)]
    pts = np.zeros((points, 4), np.float32)
    pts[:N] = np.stack([r * np.cos(pitch) * np.cos(yaw), r * np.cos(pitch) * np.sin(yaw),
                        r * np.sin(pitch), rng.uniform(0, 1, N)], -1)
    pts[N // 2:N // 2 + N // 10] = pts[:N // 10]
    labels = np.zeros(points, np.int32)
    labels[:N] = rng.integers(0, nclasses, N)
    valid = np.zeros(points, bool)
    valid[:N] = True
    items = []
    for i in range(CAMERAS):
        R, K = camera(i * YAW_DEG, h, w)
        proj = np.concatenate([K @ R, np.zeros((3, 1))], axis=1).astype(np.float32)
        items.append({"points": pts, "labels": labels, "valid": valid, "proj_matrix": proj,
                      "image": rng.random((h, w, 3), dtype=np.float32),
                      "img_h": np.int32(h), "img_w": np.int32(w)})
    return items


def pool(seed: int, n: int, group: dict, nclasses: int) -> list[list[dict]]:
    """`n` keyframes of the cell's `scans` group from `seed`."""
    rng = np.random.default_rng(seed)
    return [keyframe(rng, group["points"], group["returns"], *group["image"], nclasses)
            for _ in range(n)]
