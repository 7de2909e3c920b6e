"""Synthetic KITTI-like scans at the eval benchmark's sizes, range-view
scans, and nuScenes-like keyframes, made from a numpy generator in memory
(no files, no PIL).

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


NUSC_YAW_DEG = -60.0                              # the six cameras' yaws, clockwise
NUSC_FX, NUSC_CX, NUSC_CY = 1266.0, 800.0, 450.0  # a nuScenes camera's intrinsic at 1600x900


def nuscenes_camera(yaw_deg: float, h: int = 900, w: int = 1600):
    """(R [3, 3], K [3, 3]) of a pinhole camera at the lidar's origin
    looking along yaw `yaw_deg` in the lidar's x-y plane (z up): R's rows
    the camera's right, down and forward; K nuScenes' intrinsic scaled to a
    w-pixel-wide image, centred on it."""
    t = np.deg2rad(yaw_deg)
    R = np.array([[np.sin(t), -np.cos(t), 0.0], [0.0, 0.0, -1.0], [np.cos(t), np.sin(t), 0.0]])
    fx = NUSC_FX * w / 1600
    K = np.array([[fx, 0.0, w / 2], [0.0, fx, h / 2], [0.0, 0.0, 1.0]])
    return R, K


def make_nuscenes_inputs(rng: np.random.Generator, n_frames: int = 1, n_points: int = 65536,
                         n_returns: int = 34720, h: int = 900, w: int = 1600):
    """nuScenes-like keyframes, one item per (lidar, camera) pair, six
    consecutive items a keyframe in nuScenes' camera order, as the numpy
    arrays of `make_inputs` (points [B, N, 4], labels [B, N], valid [B, N],
    proj [B, 3, 4], image [B, h, w, 3], img_h [B], img_w [B], B = 6 ·
    n_frames); the six items of a keyframe share its scan. A scan is a
    32-beam sweep all around (pitch -30° to 10°) of `n_returns` returns at
    1-70 m, a tenth of them copies of others (ties in the z-buffer), padded
    to `n_points`; 17-class labels. Item i's matrix is K · [R | 0] of
    `nuscenes_camera(-60° · i)` (fx = fy = 1266, cx = 800, cy = 450 at
    1600x900): 65° of yaw each, so each camera sees about an eighth of the
    returns and the six together about 70 %."""
    F, N = n_frames, n_returns
    r = rng.uniform(1, 70, (F, N))
    yaw = rng.uniform(-np.pi, np.pi, (F, N))
    pitch = np.deg2rad(np.linspace(-30, 10, 32))[rng.integers(0, 32, (F, N))]
    pts = np.zeros((F, n_points, 4), np.float32)
    pts[:, :N] = np.stack([r * np.cos(pitch) * np.cos(yaw), r * np.cos(pitch) * np.sin(yaw),
                           r * np.sin(pitch), rng.uniform(0, 1, (F, N))], -1)
    pts[:, N // 2:N // 2 + N // 10] = pts[:, :N // 10]
    labels = np.zeros((F, n_points), np.int32)
    labels[:, :N] = rng.integers(0, 17, (F, N))
    valid = np.zeros((F, n_points), bool)
    valid[:, :N] = True
    cams = []
    for i in range(6):
        R, K = nuscenes_camera(i * NUSC_YAW_DEG, h, w)
        cams.append(np.concatenate([K @ R, np.zeros((3, 1))], axis=1))
    rep = lambda a: np.repeat(a, 6, axis=0)
    image = rng.random((6 * F, h, w, 3), dtype=np.float32)
    return (rep(pts), rep(labels), rep(valid), np.tile(np.stack(cams), (F, 1, 1)).astype(np.float32),
            image, np.full((6 * F,), h, np.int32), np.full((6 * F,), w, np.int32))


def nuscenes_camera_frame(points: np.ndarray, h: int = 900, w: int = 1600):
    """The items of `make_nuscenes_inputs` (points [B, N, 4], item b seen by
    camera b mod 6) as NuscenesV2's reader gives them to the V2 view's
    camera frame: (points with xyz in the item's camera frame, proj
    [B, 3, 4] = [K | 0], fovs [B, 2] its camera's yaw field of view in
    radians, FOV_ANGLE_V2's)."""
    from .nuscenes import CAMERAS, FOV_ANGLE_V2

    out = points.copy()
    proj = np.zeros((len(points), 3, 4), np.float32)
    fovs = np.zeros((len(points), 2), np.float32)
    for b in range(len(points)):
        R, K = nuscenes_camera((b % 6) * NUSC_YAW_DEG, h, w)
        out[b, :, :3] = points[b, :, :3] @ R.T
        proj[b, :, :3] = K
        fovs[b] = np.deg2rad(FOV_ANGLE_V2[CAMERAS[b % 6]])
    return out, proj, fovs
