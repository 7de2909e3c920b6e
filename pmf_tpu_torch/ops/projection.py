"""Point-cloud → camera-image and range-image projections (counterpart of
`pmf_tpu/ops/projection.py`).

The functions take fixed-size padded point buffers with a validity mask and
return per-point pixel coordinates plus a keep mask; a leading batch
dimension is allowed ([..., N, 3] points with [..., 3, 4] matrices and
[...] image sizes).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def read_kitti_calib(calib_path: str) -> np.ndarray:
    """Parse a KITTI calib.txt and return the 3x4 camera projection P2 @ Tr."""
    calib = {}
    with open(calib_path) as f:
        for line in f:
            if line == "\n":
                break
            key, value = line.split(":", 1)
            calib[key] = np.array([float(x) for x in value.split()])
    P2 = calib["P2"].reshape(3, 4)
    Tr = np.identity(4)
    Tr[:3, :4] = calib["Tr"].reshape(3, 4)
    return (P2 @ Tr).astype(np.float32)


def _project(points: torch.Tensor, proj_matrix: torch.Tensor) -> torch.Tensor:
    # an elementwise product summed in x, y, z order plus the translation
    # row: the reference's order, so pixel indices match it bit for bit
    Pt = proj_matrix.transpose(-1, -2)[..., None, :, :]       # [..., 1, 4, 3]
    return (points[..., :3, None] * Pt[..., :3, :]).sum(-2) + Pt[..., 3, :]


def _per_scan(size):
    # a [B] tensor of image sizes broadcasts against [B, N] coordinates
    return size[..., None] if torch.is_tensor(size) and size.dim() else size


def perspective_project(points, proj_matrix, img_h, img_w, valid=None):
    """Keep points in front of the vehicle (x > 0.5), landing strictly
    inside the image, and valid. Returns (rows, cols) float32 and keep."""
    img_h, img_w = _per_scan(img_h), _per_scan(img_w)
    keep = points[..., 0] > 0.5
    if valid is not None:
        keep = keep & valid
    uvw = _project(points, proj_matrix)
    w = torch.where(uvw[..., 2].abs() > 1e-9, uvw[..., 2], 1e-9)
    u = uvw[..., 0] / w
    v = uvw[..., 1] / w
    keep = keep & (u > 0) & (u < img_w) & (v > 0) & (v < img_h)
    return v, u, keep


def perspective_project_cam(points, proj_matrix, img_h, img_w,
                            min_depth: float = 1.0, margin: float = 1.0,
                            valid=None):
    """Camera-frame depth test (w > min_depth) and a `margin`-pixel image
    border (nuScenes style). Returns (rows, cols, keep)."""
    img_h, img_w = _per_scan(img_h), _per_scan(img_w)
    uvw = _project(points, proj_matrix)
    w = uvw[..., 2]
    keep = w > min_depth
    if valid is not None:
        keep = keep & valid
    safe_w = torch.where(w.abs() > 1e-9, w, 1e-9)
    u = uvw[..., 0] / safe_w
    v = uvw[..., 1] / safe_w
    keep = keep & (u > margin) & (u < img_w - margin) & (v > margin) & \
        (v < img_h - margin)
    return v, u, keep


def yaw_crop_project(points, proj_matrix, fov_left: float = -math.pi / 4,
                     fov_right: float = math.pi / 4, valid=None):
    """The EPMF view's crop: keep points with range > 0.5 m and yaw
    -atan2(y, x) in [fov_left, fov_right], and valid; project them with no
    image-bound test (the view takes their tight box). Returns (rows, cols)
    float32 and keep."""
    depth = torch.linalg.vector_norm(points[..., :3], dim=-1)
    yaw = -torch.atan2(points[..., 1], points[..., 0])
    keep = (depth > 0.5) & (yaw >= fov_left) & (yaw <= fov_right)
    if valid is not None:
        keep = keep & valid
    uvw = _project(points, proj_matrix)
    w = torch.where(uvw[..., 2].abs() > 1e-9, uvw[..., 2], 1e-9)
    return uvw[..., 1] / w, uvw[..., 0] / w, keep


def cam_frame_crop_project(points, proj_matrix, fov_left, fov_right, min_depth: float = 0.1,
                           valid=None):
    """The EPMF view's crop of points already in the camera frame (nuScenes,
    `V2Config.cam_frame`): keep points with depth z > min_depth and yaw
    -atan2(z, x) in [fov_left - π/2, fov_right - π/2], and valid; project
    them with no image-bound test. The bounds are floats or [..., 1]
    tensors (one pair per scan). Returns (rows, cols) float32 and keep."""
    keep = points[..., 2] > min_depth
    if valid is not None:
        keep = keep & valid
    yaw = -torch.atan2(points[..., 2], points[..., 0])
    half_pi = math.pi / 2.0
    keep = keep & (yaw >= fov_left - half_pi) & (yaw <= fov_right - half_pi)
    uvw = _project(points, proj_matrix)
    w = torch.where(uvw[..., 2].abs() > 1e-9, uvw[..., 2], 1e-9)
    return uvw[..., 1] / w, uvw[..., 0] / w, keep


def spherical_project(points, fov_up_deg: float, fov_down_deg: float, proj_h: int,
                      proj_w: int, fov_left_deg: float = -180.0, fov_right_deg: float = 180.0,
                      valid=None):
    """The range-image projection: yaw -atan2(y, x) and pitch asin(z / r)
    mapped onto a proj_h x proj_w grid spanning the field of view, floored
    and clamped into it. The field of view's constants are Python doubles,
    used in float32 operations, as pmf_tpu computes them. pmf_tpu's range
    sqrt(x*x + y*y + z*z), whose sums XLA fuses, is within an ulp of
    `vector_norm`'s.

    points [..., N, >=3]. Returns px (column), py (row) [..., N] int32, the
    range depth [..., N] float32 and keep (= valid, all True without it).
    """
    fov_up = fov_up_deg / 180.0 * math.pi
    fov_down = fov_down_deg / 180.0 * math.pi
    fov_v = abs(fov_up) + abs(fov_down)
    fov_left = fov_left_deg / 180.0 * math.pi
    fov_right = fov_right_deg / 180.0 * math.pi
    fov_h = abs(fov_left) + abs(fov_right)

    depth = torch.linalg.vector_norm(points[..., :3], dim=-1)
    yaw = -torch.atan2(points[..., 1], points[..., 0])
    pitch = torch.asin(torch.clamp(points[..., 2] / depth.clamp(min=1e-9), -1.0, 1.0))
    proj_x = (yaw + abs(fov_left)) / fov_h * proj_w
    proj_y = (1.0 - (pitch + abs(fov_down)) / fov_v) * proj_h
    px = torch.clamp(torch.floor(proj_x), 0, proj_w - 1).to(torch.int32)
    py = torch.clamp(torch.floor(proj_y), 0, proj_h - 1).to(torch.int32)
    keep = torch.ones_like(px, dtype=torch.bool) if valid is None else valid
    return px, py, depth, keep
