"""3D point augmentation (counterpart of `pmf_tpu/data/augment.py`).

Per scan of a batch: a flip of x and of y, each with its probability, then
a translation along each axis, then an intrinsic z-y-x Euler rotation
(yaw, pitch, roll in degrees), each present with its probability and
uniform in its range, applied as `xyz @ R.T`. Extra point columns
(intensity) pass through. The draws come from a `torch.Generator`, or from
a `PointAugParams` that fixes them.

A draw in [lo, hi) is max(lo, lo + (hi - lo)·u) for u uniform in [0, 1), as
`jax.random.uniform` computes it: with reversed bounds (lo > hi, as
`salsanext_kitti.yaml` gives the yaw) it is always lo.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import NamedTuple

import torch

from ..parallel import rand_rows


@dataclass(frozen=True)
class AugmentConfig:
    """The YAML `augmentation` group's point augmentation: probabilities
    and ranges (translations in metres, angles in degrees)."""
    p_flipx: float = 0.0
    p_flipy: float = 0.0
    p_transx: float = 0.0
    trans_xmin: float = 0.0
    trans_xmax: float = 0.0
    p_transy: float = 0.0
    trans_ymin: float = 0.0
    trans_ymax: float = 0.0
    p_transz: float = 0.0
    trans_zmin: float = 0.0
    trans_zmax: float = 0.0
    p_rot_roll: float = 0.0
    rot_rollmin: float = 0.0
    rot_rollmax: float = 0.0
    p_rot_pitch: float = 0.0
    rot_pitchmin: float = 0.0
    rot_pitchmax: float = 0.0
    p_rot_yaw: float = 0.0
    rot_yawmin: float = 0.0
    rot_yawmax: float = 0.0

    @classmethod
    def from_dict(cls, d: dict) -> "AugmentConfig":
        """The fields found in `d`, as floats; other keys are ignored."""
        names = {f.name for f in fields(cls)}
        return cls(**{k: float(v) for k, v in d.items() if k in names})


class PointAugParams(NamedTuple):
    """The augmentation of each scan: axis signs [B, 3] (-1 where flipped),
    translation [B, 3], and yaw, pitch, roll [B] in degrees."""
    sign: torch.Tensor
    translation: torch.Tensor
    yaw: torch.Tensor
    pitch: torch.Tensor
    roll: torch.Tensor


def _euler_zyx(yaw, pitch, roll):
    """Rotation matrices [B, 3, 3] of intrinsic z-y-x Euler angles [B] in
    degrees: Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    d2r = math.pi / 180.0
    cy, sy = torch.cos(yaw * d2r), torch.sin(yaw * d2r)
    cp, sp = torch.cos(pitch * d2r), torch.sin(pitch * d2r)
    cr, sr = torch.cos(roll * d2r), torch.sin(roll * d2r)
    zero, one = torch.zeros_like(cy), torch.ones_like(cy)
    mat = lambda *rows: torch.stack([torch.stack(r, -1) for r in rows], -2)
    rz = mat((cy, -sy, zero), (sy, cy, zero), (zero, zero, one))
    ry = mat((cp, zero, sp), (zero, one, zero), (-sp, zero, cp))
    rx = mat((one, zero, zero), (zero, cr, -sr), (zero, sr, cr))
    return rz @ ry @ rx


def draw_point_aug(generator: torch.Generator, batch: int, cfg: AugmentConfig,
                   device=None) -> PointAugParams:
    """The augmentation of `batch` scans drawn from `generator` (this
    process's rows of the global batch's draws: `parallel.rand_rows`)."""
    u = rand_rows((batch, 14), generator, device)

    def maybe(i, p, lo, hi):
        # u[:, i] < p decides; u[:, i + 1] draws the value, as jax.random.uniform
        v = torch.clamp(lo + (hi - lo) * u[:, i + 1], min=lo)
        return torch.where(u[:, i] < p, v, 0.0)

    sign = torch.stack([torch.where(u[:, 0] < cfg.p_flipx, -1.0, 1.0),
                        torch.where(u[:, 1] < cfg.p_flipy, -1.0, 1.0),
                        torch.ones_like(u[:, 0])], -1)
    t = torch.stack([maybe(2, cfg.p_transx, cfg.trans_xmin, cfg.trans_xmax),
                     maybe(4, cfg.p_transy, cfg.trans_ymin, cfg.trans_ymax),
                     maybe(6, cfg.p_transz, cfg.trans_zmin, cfg.trans_zmax)], -1)
    roll = maybe(8, cfg.p_rot_roll, cfg.rot_rollmin, cfg.rot_rollmax)
    pitch = maybe(10, cfg.p_rot_pitch, cfg.rot_pitchmin, cfg.rot_pitchmax)
    yaw = maybe(12, cfg.p_rot_yaw, cfg.rot_yawmin, cfg.rot_yawmax)
    return PointAugParams(sign, t, yaw, pitch, roll)


def augment_pointcloud(points: torch.Tensor, cfg: AugmentConfig,
                       generator: torch.Generator | None = None,
                       params: PointAugParams | None = None) -> torch.Tensor:
    """points [B, N, >=3] flipped, translated and rotated per scan, with the
    draws of `params`, or drawn from `generator`."""
    if params is None:
        if generator is None:
            raise ValueError("the point augmentation draws from a torch.Generator")
        params = draw_point_aug(generator, points.shape[0], cfg, points.device)
    xyz = points[..., :3] * params.sign[:, None, :] + params.translation[:, None, :]
    rot = _euler_zyx(params.yaw, params.pitch, params.roll)
    xyz = xyz @ rot.transpose(1, 2)
    return torch.cat([xyz, points[..., 3:]], dim=-1)
