"""SalsaNext's range view in plain PyTorch: the 3D point augmentation of
training, the spherical projection, a per-scan z-buffer, the fill and the
normalization.

  feature [B, H, W, 5] = range, x, y, z, intensity ((v - mean) / std, 0 at
                         empty pixels)
  label   [B, H, W]    = the winning point's train-class id (0 = empty)
  mask    [B, H, W]    = pixels where a point landed

Per scan, the augmentation flips x and y, translates along each axis and
rotates by intrinsic z-y-x Euler angles (yaw, pitch, roll in degrees),
each with its probability, from 14 uniforms a scan drawn from a
`torch.Generator` in the port's order: flip x, flip y, then a (gate,
value) pair for the translations along x, y, z, the roll, the pitch and
the yaw. A value in [lo, hi) is max(lo, lo + (hi - lo)·u), as the JAX
package's `jax.random.uniform` gives it, so the yaml's reversed yaw bounds
(`rot_yawmin: 5`, `rot_yawmax: -5`) give a yaw of 5° wherever the yaw is
drawn: read as the port and `pmf_tpu` read them.

The z-buffer sorts each scan's points stably by (pixel, depth quantum):
the nearest point wins its pixel, the lowest index on ties. Depths are
compared in quanta of 1/64 m, capped at 2^(31 − b) − 1 quanta for b =
ceil(log2 N) index bits: the resolution at which the port's packed keys
compare them.

The arithmetic that decides a pixel (the flips and translation, the
rotation matrix as Rz·Ry·Rx and its product with the points, the range as
a vector norm, the angles and their scaling with the field of view's
constants as Python doubles) follows the port's order of float operations,
so the view agrees with the port's bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from .salsanext import float32

DEPTH_QUANT = 1.0 / 64.0
AUGMENT_KEYS = ("p_flipx", "p_flipy", "p_transx", "trans_xmin", "trans_xmax", "p_transy",
                "trans_ymin", "trans_ymax", "p_transz", "trans_zmin", "trans_zmax",
                "p_rot_roll", "rot_rollmin", "rot_rollmax", "p_rot_pitch", "rot_pitchmin",
                "rot_pitchmax", "p_rot_yaw", "rot_yawmin", "rot_yawmax")


@dataclass(frozen=True)
class RangeView:
    """The view's geometry (a configuration's `view` group) and its
    augmentation (the `augmentation` group: probabilities, metres,
    degrees; a key left out is 0)."""
    proj_h: int
    proj_w: int
    fov_up: float
    fov_down: float
    fov_left: float
    fov_right: float
    img_mean: tuple
    img_stds: tuple
    augment: dict = field(default_factory=dict)

    @classmethod
    def from_config(cls, cfg: dict) -> "RangeView":
        v = cfg["view"]
        return cls(v["proj_h"], v["proj_w"], float(v["fov_up"]), float(v["fov_down"]),
                   float(v["fov_left"]), float(v["fov_right"]), tuple(v["img_mean"]),
                   tuple(v["img_stds"]),
                   {k: float(cfg["augmentation"].get(k, 0.0)) for k in AUGMENT_KEYS})


def draws(g: torch.Generator, batch: int, dev) -> torch.Tensor:
    """The augmentation's [batch, 14] uniforms, drawn from `g`."""
    return torch.rand((batch, 14), generator=g, device=dev)


def _rotation(yaw, pitch, roll):
    """Rz(yaw) @ Ry(pitch) @ Rx(roll), [B, 3, 3], angles in degrees."""
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


def augment(points: torch.Tensor, a: dict, u: torch.Tensor) -> torch.Tensor:
    """points [B, N, 4] flipped, translated and rotated per scan by the
    draws u [B, 14]; intensity passes through."""

    def maybe(i, p, lo, hi):
        value = torch.clamp(lo + (hi - lo) * u[:, i + 1], min=lo)
        return torch.where(u[:, i] < p, value, 0.0)

    sign = torch.stack([torch.where(u[:, 0] < a["p_flipx"], -1.0, 1.0),
                        torch.where(u[:, 1] < a["p_flipy"], -1.0, 1.0),
                        torch.ones_like(u[:, 0])], -1)
    shift = torch.stack([maybe(2, a["p_transx"], a["trans_xmin"], a["trans_xmax"]),
                         maybe(4, a["p_transy"], a["trans_ymin"], a["trans_ymax"]),
                         maybe(6, a["p_transz"], a["trans_zmin"], a["trans_zmax"])], -1)
    roll = maybe(8, a["p_rot_roll"], a["rot_rollmin"], a["rot_rollmax"])
    pitch = maybe(10, a["p_rot_pitch"], a["rot_pitchmin"], a["rot_pitchmax"])
    yaw = maybe(12, a["p_rot_yaw"], a["rot_yawmin"], a["rot_yawmax"])
    xyz = points[..., :3] * sign[:, None, :] + shift[:, None, :]
    xyz = xyz @ _rotation(yaw, pitch, roll).transpose(1, 2)
    return torch.cat([xyz, points[..., 3:]], dim=-1)


def project(points: torch.Tensor, view: RangeView):
    """(column, row) int32 of each point on the proj_h x proj_w grid, by yaw
    −atan2(y, x) and pitch asin(z / r), floored and clamped into it; and
    its range r."""
    up, down = view.fov_up / 180.0 * math.pi, view.fov_down / 180.0 * math.pi
    left, right = view.fov_left / 180.0 * math.pi, view.fov_right / 180.0 * math.pi
    fov_v, fov_h = abs(up) + abs(down), abs(left) + abs(right)
    depth = torch.linalg.vector_norm(points[..., :3], dim=-1)
    yaw = -torch.atan2(points[..., 1], points[..., 0])
    pitch = torch.asin(torch.clamp(points[..., 2] / depth.clamp(min=1e-9), -1.0, 1.0))
    x = (yaw + abs(left)) / fov_h * view.proj_w
    y = (1.0 - (pitch + abs(down)) / fov_v) * view.proj_h
    px = torch.clamp(torch.floor(x), 0, view.proj_w - 1).to(torch.int32)
    py = torch.clamp(torch.floor(y), 0, view.proj_h - 1).to(torch.int32)
    return px, py, depth


def zbuffer(pix: torch.Tensor, depth: torch.Tensor, keep: torch.Tensor, hw: int):
    """The winning point of each of a scan's hw pixels (pix [N] flat, depth
    and keep [N]), −1 where none landed: the nearest by depth quantum, the
    lowest index on ties (a stable sort)."""
    n = depth.shape[0]
    bits = max(math.ceil(math.log2(max(n, 2))), 1)
    max_q = (1 << (31 - bits)) - 1
    dq = (depth / DEPTH_QUANT).clamp(0, max_q).to(torch.int64)
    p = torch.where(keep, pix.long(), hw)
    order = torch.sort(p * (max_q + 1) + dq, stable=True).indices
    sp = p[order]
    first = sp < hw
    first[1:] &= sp[1:] != sp[:-1]
    winner = torch.full((hw,), -1, dtype=torch.int64, device=pix.device)
    winner[sp[first]] = order[first]
    return winner


def range_batch(points, labels, valid, view: RangeView, u=None):
    """The range view of a batch (points [B, N, 4], labels and valid
    [B, N]); with the draws `u` (`draws`) the points are augmented first:
    (feature, label, mask), in float32."""
    if u is not None:
        with float32():
            points = augment(points, view.augment, u)
    B, H, W = points.shape[0], view.proj_h, view.proj_w
    px, py, depth = project(points, view)
    values = torch.cat([depth[..., None], points[..., :4], labels[..., None].float()], -1)
    canvas = torch.zeros((B, H * W, 6), dtype=torch.float32, device=points.device)
    mask = torch.zeros((B, H * W), dtype=torch.bool, device=points.device)
    for b in range(B):
        winner = zbuffer(py[b] * W + px[b], depth[b], valid[b], H * W)
        hit = winner >= 0
        canvas[b, hit] = values[b, winner[hit]]
        mask[b] = hit
    canvas, mask = canvas.reshape(B, H, W, 6), mask.reshape(B, H, W)
    rng = torch.where(mask, canvas[..., 0], -1.0)
    raw = torch.cat([rng[..., None], canvas[..., 1:5]], dim=-1)
    mean = torch.tensor(view.img_mean, dtype=torch.float32, device=points.device)
    std = torch.tensor(view.img_stds, dtype=torch.float32, device=points.device)
    feature = (raw - mean) / std * mask[..., None].float()
    return feature, canvas[..., 5].to(torch.int32), mask
