"""The spherical range view, SalsaNext's input (counterpart of
`pmf_tpu/data/range_pipeline.py`).

Each scan's points are projected onto a proj_h x proj_w range image by yaw
and pitch; the nearest point wins each pixel (lowest index on ties):
  feature [H, W, 5] = range, x, y, z, intensity (mean/std normalized, 0 at
                      empty pixels)
  label   [H, W]    = the winner's train-class id (0 at empty pixels)
  mask    [H, W]    = occupancy, where a point landed (pmf_tpu's `>= 0`
                      test; the reference's `proj_idx > 0` drops point 0)
In train mode the points are first augmented in 3D (`data/augment.py`) when
cfg.pcd_aug. The z-buffer is K1 (`ops/scatter.py: zbuffer_scatter_packed`,
one launch for a batch) and the fill a gather of the winners' rows; on the
CPU both are their plain PyTorch versions.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..ops.projection import spherical_project
from ..ops.scatter import fill_canvas, zbuffer_scatter_packed
from ..ops.zbuffer import zbuffer_keys
from ..utils.spans import span
from .augment import AugmentConfig, PointAugParams, augment_pointcloud
from .perspective_pipeline import _constant


@dataclass(frozen=True)
class RangeConfig:
    """Static range-view geometry (the YAML `sensor` group) and the point
    augmentation of training."""
    proj_h: int = 64
    proj_w: int = 2048
    fov_up: float = 3.0
    fov_down: float = -25.0
    fov_left: float = -180.0
    fov_right: float = 180.0
    n_points: int = 131072
    img_mean: tuple = (12.12, 10.88, 0.23, -1.04, 0.21)
    img_stds: tuple = (12.32, 11.47, 6.91, 0.86, 0.16)
    pcd_aug: bool = True
    augment: AugmentConfig = field(default_factory=AugmentConfig)


def range_config(opts, eval_cli: bool = False) -> RangeConfig:
    """The RangeConfig of an experiment's Options, read from its `sensor`
    group as pmf_tpu reads it: by default as its trainer does (fov 3°/-25°,
    fov_left/right read, the `augmentation` group's point augmentation on);
    with `eval_cli` as its SalsaNext eval CLI does (fov 10°/-30°,
    fov_left/right not read, no augmentation)."""
    sensor = opts.group("sensor")
    common = dict(proj_h=int(sensor.get("proj_h", 64)),
                  proj_w=int(sensor.get("proj_w", 2048)),
                  n_points=int(sensor.get("n_points", 131072)),
                  img_mean=tuple(sensor.get("img_mean", RangeConfig.img_mean)),
                  img_stds=tuple(sensor.get("img_stds", RangeConfig.img_stds)))
    if eval_cli:
        return RangeConfig(fov_up=float(sensor.get("fov_up", 10.0)),
                           fov_down=float(sensor.get("fov_down", -30.0)),
                           pcd_aug=False, **common)
    return RangeConfig(fov_up=float(sensor.get("fov_up", 3.0)),
                       fov_down=float(sensor.get("fov_down", -25.0)),
                       fov_left=float(sensor.get("fov_left", -180.0)),
                       fov_right=float(sensor.get("fov_right", 180.0)),
                       augment=AugmentConfig.from_dict(opts.group("augmentation")), **common)


def range_project(points, labels, valid, cfg: RangeConfig, keys=zbuffer_keys) -> dict:
    """Project padded scans (points [..., N, >=4], labels and valid [..., N])
    onto range-image planes, the key image through `keys` (the K1 wrapper,
    or its plain version where the two are compared).

    Returns a dict: feature [..., H, W, 5] raw (range -1 at empty pixels,
    x/y/z/intensity 0), label [..., H, W] int32, mask [..., H, W] bool,
    proj_range [..., H, W], and per point px, py, depth, keep [..., N].
    """
    px, py, depth, keep = spherical_project(points, cfg.fov_up, cfg.fov_down, cfg.proj_h,
                                            cfg.proj_w, cfg.fov_left, cfg.fov_right, valid)
    winner, mask = zbuffer_scatter_packed(py, px, depth, keep, cfg.proj_h, cfg.proj_w,
                                          keys=keys)
    vals = torch.cat([depth[..., None], points[..., :4], labels[..., None].float()], dim=-1)
    canvas = fill_canvas(vals, winner, mask)
    rng = torch.where(mask, canvas[..., 0], -1.0)
    return {"feature": torch.cat([rng[..., None], canvas[..., 1:5]], dim=-1),
            "label": canvas[..., 5].to(torch.int32), "mask": mask, "proj_range": rng,
            "px": px, "py": py, "depth": depth, "keep": keep}


def normalize_range_feature(feature, mask, cfg: RangeConfig):
    """(feature - mean) / std, 0 at empty pixels."""
    mean = _constant(tuple(cfg.img_mean), feature.dtype, feature.device)
    std = _constant(tuple(cfg.img_stds), feature.dtype, feature.device)
    return (feature - mean) / std * mask[..., None].to(feature.dtype)


def build_range_batch(points, labels, valid, cfg: RangeConfig, train: bool = False,
                      generator: torch.Generator | None = None,
                      aug_override: PointAugParams | None = None):
    """Batched range view of points [B, N, 4], labels [B, N], valid [B, N]:
    in train mode with cfg.pcd_aug the points are augmented first, their
    draws from `generator` or given by `aug_override`. Returns (feature
    [B, H, W, 5] normalized, label [B, H, W] int32, mask [B, H, W])."""
    return _build_range_batch(points, labels, valid, cfg, train, generator, aug_override)


def _build_range_batch(points, labels, valid, cfg: RangeConfig, train: bool = False,
                       generator=None, aug_override=None, keys=zbuffer_keys):
    """`build_range_batch` with the key scatter-min `keys` (the K1 wrapper,
    or its plain version where the two are compared). The whole view is the
    span pmf.view (`utils/spans.py`)."""
    with span("pmf.view"):
        if train and cfg.pcd_aug:
            points = augment_pointcloud(points, cfg.augment, generator, aug_override)
        planes = range_project(points, labels, valid, cfg, keys)
        feature = normalize_range_feature(planes["feature"], planes["mask"], cfg)
        return feature, planes["label"], planes["mask"]


def build_range_sample_with_uproj(points, labels, valid, cfg: RangeConfig):
    """One scan's eval view (points [N, 4]), keeping each point's place:
    (feature [H, W, 5] normalized, label, mask, proj_range, px, py, depth,
    keep); the span pmf.view."""
    with span("pmf.view"):
        planes = range_project(points, labels, valid, cfg)
        feature = normalize_range_feature(planes["feature"], planes["mask"], cfg)
        return (feature, planes["label"], planes["mask"], planes["proj_range"], planes["px"],
                planes["py"], planes["depth"], planes["keep"])
