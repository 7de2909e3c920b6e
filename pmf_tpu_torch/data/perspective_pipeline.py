"""Perspective-view preprocessing (counterpart of
`pmf_tpu/data/perspective_pipeline.py`).

Project the LiDAR points into the camera image (SemanticKITTI: in front of
the car and inside the image; nuScenes, `projection="cam"`: camera depth
above min_depth and 1 px inside the image), 2D-augment the view (train:
horizontal flip → rotation → random crop → pad, with ColorJitter on the RGB,
after the 3D point augmentation when cfg.pcd_aug; eval: centre crop → pad),
and z-buffer the points into the network input:
  feature [H, W, 8] = depth, x, y, z, intensity, R, G, B (lidar part normalized)
  mask    [H, W]    = projected-point occupancy
  label   [H, W]    = train-class id (0 = empty/ignore)

The geometry works on batched [B, N] point buffers. The augmentation maps
the points' integer pixels forward to the view and resamples the RGB by the
inverse map (nearest neighbour). The batched fill (`build_batch`) is the K2
rasterizer, and its per-point winner flags (`return_points`) one K1 call for
the batch; the per-scan fill (`build_eval_sample_with_uproj`) is K1 plus a
gather. Each runs its CUDA kernel when the tensors are on the card and its
plain PyTorch version on the CPU.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.projection import perspective_project, perspective_project_cam
from ..ops.rasterize import rasterize_zbuffer
from ..ops.scatter import fill_canvas, point_winner_flags, zbuffer_scatter_packed
from ..ops.zbuffer import zbuffer_keys
from ..parallel import rand_rows
from .augment import AugmentConfig, PointAugParams, augment_pointcloud, draw_point_aug
from .jitter import color_jitter_fixed, jitter_params

ROT_DEG = 15.0   # the train view's rotation bound, degrees
P_HFLIP = 0.5    # its horizontal-flip probability


@dataclass(frozen=True)
class PVConfig:
    """Static pipeline geometry (mirrors the YAML `sensor` group)."""
    canvas_h: int = 384     # >= max image height in the dataset
    canvas_w: int = 1248    # >= max image width
    proj_h: int = 384       # eval output size
    proj_w: int = 1232
    proj_ht: int = 256      # train output size
    proj_wt: int = 1024
    h_pad: int = 7
    w_pad: int = 3
    n_points: int = 131072  # point buffer bucket
    img_mean: tuple = (12.12, 10.88, 0.23, -1.04, 0.21)
    img_stds: tuple = (12.32, 11.47, 6.91, 0.86, 0.16)
    img_jitter: tuple | None = None  # train ColorJitter (brightness,
    # contrast, saturation) strengths; None: no jitter
    pcd_aug: bool = False   # train: 3D point augmentation first
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    projection: str = "kitti"  # "kitti" (x > 0.5, inside the image) | "cam" (nuScenes)
    min_depth: float = 1.0     # "cam": the least camera-frame depth kept

    @property
    def train_crop(self):
        return (self.proj_ht - 2 * self.h_pad, self.proj_wt - 2 * self.w_pad)

    @property
    def eval_crop(self):
        return (self.proj_h - 2 * self.h_pad, self.proj_w - 2 * self.w_pad)


def pv_config(opts) -> PVConfig:
    """The PVConfig of an experiment's Options: its `sensor` group, and from
    its `augmentation` group the ColorJitter strengths of `img_jitter` (0.4
    each unless set; null turns it off) and the 3D point augmentation that
    `sensor.pcd_aug: true` turns on. nuScenes (`dataset: nuScenes`) takes
    the composed camera matrix's depth test (`projection="cam"`), as
    pmf_tpu's trainer picks it."""
    sensor = opts.group("sensor")
    aug_group = opts.group("augmentation")
    jitter = aug_group.get("img_jitter", (0.4, 0.4, 0.4))
    return PVConfig(
        canvas_h=int(sensor.get("canvas_h", 384)),
        canvas_w=int(sensor.get("canvas_w", 1248)),
        proj_h=int(sensor.get("proj_h", 384)),
        proj_w=int(sensor.get("proj_w", 1232)),
        proj_ht=int(sensor.get("proj_ht", 256)),
        proj_wt=int(sensor.get("proj_wt", 1024)),
        h_pad=int(sensor.get("h_pad", 7)),
        w_pad=int(sensor.get("w_pad", 3)),
        n_points=int(sensor.get("n_points", 131072)),
        img_mean=tuple(sensor.get("img_mean", PVConfig.img_mean)),
        img_stds=tuple(sensor.get("img_stds", PVConfig.img_stds)),
        img_jitter=tuple(jitter) if jitter else None,
        pcd_aug=bool(sensor.get("pcd_aug", False)),
        augment=AugmentConfig.from_dict(aug_group),
        projection="cam" if opts.dataset == "nuScenes" else "kitti")


def pad_points(pcd: np.ndarray, sem_label: np.ndarray, n_points: int):
    """Host-side: pad a ragged scan to the fixed point bucket."""
    n = min(len(pcd), n_points)
    points = np.zeros((n_points, pcd.shape[1]), dtype=np.float32)
    labels = np.zeros((n_points,), dtype=np.int32)
    valid = np.zeros((n_points,), dtype=bool)
    points[:n] = pcd[:n]
    labels[:n] = sem_label[:n]
    valid[:n] = True
    return points, labels, valid


def pad_image(img: np.ndarray, canvas_h: int, canvas_w: int):
    """Host-side: place the RGB image top-left on the fixed canvas, /255."""
    out = np.zeros((canvas_h, canvas_w, 3), dtype=np.float32)
    h = min(img.shape[0], canvas_h)
    w = min(img.shape[1], canvas_w)
    out[:h, :w] = img[:h, :w, :3].astype(np.float32) / 255.0
    return out, np.int32(h), np.int32(w)


def point_depth(points: torch.Tensor) -> torch.Tensor:
    """Euclidean range of each point ([..., N, >=3] → [..., N])."""
    return torch.linalg.vector_norm(points[..., :3], dim=-1)


def saturating_int32(r: torch.Tensor) -> torch.Tensor:
    """Integral floats to int32 with XLA's saturating semantics: values past
    the int32 range give its ends, NaN gives 0 (a plain `.to(int32)` leaves
    them undefined)."""
    out = torch.nan_to_num(r, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 128).to(torch.int32)
    return torch.where(r >= 2.0 ** 31, 2 ** 31 - 1, out)


def _round_to_int32(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, then `saturating_int32`."""
    return saturating_int32(torch.round(x))


class AugParams(NamedTuple):
    """The train view's parameters, one per scan: horizontal flip [B] bool,
    rotation theta [B] float32 radians, crop offsets top/left [B] int;
    `jitter`, the ColorJitter (factors [B, 3], order [B, 3]) or None; and
    `points`, the 3D point augmentation (with cfg.pcd_aug) or None."""
    flip: torch.Tensor
    theta: torch.Tensor
    top: torch.Tensor
    left: torch.Tensor
    jitter: tuple | None = None
    points: PointAugParams | None = None


def _affine_params(generator: torch.Generator, img_h, img_w, cfg: PVConfig) -> AugParams:
    """Draw the train view's parameters from `generator`: flip with
    probability P_HFLIP, theta ~ U(-ROT_DEG, ROT_DEG) degrees, crop offsets
    uniform over the image's slack around the train crop, the ColorJitter
    if cfg.img_jitter, and the point augmentation if cfg.pcd_aug; each this
    process's rows of the global batch's draws (`parallel.rand_rows`)."""
    if generator is None:
        raise ValueError("the train view draws its augmentation from a torch.Generator")
    B, dev = img_h.shape[0], img_h.device
    ch, cw = cfg.train_crop
    u = rand_rows((B, 4), generator, dev)
    slack_h, slack_w = (img_h - ch).clamp(min=0), (img_w - cw).clamp(min=0)
    top = torch.minimum((u[:, 2] * (slack_h + 1)).long(), slack_h)
    left = torch.minimum((u[:, 3] * (slack_w + 1)).long(), slack_w)
    theta = (u[:, 1] * 2.0 - 1.0) * ROT_DEG * (math.pi / 180.0)
    jitter = jitter_params(generator, B, cfg.img_jitter, dev) if cfg.img_jitter else None
    points = draw_point_aug(generator, B, cfg.augment, dev) if cfg.pcd_aug else None
    return AugParams(u[:, 0] < P_HFLIP, theta, top, left, jitter, points)


def augmented_points(points, cfg, points_aug: PointAugParams | None):
    """The train view's points: augmented by `points_aug` when cfg.pcd_aug
    (which then needs it), else as given."""
    if not cfg.pcd_aug:
        return points
    if points_aug is None:
        raise ValueError("cfg.pcd_aug needs the point augmentation's parameters")
    return augment_pointcloud(points, cfg.augment, params=points_aug)


def view_geometry(points, labels, valid, proj_matrix, image, img_h, img_w,
                  cfg: PVConfig, aug: AugParams | None = None):
    """Project and crop a batch of scans without the fill: the eval view
    (centre crop), or with `aug` the train view.

    points [B, N, 4], labels [B, N], valid [B, N], proj_matrix [B, 3, 4],
    image [B, Hc, Wc, 3], img_h/img_w [B] int. Returns per point
    (rows, cols int32, keep bool, depth f32, vals [B, N, 6] =
    depth/x/y/z/i/label) and the padded RGB view [B, H, W, 3].
    """
    if cfg.projection == "cam":
        rows_f, cols_f, keep = perspective_project_cam(points[..., :3], proj_matrix, img_h, img_w,
                                                       min_depth=cfg.min_depth, valid=valid)
    else:
        rows_f, cols_f, keep = perspective_project(points[..., :3], proj_matrix, img_h, img_w,
                                                   valid)
    depth = point_depth(points)
    vals = torch.cat([depth[..., None], points[..., :4],
                      labels[..., None].float()], dim=-1)
    if aug is None:
        rows_o, cols_o, keep_out, rgb = _eval_view(rows_f, cols_f, keep, image, img_h, img_w, cfg)
    else:
        rows_o, cols_o, keep_out, rgb = _train_view(rows_f, cols_f, keep, image, img_h, img_w,
                                                    cfg, aug)
    return rows_o, cols_o, keep_out, depth, vals, rgb


def _eval_view(rows_f, cols_f, keep, image, img_h, img_w, cfg: PVConfig):
    """Centre crop and pad: (rows, cols, keep) of the points and the RGB."""
    B = image.shape[0]
    dev = image.device
    out_h, out_w = cfg.proj_h, cfg.proj_w
    ch, cw = cfg.eval_crop
    # centre crop: a pure shift of the integer pixel. The JAX view's rotation
    # round trip cy + (pr - cy) is exact for |pr| < 2^23, which covers every
    # kept point; past 2^24 px (points not kept) pmf_tpu's own jitted and
    # op-by-op results differ in the last place, and every consumer masks
    # those coordinates by `keep`.
    top = (img_h - ch).clamp(min=0) // 2
    left = (img_w - cw).clamp(min=0) // 2
    ro = torch.floor(rows_f) - top[:, None].float()
    co = torch.floor(cols_f) - left[:, None].float()
    keep_out = keep & (ro >= -0.5) & (ro < ch - 0.5) & (co >= -0.5) & (co < cw - 0.5)
    rows_o = _round_to_int32(ro) + cfg.h_pad
    cols_o = _round_to_int32(co) + cfg.w_pad

    # RGB: the crop window, its start clamped into the canvas as
    # lax.dynamic_slice does, padded, and zeroed beyond the true image
    Hc, Wc = image.shape[1:3]
    if Hc < ch or Wc < cw:
        raise ValueError(f"image canvas {Hc}x{Wc} is smaller than the eval crop {ch}x{cw}")
    t0 = top.clamp(max=Hc - ch)
    l0 = left.clamp(max=Wc - cw)
    ys = t0[:, None] + torch.arange(ch, device=dev)
    xs = l0[:, None] + torch.arange(cw, device=dev)
    window = image[torch.arange(B, device=dev)[:, None, None],
                   ys[:, :, None], xs[:, None, :]]
    rgb = F.pad(window, (0, 0, cfg.w_pad, cfg.w_pad, cfg.h_pad, cfg.h_pad))
    yg = torch.arange(out_h, device=dev) - cfg.h_pad
    xg = torch.arange(out_w, device=dev) - cfg.w_pad
    inb = ((yg >= 0) & (yg[None] + top[:, None] < img_h[:, None]))[:, :, None] & \
        ((xg >= 0) & (xg[None] + left[:, None] < img_w[:, None]))[:, None, :]
    rgb = torch.where(inb[..., None], rgb, 0.0)
    return rows_o, cols_o, keep_out, rgb


def _train_view(rows_f, cols_f, keep, image, img_h, img_w, cfg: PVConfig, aug: AugParams):
    """Flip → rotate about the image centre → crop → pad, in the JAX
    package's float32 arithmetic and order: the points' integer pixels
    mapped forward, the RGB (ColorJitter first) resampled by the inverse map
    at the nearest pixel."""
    B = image.shape[0]
    dev = image.device
    ch, cw = cfg.train_crop
    hf, wf = img_h.float()[:, None], img_w.float()[:, None]        # [B, 1]
    cy, cx = (hf - 1.0) / 2.0, (wf - 1.0) / 2.0
    theta = aug.theta.float()[:, None]
    ct, st = torch.cos(theta), torch.sin(theta)
    flip = aug.flip[:, None]
    top, left = aug.top.float()[:, None], aug.left.float()[:, None]

    pr, pc = torch.floor(rows_f), torch.floor(cols_f)
    pc = torch.where(flip, wf - 1.0 - pc, pc)
    dys, dxs = pr - cy, pc - cx
    ro = cy + (-st * dxs + ct * dys) - top
    co = cx + (ct * dxs + st * dys) - left
    keep_out = keep & (ro >= -0.5) & (ro < ch - 0.5) & (co >= -0.5) & (co < cw - 0.5)
    rows_o = _round_to_int32(ro) + cfg.h_pad
    cols_o = _round_to_int32(co) + cfg.w_pad

    if aug.jitter is not None:
        image = color_jitter_fixed(image, img_h, img_w, *aug.jitter)
    b3 = lambda t: t[:, :, None]                                   # [B, 1] → [B, 1, 1]
    yg = (torch.arange(cfg.proj_ht, device=dev).float() - cfg.h_pad)[None, :, None]
    xg = (torch.arange(cfg.proj_wt, device=dev).float() - cfg.w_pad)[None, None, :]
    dyo, dxo = (yg + b3(top)) - b3(cy), (xg + b3(left)) - b3(cx)
    src_c = b3(cx) + (b3(ct) * dxo - b3(st) * dyo)
    src_r = b3(cy) + (b3(st) * dxo + b3(ct) * dyo)
    src_c = torch.where(b3(flip), b3(wf) - 1.0 - src_c, src_c)
    Hc, Wc = image.shape[1:3]
    iy = _round_to_int32(src_r).clamp(0, Hc - 1).long()
    ix = _round_to_int32(src_c).clamp(0, Wc - 1).long()
    inb = ((yg >= 0) & (yg < ch) & (xg >= 0) & (xg < cw)
           & (src_r >= -0.5) & (src_r < b3(hf) - 0.5)
           & (src_c >= -0.5) & (src_c < b3(wf) - 0.5))
    rgb = image[torch.arange(B, device=dev)[:, None, None], iy, ix]
    return rows_o, cols_o, keep_out, torch.where(inb[..., None], rgb, 0.0)


@functools.lru_cache(maxsize=16)
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`values` as a tensor on `device`, made once: later calls copy nothing
    from the host, so a CUDA graph can capture them."""
    return torch.tensor(values, dtype=dtype, device=device)


def normalize_feature(feature, mask, cfg: PVConfig):
    """(f[0:5] - mean) / std * mask on the lidar channels; RGB untouched."""
    mean = _constant(tuple(cfg.img_mean), feature.dtype, feature.device)
    std = _constant(tuple(cfg.img_stds), feature.dtype, feature.device)
    lidar = (feature[..., :5] - mean) / std * mask[..., None].to(feature.dtype)
    return torch.cat([lidar, feature[..., 5:]], dim=-1)


def build_batch(points, labels, valid, proj_matrix, images, img_h, img_w,
                cfg: PVConfig, train: bool = False, generator: torch.Generator | None = None,
                aug_override: AugParams | None = None, return_points: bool = False):
    """Batched preprocessing: project, augment (train) or centre-crop
    (eval), z-buffer, normalize.

    Returns (feature [B, H, W, 8] normalized, mask [B, H, W] bool,
    label [B, H, W] int32) at (proj_ht, proj_wt) in train mode and at
    (proj_h, proj_w) at eval. The train view's parameters are drawn from
    `generator`, or given by `aug_override`. With return_points a fourth
    element (pt_pix [B, N] int32, pt_label [B, N] int32, pt_won [B, N] bool)
    gives each point's flat pixel (H*W when not kept) and whether it won
    that pixel, for the point-domain Lovász loss.
    """
    return _build_batch(points, labels, valid, proj_matrix, images, img_h, img_w, cfg,
                        train, generator, aug_override, return_points)


def _build_batch(points, labels, valid, proj_matrix, images, img_h, img_w,
                 cfg: PVConfig, train: bool = False, generator=None, aug_override=None,
                 return_points: bool = False, fill=rasterize_zbuffer, keys=zbuffer_keys):
    """`build_batch` with the rasterizer `fill` and the key scatter-min
    `keys` (the K2 and K1 wrappers, or their plain versions where the two
    are compared)."""
    aug = None
    if train:
        aug = aug_override if aug_override is not None else \
            _affine_params(generator, img_h, img_w, cfg)
        points = augmented_points(points, cfg, aug.points)
    H, W = (cfg.proj_ht, cfg.proj_wt) if train else (cfg.proj_h, cfg.proj_w)
    geometry = view_geometry(points, labels, valid, proj_matrix, images, img_h, img_w, cfg, aug)
    return fill_view(geometry, labels, H, W, cfg, return_points, fill, keys)


def fill_view(geometry, labels, H: int, W: int, cfg, return_points: bool = False,
              fill=rasterize_zbuffer, keys=zbuffer_keys):
    """A batch's view geometry (rows, cols, keep, depth, vals, rgb) filled by
    `fill` into an H x W canvas, labelled and normalized: (feature, mask,
    label[, (pt_pix, pt_label, pt_won)]) as `build_batch` returns them."""
    rows, cols, keep, depth, vals, rgb = geometry
    canvas, mask = fill(rows, cols, depth, keep, vals, H, W)
    lab = torch.round(canvas[..., 5]).to(torch.int32)
    feature = normalize_feature(torch.cat([canvas[..., :5], rgb], dim=-1), mask, cfg)
    if not return_points:
        return feature, mask, lab
    pix, won = point_winner_flags(rows, cols, depth, keep, H, W, keys=keys)
    return feature, mask, lab, (pix, labels.to(torch.int32), won)


def scan_sizes(img_h, img_w, device):
    """One scan's image size (ints or 0-d tensors) as [1] int32 tensors."""
    size = lambda v: torch.as_tensor(v, dtype=torch.int32, device=device).reshape(1)
    return size(img_h), size(img_w)


def fill_scan(geometry, H: int, W: int, cfg):
    """One scan's view geometry, without its batch dimension, filled by the
    per-scan z-buffer (K1 and a gather): (feature [H, W, 8] normalized, mask,
    label2d, rows, cols, keep, depth), the labels truncated."""
    rows, cols, keep, depth, vals, rgb = geometry
    winner, mask = zbuffer_scatter_packed(rows, cols, depth, keep, H, W)
    canvas = fill_canvas(vals, winner, mask)
    lab = canvas[..., 5].to(torch.int32)
    feature = torch.cat([canvas[..., :5], rgb], dim=-1)
    return normalize_feature(feature, mask, cfg), mask, lab, rows, cols, keep, depth


def build_eval_sample_with_uproj(points, labels, valid, proj_matrix, image,
                                 img_h: int, img_w: int, cfg: PVConfig):
    """Single-scan eval path that keeps the per-point projection.

    Returns (feature [H, W, 8] normalized, mask, label2d, rows, cols, keep,
    depth); rows/cols are the points' integer pixel coords in the view.
    """
    geometry = view_geometry(points[None], labels[None], valid[None], proj_matrix[None],
                             image[None], *scan_sizes(img_h, img_w, points.device), cfg)
    return fill_scan([t[0] for t in geometry], cfg.proj_h, cfg.proj_w, cfg)
