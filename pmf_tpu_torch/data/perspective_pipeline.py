"""Perspective-view preprocessing, eval branch (counterpart of
`pmf_tpu/data/perspective_pipeline.py`).

Project the LiDAR points into the camera image, centre-crop and pad the view,
and z-buffer the points into the network input:
  feature [H, W, 8] = depth, x, y, z, intensity, R, G, B (lidar part normalized)
  mask    [H, W]    = projected-point occupancy
  label   [H, W]    = train-class id (0 = empty/ignore)

The geometry works on batched [B, N] point buffers. The batched fill
(`build_batch`) is the K2 rasterizer, the per-scan fill
(`build_eval_sample_with_uproj`) the K1 scatter-min plus a gather; each runs
its CUDA kernel when the tensors are on the card and its plain PyTorch
version on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.projection import perspective_project
from ..ops.rasterize import rasterize_zbuffer
from ..ops.scatter import fill_canvas, zbuffer_scatter_packed


@dataclass(frozen=True)
class PVConfig:
    """Static pipeline geometry (mirrors the YAML `sensor` group)."""
    canvas_h: int = 384     # >= max image height in the dataset
    canvas_w: int = 1248    # >= max image width
    proj_h: int = 384       # eval output size
    proj_w: int = 1232
    h_pad: int = 7
    w_pad: int = 3
    n_points: int = 131072  # point buffer bucket
    img_mean: tuple = (12.12, 10.88, 0.23, -1.04, 0.21)
    img_stds: tuple = (12.32, 11.47, 6.91, 0.86, 0.16)

    @property
    def eval_crop(self):
        return (self.proj_h - 2 * self.h_pad, self.proj_w - 2 * self.w_pad)


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


def _round_to_int32(x: torch.Tensor) -> torch.Tensor:
    """Round half to even and convert with XLA's saturating semantics: values
    past the int32 range give its ends, NaN gives 0 (a plain `.to(int32)`
    leaves them undefined)."""
    r = torch.round(x)
    out = torch.nan_to_num(r, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 128).to(torch.int32)
    return torch.where(r >= 2.0 ** 31, 2 ** 31 - 1, out)


def view_geometry(points, labels, valid, proj_matrix, image, img_h, img_w,
                  cfg: PVConfig):
    """Project and centre-crop a batch of scans without the fill.

    points [B, N, 4], labels [B, N], valid [B, N], proj_matrix [B, 3, 4],
    image [B, Hc, Wc, 3], img_h/img_w [B] int. Returns per point
    (rows, cols int32, keep bool, depth f32, vals [B, N, 6] =
    depth/x/y/z/i/label) and the cropped, padded RGB view [B, H, W, 3].
    """
    B = points.shape[0]
    dev = points.device
    out_h, out_w = cfg.proj_h, cfg.proj_w
    ch, cw = cfg.eval_crop
    rows_f, cols_f, keep = perspective_project(points[..., :3], proj_matrix,
                                               img_h, img_w, valid)
    depth = point_depth(points)

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
    vals = torch.cat([depth[..., None], points[..., :4],
                      labels[..., None].float()], dim=-1)

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
    return rows_o, cols_o, keep_out, depth, vals, rgb


def normalize_feature(feature, mask, cfg: PVConfig):
    """(f[0:5] - mean) / std * mask on the lidar channels; RGB untouched."""
    mean = torch.tensor(cfg.img_mean, dtype=feature.dtype, device=feature.device)
    std = torch.tensor(cfg.img_stds, dtype=feature.dtype, device=feature.device)
    lidar = (feature[..., :5] - mean) / std * mask[..., None].to(feature.dtype)
    return torch.cat([lidar, feature[..., 5:]], dim=-1)


def build_batch(points, labels, valid, proj_matrix, images, img_h, img_w,
                cfg: PVConfig, train: bool = False):
    """Batched eval preprocessing: project, crop, z-buffer, normalize.

    Returns (feature [B, H, W, 8] normalized, mask [B, H, W] bool,
    label [B, H, W] int32).
    """
    if train:
        raise NotImplementedError("the train view is not ported yet")
    return _build_batch(points, labels, valid, proj_matrix, images, img_h, img_w,
                        cfg, rasterize_zbuffer)


def _build_batch(points, labels, valid, proj_matrix, images, img_h, img_w,
                 cfg: PVConfig, fill):
    """`build_batch`'s eval view with the rasterizer `fill` (the K2 wrapper,
    or its plain version where the two are compared)."""
    rows, cols, keep, depth, vals, rgb = view_geometry(
        points, labels, valid, proj_matrix, images, img_h, img_w, cfg)
    canvas, mask = fill(rows, cols, depth, keep, vals, cfg.proj_h, cfg.proj_w)
    lab = torch.round(canvas[..., 5]).to(torch.int32)
    feature = torch.cat([canvas[..., :5], rgb], dim=-1)
    return normalize_feature(feature, mask, cfg), mask, lab


def build_eval_sample_with_uproj(points, labels, valid, proj_matrix, image,
                                 img_h: int, img_w: int, cfg: PVConfig):
    """Single-scan eval path that keeps the per-point projection.

    Returns (feature [H, W, 8] normalized, mask, label2d, rows, cols, keep,
    depth); rows/cols are the points' integer pixel coords in the view.
    """
    size = lambda v: torch.as_tensor(v, dtype=torch.int32, device=points.device)[None]
    rows, cols, keep, depth, vals, rgb = view_geometry(
        points[None], labels[None], valid[None], proj_matrix[None], image[None],
        size(img_h), size(img_w), cfg)
    rows, cols, keep, depth, vals, rgb = (t[0] for t in (rows, cols, keep, depth, vals, rgb))
    winner, mask = zbuffer_scatter_packed(rows, cols, depth, keep, cfg.proj_h, cfg.proj_w)
    canvas = fill_canvas(vals, winner, mask)
    lab = canvas[..., 5].to(torch.int32)
    feature = torch.cat([canvas[..., :5], rgb], dim=-1)
    return normalize_feature(feature, mask, cfg), mask, lab, rows, cols, keep, depth
