"""The EPMF perspective view, V2 (counterpart of
`pmf_tpu/data/perspective_pipeline_v2.py`).

The points are cropped by yaw (±45°, or each scan's own pair `fovs`) with no
image-bound test and projected into the camera (with `cam_frame`, nuScenes'
points already in the camera frame are cropped by their yaw about (z, x)
and their depth z; A2D2's points come with their pixels, `pix`, and every
valid point is kept); their truncated integer pixels give a tight box around
them, padded to at least the output size (below, and centred in width).
Train: the 3D point augmentation when cfg.pcd_aug, a random image scale
(1.0-1.2) before the box, then a horizontal flip, a rotation about the box's
centre and a random crop; eval: a centre crop. All of it is per-point
coordinate arithmetic, so the points go straight into the fixed output
window, and the RGB is one inverse-map sample of the image canvas: bilinear
in train (after the ColorJitter), a separable integer gather at eval.

`build_v2_batch` (and `build_v2_batch_pix`, on the points' own pixels)
fills a batch through the K2 rasterizer and, with `return_points`, gives
the points' winner flags through K1;
`build_v2_eval_sample_with_uproj`, the per-scan path, fills through K1 and
a gather. Each runs its CUDA kernel when the tensors are on the card and
its plain PyTorch version on the CPU.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from ..ops.projection import cam_frame_crop_project, yaw_crop_project
from ..ops.rasterize import rasterize_zbuffer
from ..ops.zbuffer import zbuffer_keys
from ..parallel import rand_rows
from .augment import AugmentConfig, PointAugParams, draw_point_aug
from .jitter import color_jitter_fixed, jitter_params
from .perspective_pipeline import (PVConfig, _round_to_int32, augmented_points, fill_scan,
                                   fill_view, point_depth, pv_config, saturating_int32,
                                   scan_sizes)


A2D2_NAMES = ("a2d2", "A2D2")   # the `dataset` names of A2D2


@dataclass(frozen=True)
class V2Config:
    """Static view geometry (the YAML `PVconfig` group)."""
    canvas_h: int = 384       # RGB image canvas (unscaled)
    canvas_w: int = 1248
    proj_h: int = 384         # eval output (EPMF needs multiples of 32)
    proj_w: int = 1280
    proj_ht: int = 320        # train output
    proj_wt: int = 1024
    n_points: int = 131072
    scale_min: float = 1.0    # train: random image scale
    scale_max: float = 1.2
    rot_deg: float = 15.0     # train: rotation bound, degrees
    p_hflip: float = 0.5      # train: horizontal-flip probability
    fov_left: float = -math.pi / 4
    fov_right: float = math.pi / 4
    img_mean: tuple = PVConfig.img_mean
    img_stds: tuple = PVConfig.img_stds
    img_jitter: tuple | None = None  # train ColorJitter strengths; None: off
    pcd_aug: bool = False     # train: 3D point augmentation first
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    cam_frame: bool = False   # points in the camera frame (NuscenesV2): yaw
    # about (z, x), depth test on z
    min_depth_cam: float = 0.1


def v2_config(opts) -> V2Config:
    """The V2Config of an experiment's Options: its `PVconfig` group (the
    `sensor` group where there is none), with `pcd_mean`/`pcd_stds` as the
    normalization, and from the `augmentation` group the ColorJitter
    strengths of `img_jitter` (0.4 each unless set; null turns it off) and
    the 3D point augmentation that `pcd_aug: true` turns on. A2D2's canvas
    is 1208x1920 unless set."""
    pv = opts.group("PVconfig") or opts.group("sensor")
    aug_group = opts.group("augmentation")
    jitter = aug_group.get("img_jitter", (0.4, 0.4, 0.4))
    canvas = (1208, 1920) if opts.dataset in A2D2_NAMES else (384, 1248)
    return V2Config(
        canvas_h=int(pv.get("canvas_h", canvas[0])),
        canvas_w=int(pv.get("canvas_w", canvas[1])),
        proj_h=int(pv.get("proj_h", 320)),
        proj_w=int(pv.get("proj_w", 1280)),
        proj_ht=int(pv.get("proj_ht", 320)),
        proj_wt=int(pv.get("proj_wt", 1280)),
        n_points=int(pv.get("n_points", 131072)),
        img_mean=tuple(pv.get("pcd_mean", V2Config.img_mean)),
        img_stds=tuple(pv.get("pcd_stds", V2Config.img_stds)),
        img_jitter=tuple(jitter) if jitter else None,
        pcd_aug=bool(pv.get("pcd_aug", False)),
        augment=AugmentConfig.from_dict(aug_group))


def view_config(opts) -> PVConfig | V2Config:
    """The view of an experiment's net: `v2_config` for EPMFNet, else
    `pv_config`."""
    return v2_config(opts) if opts.net_type == "EPMFNet" else pv_config(opts)


class V2AugParams(NamedTuple):
    """The train view's parameters, one per scan: image scale [B] float32,
    horizontal flip [B] bool, rotation theta [B] float32 radians, crop
    offsets top/left [B] int into the padded box; `jitter`, the
    ColorJitter (factors [B, 3], order [B, 3]) or None; and `points`, the 3D
    point augmentation (with cfg.pcd_aug) or None."""
    scale: torch.Tensor
    flip: torch.Tensor
    theta: torch.Tensor
    top: torch.Tensor
    left: torch.Tensor
    jitter: tuple | None = None
    points: PointAugParams | None = None


def _bbox(v, keep):
    """Per scan, the least and greatest of the kept points' int32
    coordinates `v` [B, N], 0 and 0 where none is kept. Taken through
    float32, as pmf_tpu's `_bbox` does."""
    vf = v.float()
    any_keep = keep.any(-1)
    lo = torch.where(keep, vf, 1e30).amin(-1)
    hi = torch.where(keep, vf, -1e30).amax(-1)
    return (saturating_int32(torch.where(any_keep, lo, 0.0)),
            saturating_int32(torch.where(any_keep, hi, 0.0)))


def v2_view_geometry(points, labels, valid, proj_matrix, image, img_h, img_w, cfg: V2Config,
                     train: bool = False, generator: torch.Generator | None = None,
                     aug_override: V2AugParams | None = None, fovs=None, pix=None):
    """Project, box and crop a batch of scans without the fill: the eval
    view, or the train view with its parameters drawn from `generator` (this
    process's rows of the global batch's draws: `parallel.rand_rows`) or
    given by `aug_override`, in pmf_tpu's float32 arithmetic and order.

    points [B, N, 4], labels [B, N], valid [B, N], proj_matrix [B, 3, 4],
    image [B, Hc, Wc, 3], img_h/img_w [B] int; fovs [B, 2] float32 each
    scan's (fov_left, fov_right) radians, or None for the config's pair.
    `pix` = (rows, cols) [B, N] int: the points' own pixels (A2D2), which
    take the place of the projection and its crop (`proj_matrix` and `fovs`
    are not read, and every valid point is kept). Returns per point (rows,
    cols int32, keep bool, depth f32, vals [B, N, 6] = depth/x/y/z/i/label)
    and the RGB view [B, H, W, 3].
    """
    B, dev = points.shape[0], points.device
    out_h, out_w = (cfg.proj_ht, cfg.proj_wt) if train else (cfg.proj_h, cfg.proj_w)
    aug = aug_override
    if train and aug is None:
        if generator is None:
            raise ValueError("the train view draws its augmentation from a torch.Generator")
        u = rand_rows((B, 5), generator, dev)
        jitter = jitter_params(generator, B, cfg.img_jitter, dev) if cfg.img_jitter else None
        points_aug = draw_point_aug(generator, B, cfg.augment, dev) if cfg.pcd_aug else None
        scale = cfg.scale_min + u[:, 0] * (cfg.scale_max - cfg.scale_min)
    else:
        points_aug = aug.points if train else None
        scale = aug.scale.float() if train else torch.ones(B, device=dev)
    if train:
        points = augmented_points(points, cfg, points_aug)
    b1 = lambda t: t[:, None]                                      # [B] → [B, 1]

    if pix is not None:
        rows_f, cols_f, keep = pix[0].float(), pix[1].float(), valid
    else:
        fov_l, fov_r = (cfg.fov_left, cfg.fov_right) if fovs is None else \
            (fovs[:, :1], fovs[:, 1:])
        crop = cam_frame_crop_project if cfg.cam_frame else yaw_crop_project
        extra = (cfg.min_depth_cam,) if cfg.cam_frame else ()
        rows_f, cols_f, keep = crop(points[..., :3], proj_matrix, fov_l, fov_r, *extra,
                                    valid=valid)
    # truncation to int, as the reference's astype(np.int32)
    x = saturating_int32(torch.trunc(rows_f * b1(scale)))
    y = saturating_int32(torch.trunc(cols_f * b1(scale)))
    x_min, x_max = _bbox(x, keep)
    y_min, y_max = _bbox(y, keep)
    h, w = x_max - x_min + 1, y_max - y_min + 1
    max_h, max_w = h.clamp(min=out_h), w.clamp(min=out_w)
    left_pad = (max_w - w) // 2                 # width centred, height padded below
    slack_h, slack_w = (max_h - out_h).clamp(min=0), (max_w - out_w).clamp(min=0)
    if not train:
        aug = V2AugParams(scale, torch.zeros(B, dtype=torch.bool, device=dev),
                          torch.zeros(B, device=dev), slack_h // 2, slack_w // 2)
    elif aug is None:
        crop = lambda v, slack: torch.minimum((v * (slack + 1)).long(), slack.long())
        aug = V2AugParams(scale, u[:, 1] < cfg.p_hflip,
                          (u[:, 2] * 2.0 - 1.0) * cfg.rot_deg * (math.pi / 180.0),
                          crop(u[:, 3], slack_h), crop(u[:, 4], slack_w), jitter, points_aug)

    # the points: flip → rotate about the box centre → crop
    cy, cx = (max_h.float() - 1.0) / 2.0, (max_w.float() - 1.0) / 2.0
    theta = aug.theta.float()
    ct, st = torch.cos(theta), torch.sin(theta)
    top, left = aug.top.float(), aug.left.float()
    xp = (x - b1(x_min)).float()
    yp = (y - b1(y_min) + b1(left_pad)).float()
    yp = torch.where(b1(aug.flip), b1(max_w.float()) - 1.0 - yp, yp)
    dxs, dys = yp - b1(cx), xp - b1(cy)
    xo = b1(cy) + (-b1(st) * dxs + b1(ct) * dys) - b1(top)
    yo = b1(cx) + (b1(ct) * dxs + b1(st) * dys) - b1(left)
    keep_out = keep & (xo >= -0.5) & (xo < out_h - 0.5) & (yo >= -0.5) & (yo < out_w - 0.5)
    rows_o, cols_o = _round_to_int32(xo), _round_to_int32(yo)
    depth = point_depth(points)
    vals = torch.cat([depth[..., None], points[..., :4], labels[..., None].float()], dim=-1)

    # the RGB: output pixels mapped back into the image
    b3 = lambda t: t[:, None, None]                                # [B] → [B, 1, 1]

    def source(yg, xg):
        dyo, dxo = (yg + b3(top)) - b3(cy), (xg + b3(left)) - b3(cx)
        src_x = b3(cx) + (b3(ct) * dxo - b3(st) * dyo)
        src_y = b3(cy) + (b3(st) * dxo + b3(ct) * dyo)
        src_x = torch.where(b3(aug.flip), b3(max_w.float()) - 1.0 - src_x, src_x)
        return (src_y + b3(x_min)) / b3(scale), (src_x - b3(left_pad) + b3(y_min)) / b3(scale)

    ys = torch.arange(out_h, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(out_w, device=dev, dtype=torch.float32)[None, None, :]
    if train:
        if aug.jitter is not None:
            image = color_jitter_fixed(image, img_h, img_w, *aug.jitter)
        rgb = _bilinear_sample(image, *source(ys, xs), img_h, img_w)
    else:
        # flip off, θ = 0 and scale 1 make the map an integer translation:
        # the source row depends on the output row only, the column on the
        # column only, and the bilinear weights are 0 and 1
        zero = torch.zeros((1, 1, 1), device=dev)
        rgb = _translated_view(image, source(ys, zero)[0][..., 0], source(zero, xs)[1][:, 0],
                               img_h, img_w)
    return rows_o, cols_o, keep_out, depth, vals, rgb


def _translated_view(image, rows, cols, img_h, img_w):
    """The separable nearest gather of a translated view: rows [B, H] and
    cols [B, W] are integral source coordinates; pixels outside the true
    image (img_h, img_w) are 0."""
    B, Hc, Wc, _ = image.shape
    r_ok = (rows >= 0) & (rows <= (img_h - 1)[:, None])
    c_ok = (cols >= 0) & (cols <= (img_w - 1)[:, None])
    iy = _round_to_int32(rows).clamp(0, Hc - 1).long()
    ix = _round_to_int32(cols).clamp(0, Wc - 1).long()
    out = image[torch.arange(B, device=image.device)[:, None, None], iy[:, :, None], ix[:, None, :]]
    return torch.where((r_ok[:, :, None] & c_ok[:, None, :])[..., None], out, 0.0)


def _bilinear_sample(image, rows, cols, img_h, img_w):
    """Bilinear sample of image [B, Hc, Wc, 3] at float rows/cols [B, H, W];
    0 outside the true image (img_h, img_w)."""
    B, Hc, Wc, _ = image.shape
    r0, c0 = torch.floor(rows), torch.floor(cols)
    fr, fc = (rows - r0)[..., None], (cols - c0)[..., None]
    r0i = saturating_int32(r0).clamp(0, Hc - 1)
    c0i = saturating_int32(c0).clamp(0, Wc - 1)
    r1i, c1i = (r0i + 1).clamp(0, Hc - 1), (c0i + 1).clamp(0, Wc - 1)
    b = torch.arange(B, device=image.device)[:, None, None]
    v00, v01 = image[b, r0i.long(), c0i.long()], image[b, r0i.long(), c1i.long()]
    v10, v11 = image[b, r1i.long(), c0i.long()], image[b, r1i.long(), c1i.long()]
    out = (v00 * (1 - fr) * (1 - fc) + v01 * (1 - fr) * fc
           + v10 * fr * (1 - fc) + v11 * fr * fc)
    b3 = lambda t: t[:, None, None]
    inside = (rows >= 0) & (rows <= b3(img_h - 1)) & (cols >= 0) & (cols <= b3(img_w - 1))
    return torch.where(inside[..., None], out, 0.0)


def build_v2_batch(points, labels, valid, proj_matrix, images, img_h, img_w, cfg: V2Config,
                   train: bool = False, generator: torch.Generator | None = None,
                   aug_override: V2AugParams | None = None, return_points: bool = False,
                   fovs=None):
    """Batched V2 preprocessing: (feature [B, H, W, 8] normalized, mask
    [B, H, W] bool, label [B, H, W] int32) at (proj_ht, proj_wt) in train
    mode and at (proj_h, proj_w) at eval, filled by K2. `fovs` [B, 2] gives
    each scan's yaw field of view (NuscenesV2's per-camera table), by
    default the config's pair for every scan. With return_points a fourth
    element (pt_pix, pt_label, pt_won) [B, N], as `build_batch` gives it,
    from K1."""
    return _build_v2_batch(points, labels, valid, proj_matrix, images, img_h, img_w, cfg,
                           train, generator, aug_override, return_points, fovs=fovs)


def build_v2_batch_pix(points, labels, valid, rows, cols, images, img_h, img_w,
                       cfg: V2Config, train: bool = False,
                       generator: torch.Generator | None = None,
                       aug_override: V2AugParams | None = None, return_points: bool = False):
    """`build_v2_batch` over the points' own pixels rows/cols [B, N] int32
    (A2D2's stored indices) in place of a projection: the tight box spans
    every valid point, as in pmf_tpu (no image-bound test)."""
    return _build_v2_batch(points, labels, valid, None, images, img_h, img_w, cfg, train,
                           generator, aug_override, return_points, pix=(rows, cols))


def _build_v2_batch(points, labels, valid, proj_matrix, images, img_h, img_w, cfg: V2Config,
                    train: bool = False, generator=None, aug_override=None,
                    return_points: bool = False, fill=rasterize_zbuffer, keys=zbuffer_keys,
                    fovs=None, pix=None):
    """`build_v2_batch` (or, with `pix`, `build_v2_batch_pix`) with the
    rasterizer `fill` and the key scatter-min `keys` (the K2 and K1
    wrappers, or their plain versions where the two are compared)."""
    H, W = (cfg.proj_ht, cfg.proj_wt) if train else (cfg.proj_h, cfg.proj_w)
    geometry = v2_view_geometry(points, labels, valid, proj_matrix, images, img_h, img_w, cfg,
                                train, generator, aug_override, fovs, pix)
    return fill_view(geometry, labels, H, W, cfg, return_points, fill, keys)


def build_v2_eval_sample_with_uproj(points, labels, valid, proj_matrix, image, img_h, img_w,
                                    cfg: V2Config):
    """The per-scan eval path (K1 and a gather), keeping each point's place:
    (feature [H, W, 8] normalized, mask, label2d, rows, cols, keep, depth)."""
    geometry = v2_view_geometry(points[None], labels[None], valid[None], proj_matrix[None],
                                image[None], *scan_sizes(img_h, img_w, points.device), cfg)
    return fill_scan([t[0] for t in geometry], cfg.proj_h, cfg.proj_w, cfg)
