"""The perspective views of PMF (eval and train) and EPMF (eval), with
plain z-buffer fills: the batched fill as a stable sort on (pixel, depth
quantum), the per-scan fill and the winner flags as a scatter-min of
packed keys.

  feature [B, H, W, 8] = depth, x, y, z, intensity (normalized, masked), R, G, B
  mask    [B, H, W]    = occupied pixels
  label   [B, H, W]    = train-class id of the winning point (0 = empty)

The arithmetic and its order are the JAX package's, as the port computes
them, so the pixels agree bit for bit. The train view draws from a
`torch.Generator` in the port's order: four uniforms a scan (flip, angle,
crop top, crop left), then three ColorJitter factors and three uniforms
whose argsort orders the jitter's ops.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

ROT_DEG = 15.0
P_HFLIP = 0.5
DQ_MAX = 2**16 - 1
IMAX = 2**31 - 1
DEPTH_QUANT = 1.0 / 64.0
GRAY = (0.2989, 0.587, 0.114)


@dataclass(frozen=True)
class View:
    """The view's sizes (a configuration's `view` group)."""
    canvas_h: int
    canvas_w: int
    proj_h: int
    proj_w: int
    proj_ht: int = 0
    proj_wt: int = 0
    h_pad: int = 0
    w_pad: int = 0
    img_mean: tuple = (12.12, 10.88, 0.23, -1.04, 0.21)
    img_stds: tuple = (12.32, 11.47, 6.91, 0.86, 0.16)
    img_jitter: tuple | None = None
    fov_left: float = -math.pi / 4
    fov_right: float = math.pi / 4

    @classmethod
    def from_dict(cls, d: dict) -> "View":
        """The view of a configuration's `view` group (its other keys, such
        as the point bucket, are the port's)."""
        d = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        for k in ("img_mean", "img_stds", "img_jitter"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return cls(**d)


def saturating_int32(r):
    out = torch.nan_to_num(r, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 128).to(torch.int32)
    return torch.where(r >= 2.0 ** 31, 2 ** 31 - 1, out)


def round_int32(x):
    return saturating_int32(torch.round(x))


def point_depth(points):
    return torch.linalg.vector_norm(points[..., :3], dim=-1)


def _project(points, proj):
    pt = proj.transpose(-1, -2)[..., None, :, :]
    return (points[..., :3, None] * pt[..., :3, :]).sum(-2) + pt[..., 3, :]


def kitti_project(points, proj, img_h, img_w, valid):
    """Points in front (x > 0.5), inside the image and valid: (rows, cols, keep)."""
    uvw = _project(points, proj)
    w = torch.where(uvw[..., 2].abs() > 1e-9, uvw[..., 2], 1e-9)
    u, v = uvw[..., 0] / w, uvw[..., 1] / w
    h, wd = img_h[..., None], img_w[..., None]
    keep = (points[..., 0] > 0.5) & valid & (u > 0) & (u < wd) & (v > 0) & (v < h)
    return v, u, keep


def yaw_project(points, proj, fov_left, fov_right, valid):
    """EPMF's crop: range > 0.5 m and yaw in [fov_left, fov_right]."""
    depth = point_depth(points)
    yaw = -torch.atan2(points[..., 1], points[..., 0])
    keep = (depth > 0.5) & (yaw >= fov_left) & (yaw <= fov_right) & valid
    uvw = _project(points, proj)
    w = torch.where(uvw[..., 2].abs() > 1e-9, uvw[..., 2], 1e-9)
    return uvw[..., 1] / w, uvw[..., 0] / w, keep


def train_draws(g: torch.Generator, batch: int, view: View, dev):
    """(flip, theta, top, left, jitter factors, jitter order) of a batch,
    drawn in the port's order; top and left are the crop's uniforms, scaled
    by `train_view` to each image's slack."""
    u = torch.rand((batch, 4), generator=g, device=dev)
    lo = torch.tensor([max(0.0, 1.0 - s) for s in view.img_jitter], device=dev)
    hi = torch.tensor([1.0 + s for s in view.img_jitter], device=dev)
    f = torch.rand((batch, 3), generator=g, device=dev)
    order = torch.rand((batch, 3), generator=g, device=dev).argsort(dim=1)
    return u, f * (hi - lo) + lo, order


def color_jitter(image, img_h, img_w, factors, order):
    B, Hc, Wc, _ = image.shape
    dev = image.device
    inb = ((torch.arange(Hc, device=dev) < img_h[:, None])[:, :, None]
           & (torch.arange(Wc, device=dev) < img_w[:, None])[:, None, :])[..., None]
    n_px = (img_h * img_w).float()
    gray_w = torch.tensor(GRAY, dtype=image.dtype, device=dev)
    for i in range(3):
        op = order[:, i].view(B, 1, 1, 1)
        f = factors.float().gather(1, order[:, i:i + 1].long()).view(B, 1, 1, 1)
        gray = (image * gray_w).sum(dim=-1, keepdim=True)
        mean = torch.where(inb, gray, 0.0).sum(dim=(1, 2, 3)) / n_px
        ref = torch.where(op == 2, gray, torch.where(op == 1, mean.view(B, 1, 1, 1), 0.0))
        out = (f * image + (1.0 - f) * ref).clamp(0.0, 1.0)
        image = torch.where(inb | (op != 1), out, image)
    return image


def eval_view(rows_f, cols_f, keep, image, img_h, img_w, view: View):
    """Centre crop and pad: (rows, cols, keep) of the points and the RGB."""
    B, Hc, Wc, _ = image.shape
    dev = image.device
    ch, cw = view.proj_h - 2 * view.h_pad, view.proj_w - 2 * view.w_pad
    top = (img_h - ch).clamp(min=0) // 2
    left = (img_w - cw).clamp(min=0) // 2
    ro = torch.floor(rows_f) - top[:, None].float()
    co = torch.floor(cols_f) - left[:, None].float()
    keep = keep & (ro >= -0.5) & (ro < ch - 0.5) & (co >= -0.5) & (co < cw - 0.5)
    rows, cols = round_int32(ro) + view.h_pad, round_int32(co) + view.w_pad
    t0, l0 = top.clamp(max=Hc - ch), left.clamp(max=Wc - cw)
    ys = t0[:, None] + torch.arange(ch, device=dev)
    xs = l0[:, None] + torch.arange(cw, device=dev)
    window = image[torch.arange(B, device=dev)[:, None, None], ys[:, :, None], xs[:, None, :]]
    rgb = F.pad(window, (0, 0, view.w_pad, view.w_pad, view.h_pad, view.h_pad))
    yg = torch.arange(view.proj_h, device=dev) - view.h_pad
    xg = torch.arange(view.proj_w, device=dev) - view.w_pad
    inb = ((yg >= 0) & (yg[None] + top[:, None] < img_h[:, None]))[:, :, None] & \
        ((xg >= 0) & (xg[None] + left[:, None] < img_w[:, None]))[:, None, :]
    return rows, cols, keep, torch.where(inb[..., None], rgb, 0.0)


def train_view(rows_f, cols_f, keep, image, img_h, img_w, view: View, draws):
    """Flip → rotate about the image centre → crop → pad, the RGB jittered
    and resampled by the inverse map at the nearest pixel."""
    u, factors, order = draws
    B = image.shape[0]
    dev = image.device
    ch, cw = view.proj_ht - 2 * view.h_pad, view.proj_wt - 2 * view.w_pad
    slack_h, slack_w = (img_h - ch).clamp(min=0), (img_w - cw).clamp(min=0)
    top_i = torch.minimum((u[:, 2] * (slack_h + 1)).long(), slack_h)
    left_i = torch.minimum((u[:, 3] * (slack_w + 1)).long(), slack_w)
    theta_b = (u[:, 1] * 2.0 - 1.0) * ROT_DEG * (math.pi / 180.0)
    flip = (u[:, 0] < P_HFLIP)[:, None]
    hf, wf = img_h.float()[:, None], img_w.float()[:, None]
    cy, cx = (hf - 1.0) / 2.0, (wf - 1.0) / 2.0
    theta = theta_b.float()[:, None]
    ct, st = torch.cos(theta), torch.sin(theta)
    top, left = top_i.float()[:, None], left_i.float()[:, None]
    pr, pc = torch.floor(rows_f), torch.floor(cols_f)
    pc = torch.where(flip, wf - 1.0 - pc, pc)
    dys, dxs = pr - cy, pc - cx
    ro = cy + (-st * dxs + ct * dys) - top
    co = cx + (ct * dxs + st * dys) - left
    keep = keep & (ro >= -0.5) & (ro < ch - 0.5) & (co >= -0.5) & (co < cw - 0.5)
    rows, cols = round_int32(ro) + view.h_pad, round_int32(co) + view.w_pad

    image = color_jitter(image, img_h, img_w, factors, order)
    b3 = lambda t: t[:, :, None]
    yg = (torch.arange(view.proj_ht, device=dev).float() - view.h_pad)[None, :, None]
    xg = (torch.arange(view.proj_wt, device=dev).float() - view.w_pad)[None, None, :]
    dyo, dxo = (yg + b3(top)) - b3(cy), (xg + b3(left)) - b3(cx)
    src_c = b3(cx) + (b3(ct) * dxo - b3(st) * dyo)
    src_r = b3(cy) + (b3(st) * dxo + b3(ct) * dyo)
    src_c = torch.where(b3(flip), b3(wf) - 1.0 - src_c, src_c)
    Hc, Wc = image.shape[1:3]
    iy = round_int32(src_r).clamp(0, Hc - 1).long()
    ix = round_int32(src_c).clamp(0, Wc - 1).long()
    inb = ((yg >= 0) & (yg < ch) & (xg >= 0) & (xg < cw)
           & (src_r >= -0.5) & (src_r < b3(hf) - 0.5)
           & (src_c >= -0.5) & (src_c < b3(wf) - 0.5))
    rgb = image[torch.arange(B, device=dev)[:, None, None], iy, ix]
    return rows, cols, keep, torch.where(inb[..., None], rgb, 0.0)


def _bbox(v, keep):
    vf = v.float()
    any_keep = keep.any(-1)
    lo = torch.where(keep, vf, 1e30).amin(-1)
    hi = torch.where(keep, vf, -1e30).amax(-1)
    return (saturating_int32(torch.where(any_keep, lo, 0.0)),
            saturating_int32(torch.where(any_keep, hi, 0.0)))


def v2_eval_view(points, valid, proj, image, img_h, img_w, view: View):
    """EPMF's eval view: the kept points' tight box, padded to the output
    (below, and centred in width), centre-cropped; the RGB a separable
    integer gather. (rows, cols, keep, rgb)."""
    B, dev = points.shape[0], points.device
    out_h, out_w = view.proj_h, view.proj_w
    rows_f, cols_f, keep = yaw_project(points, proj, view.fov_left, view.fov_right, valid)
    x = saturating_int32(torch.trunc(rows_f * 1.0))
    y = saturating_int32(torch.trunc(cols_f * 1.0))
    x_min, x_max = _bbox(x, keep)
    y_min, y_max = _bbox(y, keep)
    h, w = x_max - x_min + 1, y_max - y_min + 1
    max_h, max_w = h.clamp(min=out_h), w.clamp(min=out_w)
    left_pad = (max_w - w) // 2
    top = ((max_h - out_h).clamp(min=0) // 2).float()
    left = ((max_w - out_w).clamp(min=0) // 2).float()
    cy, cx = (max_h.float() - 1.0) / 2.0, (max_w.float() - 1.0) / 2.0
    b1 = lambda t: t[:, None]
    xp = (x - b1(x_min)).float()
    yp = (y - b1(y_min) + b1(left_pad)).float()
    # θ = 0, no flip: cos 1, sin 0, as the port's general map computes them
    ct, st = torch.ones(B, device=dev), torch.zeros(B, device=dev)
    dxs, dys = yp - b1(cx), xp - b1(cy)
    xo = b1(cy) + (-b1(st) * dxs + b1(ct) * dys) - b1(top)
    yo = b1(cx) + (b1(ct) * dxs + b1(st) * dys) - b1(left)
    keep = keep & (xo >= -0.5) & (xo < out_h - 0.5) & (yo >= -0.5) & (yo < out_w - 0.5)
    rows, cols = round_int32(xo), round_int32(yo)

    b3 = lambda t: t[:, None, None]
    ys = torch.arange(out_h, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(out_w, device=dev, dtype=torch.float32)[None, None, :]
    zero = torch.zeros((1, 1, 1), device=dev)
    scale = torch.ones(B, device=dev)

    def source(yg, xg):
        dyo, dxo = (yg + b3(top)) - b3(cy), (xg + b3(left)) - b3(cx)
        src_x = b3(cx) + (b3(ct) * dxo - b3(st) * dyo)
        src_y = b3(cy) + (b3(st) * dxo + b3(ct) * dyo)
        return (src_y + b3(x_min)) / b3(scale), (src_x - b3(left_pad) + b3(y_min)) / b3(scale)

    src_rows = source(ys, zero)[0][..., 0]
    src_cols = source(zero, xs)[1][:, 0]
    Hc, Wc = image.shape[1:3]
    r_ok = (src_rows >= 0) & (src_rows <= (img_h - 1)[:, None])
    c_ok = (src_cols >= 0) & (src_cols <= (img_w - 1)[:, None])
    iy = round_int32(src_rows).clamp(0, Hc - 1).long()
    ix = round_int32(src_cols).clamp(0, Wc - 1).long()
    rgb = image[torch.arange(B, device=dev)[:, None, None], iy[:, :, None], ix[:, None, :]]
    return rows, cols, keep, torch.where((r_ok[:, :, None] & c_ok[:, None, :])[..., None], rgb, 0.0)


def flat_pixels(rows, cols, keep, H, W):
    r = rows.to(torch.int32).clamp(0, H - 1)
    c = cols.to(torch.int32).clamp(0, W - 1)
    return torch.where(keep, r * W + c, H * W)


def rasterize(rows, cols, depth, keep, values, H, W):
    """Each pixel takes the nearest point by depth quantum, the lowest index
    on ties: (canvas [B, H, W, F], mask [B, H, W])."""
    B, N, Fv = values.shape
    dev = values.device
    pix = flat_pixels(rows, cols, keep, H, W).long()
    dq = (depth.float() / DEPTH_QUANT).clamp(0, DQ_MAX).long()
    order = torch.sort(pix * (DQ_MAX + 1) + dq, dim=1, stable=True).indices
    spix = pix.gather(1, order)
    won = spix < H * W
    won[:, 1:] &= spix[:, 1:] != spix[:, :-1]
    b = torch.arange(B, device=dev)[:, None].expand(B, N)[won]
    canvas = torch.zeros((B, H * W, Fv), dtype=torch.float32, device=dev)
    mask = torch.zeros((B, H * W), dtype=torch.bool, device=dev)
    canvas[b, spix[won]] = values[b, order[won]].float()
    mask[b, spix[won]] = True
    return canvas.reshape(B, H, W, Fv), mask.reshape(B, H, W)


def packed_keys(rows, cols, depth, keep, H, W):
    N = depth.shape[-1]
    nbits = max(math.ceil(math.log2(max(N, 2))), 1)
    max_q = (1 << (31 - nbits)) - 1
    pix = flat_pixels(rows, cols, keep, H, W)
    dq = (depth.float() / DEPTH_QUANT).clamp(0, max_q).to(torch.int32)
    idx = torch.arange(N, dtype=torch.int32, device=depth.device)
    return pix, torch.where(keep, (dq << nbits) | idx, IMAX), nbits


def key_image(pix, key, H, W):
    """Scatter-min of the keys [B, N] at their flat pixels: [B, H·W + 1]."""
    hw = H * W
    p = torch.where((pix >= 0) & (pix < hw), pix, hw).long()
    out = torch.full((pix.shape[0], hw + 1), IMAX, dtype=torch.int32, device=pix.device)
    return out.scatter_reduce_(1, p, key, "amin")


def winner_flags(rows, cols, depth, keep, H, W):
    """Each point's flat pixel (H·W when not kept) and whether it won it."""
    pix, key, _ = packed_keys(rows, cols, depth, keep, H, W)
    img = key_image(pix, key, H, W)
    img[:, -1] = IMAX
    return pix, keep & (img.gather(1, pix.long()) == key)


def normalize(feature, mask, view: View):
    mean = torch.tensor(view.img_mean, dtype=feature.dtype, device=feature.device)
    std = torch.tensor(view.img_stds, dtype=feature.dtype, device=feature.device)
    lidar = (feature[..., :5] - mean) / std * mask[..., None].to(feature.dtype)
    return torch.cat([lidar, feature[..., 5:]], dim=-1)


def _values(points, labels):
    depth = point_depth(points)
    return depth, torch.cat([depth[..., None], points[..., :4], labels[..., None].float()], -1)


def pv_batch(points, labels, valid, proj, image, img_h, img_w, view: View,
             draws=None, return_points: bool = False):
    """PMF's batched view: the eval view, or with `draws` (`train_draws`)
    the train view; with `return_points` also (pt_pix, pt_label, pt_won)."""
    rows_f, cols_f, keep = kitti_project(points, proj, img_h, img_w, valid)
    depth, vals = _values(points, labels)
    if draws is None:
        H, W = view.proj_h, view.proj_w
        rows, cols, keep, rgb = eval_view(rows_f, cols_f, keep, image, img_h, img_w, view)
    else:
        H, W = view.proj_ht, view.proj_wt
        rows, cols, keep, rgb = train_view(rows_f, cols_f, keep, image, img_h, img_w, view,
                                           draws)
    canvas, mask = rasterize(rows, cols, depth, keep, vals, H, W)
    lab = torch.round(canvas[..., 5]).to(torch.int32)
    feature = normalize(torch.cat([canvas[..., :5], rgb], dim=-1), mask, view)
    if not return_points:
        return feature, mask, lab
    pix, won = winner_flags(rows, cols, depth, keep, H, W)
    return feature, mask, lab, (pix, labels.to(torch.int32), won)


def pv_scan(points, labels, valid, proj, image, img_h: int, img_w: int, view: View):
    """PMF's per-scan eval view through the packed-key z-buffer and a
    gather: (feature [H, W, 8], mask, label2d, rows, cols, keep)."""
    dev = points.device
    size = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)
    rows_f, cols_f, keep = kitti_project(points[None], proj[None], size(img_h), size(img_w),
                                         valid[None])
    rows, cols, keep, rgb = eval_view(rows_f, cols_f, keep, image[None], size(img_h),
                                      size(img_w), view)
    rows, cols, keep, rgb = rows[0], cols[0], keep[0], rgb[0]
    depth, vals = _values(points, labels)
    H, W = view.proj_h, view.proj_w
    pix, key, nbits = packed_keys(rows, cols, depth, keep, H, W)
    img = key_image(pix[None], key[None], H, W)[0, :H * W].reshape(H, W)
    mask = img != IMAX
    winner = torch.where(mask, img & ((1 << nbits) - 1), -1)
    canvas = torch.where(mask[..., None], vals[winner.clamp(min=0).long()], 0.0)
    lab = canvas[..., 5].to(torch.int32)
    feature = normalize(torch.cat([canvas[..., :5], rgb], dim=-1), mask, view)
    return feature, mask, lab, rows, cols, keep


def v2_batch(points, labels, valid, proj, image, img_h, img_w, view: View):
    """EPMF's batched eval view: (feature, mask, label)."""
    rows, cols, keep, rgb = v2_eval_view(points, valid, proj, image, img_h, img_w, view)
    depth, vals = _values(points, labels)
    canvas, mask = rasterize(rows, cols, depth, keep, vals, view.proj_h, view.proj_w)
    lab = torch.round(canvas[..., 5]).to(torch.int32)
    return normalize(torch.cat([canvas[..., :5], rgb], dim=-1), mask, view), mask, lab
