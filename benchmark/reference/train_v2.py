"""EPMF's train step in plain PyTorch: the V2 train view, the losses with
the learned multi-task weighting, and the hybrid optimizer that also steps
the weighting's σ.

The view (EPMF's `PVconfig` train path): the kept points of the yaw crop
(`view.yaw_project`) scaled by a random factor in [1.0, 1.2], truncated to
integers, boxed tightly (padded to at least the output: below, and centred
in width), then flipped, rotated about the box's centre by up to ±15° and
cropped at random; the RGB is ColorJitter'ed and sampled bilinearly by the
inverse map. It draws from a `torch.Generator` in the port's order: five
uniforms a scan (scale, flip, angle, crop top, crop left), then the
jitter's three factors and three uniforms whose argsort orders its ops.
The fill is `view.rasterize` (the batched z-buffer).

The losses (`epmf_kitti.yaml`: `use_mtloss: true`, `point_lovasz: false`):
focal and image-domain Lovász on both streams, the two perception-aware
KL terms, weighted by σ (starting at ones(6) / 6) as
Σ lᵢ / (2σᵢ²) + log(σᵢ² + 1) over [focal(cam), lovász(cam), KL(img ‖ pcd),
KL(pcd ‖ img), focal(lidar), lovász(lidar)].

Departures from the published description: none in the arithmetic; the
view follows the float32 order of the port and the JAX package.
"""
from __future__ import annotations

import math

import torch

from . import train as ref_train
from .train import _entropy, _jaccard_weights, _kl, focal, one_hot
from .view import View, _bbox, color_jitter, rasterize, round_int32, saturating_int32, \
    normalize, point_depth, yaw_project

SCALE = (1.0, 1.2)
ROT_DEG = 15.0
P_HFLIP = 0.5
N_TERMS = 6


def train_draws(g: torch.Generator, batch: int, view: View, dev):
    """(u [B, 5], jitter factors [B, 3], jitter order [B, 3]) of a batch."""
    u = torch.rand((batch, 5), generator=g, device=dev)
    lo = torch.tensor([max(0.0, 1.0 - s) for s in view.img_jitter], device=dev)
    hi = torch.tensor([1.0 + s for s in view.img_jitter], device=dev)
    f = torch.rand((batch, 3), generator=g, device=dev)
    order = torch.rand((batch, 3), generator=g, device=dev).argsort(dim=1)
    return u, f * (hi - lo) + lo, order


def _bilinear(image, rows, cols, img_h, img_w):
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


def v2_train_batch(points, labels, valid, proj, image, img_h, img_w, view: View, draws):
    """EPMF's batched train view: (feature, mask, label) at (proj_ht, proj_wt)."""
    u, factors, order = draws
    B, dev = points.shape[0], points.device
    out_h, out_w = view.proj_ht, view.proj_wt
    scale = SCALE[0] + u[:, 0] * (SCALE[1] - SCALE[0])
    b1 = lambda t: t[:, None]
    rows_f, cols_f, keep = yaw_project(points, proj, view.fov_left, view.fov_right, valid)
    x = saturating_int32(torch.trunc(rows_f * b1(scale)))
    y = saturating_int32(torch.trunc(cols_f * b1(scale)))
    x_min, x_max = _bbox(x, keep)
    y_min, y_max = _bbox(y, keep)
    h, w = x_max - x_min + 1, y_max - y_min + 1
    max_h, max_w = h.clamp(min=out_h), w.clamp(min=out_w)
    left_pad = (max_w - w) // 2
    slack_h, slack_w = (max_h - out_h).clamp(min=0), (max_w - out_w).clamp(min=0)
    crop = lambda v, slack: torch.minimum((v * (slack + 1)).long(), slack.long())
    flip = u[:, 1] < P_HFLIP
    theta = ((u[:, 2] * 2.0 - 1.0) * ROT_DEG * (math.pi / 180.0)).float()
    top, left = crop(u[:, 3], slack_h).float(), crop(u[:, 4], slack_w).float()

    cy, cx = (max_h.float() - 1.0) / 2.0, (max_w.float() - 1.0) / 2.0
    ct, st = torch.cos(theta), torch.sin(theta)
    xp = (x - b1(x_min)).float()
    yp = (y - b1(y_min) + b1(left_pad)).float()
    yp = torch.where(b1(flip), b1(max_w.float()) - 1.0 - yp, yp)
    dxs, dys = yp - b1(cx), xp - b1(cy)
    xo = b1(cy) + (-b1(st) * dxs + b1(ct) * dys) - b1(top)
    yo = b1(cx) + (b1(ct) * dxs + b1(st) * dys) - b1(left)
    keep = keep & (xo >= -0.5) & (xo < out_h - 0.5) & (yo >= -0.5) & (yo < out_w - 0.5)
    rows, cols = round_int32(xo), round_int32(yo)
    depth = point_depth(points)
    vals = torch.cat([depth[..., None], points[..., :4], labels[..., None].float()], -1)

    b3 = lambda t: t[:, None, None]
    ys = torch.arange(out_h, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(out_w, device=dev, dtype=torch.float32)[None, None, :]
    dyo, dxo = (ys + b3(top)) - b3(cy), (xs + b3(left)) - b3(cx)
    src_x = b3(cx) + (b3(ct) * dxo - b3(st) * dyo)
    src_y = b3(cy) + (b3(st) * dxo + b3(ct) * dyo)
    src_x = torch.where(b3(flip), b3(max_w.float()) - 1.0 - src_x, src_x)
    src_r = (src_y + b3(x_min)) / b3(scale)
    src_c = (src_x - b3(left_pad) + b3(y_min)) / b3(scale)
    image = color_jitter(image, img_h, img_w, factors, order)
    rgb = _bilinear(image, src_r, src_c, img_h, img_w)

    canvas, mask = rasterize(rows, cols, depth, keep, vals, out_h, out_w)
    lab = torch.round(canvas[..., 5]).to(torch.int32)
    return normalize(torch.cat([canvas[..., :5], rgb], dim=-1), mask, view), mask, lab


def lovasz_image(probs, labels, ignore=0):
    """The Lovász-softmax loss over every pixel of the batch, the mean over
    the classes present in the labels."""
    C = probs.shape[-1]
    p, y = probs.reshape(-1, C).float(), labels.reshape(-1)
    ok = y != ignore
    okf = ok.float()[:, None]
    fg = one_hot(y, C) * okf
    err = ((fg - p).abs() * okf).T
    with torch.no_grad():
        w = _jaccard_weights(err.detach(), one_hot(torch.where(ok, y, -1), C).T)
    present = (fg.sum(dim=0) > 0).float()
    return ((err * w).sum(dim=1) * present).sum() / present.sum().clamp(min=1.0)


def perception_terms(pcd, img, tau):
    """(KL(pcd ‖ img) by the camera's guide, KL(img ‖ pcd) by the lidar's)."""
    pcd_log, img_log = torch.log(pcd.clamp(min=1e-8)), torch.log(img.clamp(min=1e-8))
    pcd_conf, img_conf = 1.0 - _entropy(pcd, pcd_log), 1.0 - _entropy(img, img_log)
    imp = pcd_conf - img_conf
    pcd_guide = (imp > 0) * imp.abs() * (pcd_conf >= tau)
    img_guide = (imp < 0) * imp.abs() * (img_conf >= tau)
    return ((_kl(pcd_log, img) * img_guide[..., None]).mean(),
            (_kl(img_log, pcd) * pcd_guide[..., None]).mean())


def epmf_losses(lidar, cam, label, sigma, loss: dict):
    """(total, {term: value}) of the two streams' probabilities under the
    multi-task weighting by σ."""
    alpha = torch.tensor(loss["alpha"], dtype=torch.float32, device=label.device)
    mask = label > 0
    terms = {"focal_cam": focal(cam, label, alpha, loss["gamma_focal"], mask),
             "lovasz_cam": lovasz_image(cam, label),
             "perception_img": None, "perception_pcd": None,
             "focal": focal(lidar, label, alpha, loss["gamma_focal"], mask),
             "lovasz": lovasz_image(lidar, label)}
    terms["perception_pcd"], terms["perception_img"] = perception_terms(lidar, cam, loss["tau"])
    s2 = sigma ** 2
    total = (torch.stack(list(terms.values())) / (2.0 * s2) + torch.log(s2 + 1.0)).sum()
    return total, terms


def init_sigma(dev) -> torch.Tensor:
    return torch.nn.Parameter(torch.ones(N_TERMS, device=dev) / N_TERMS)


class HybridOptimizer(ref_train.HybridOptimizer):
    """`train.HybridOptimizer` with σ stepped by the AdamW, after the
    lidar stream's parameters."""

    def __init__(self, model, sigma, schedule, momentum, weight_decay, start_step=0):
        super().__init__(model, schedule, momentum, weight_decay, start_step)
        self.optimizers[0].param_groups[0]["params"].append(sigma)
