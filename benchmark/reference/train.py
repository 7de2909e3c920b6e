"""PMF's train step in plain PyTorch: the losses (focal and point-domain
Lovász on both streams, the perception-aware KL) and the hybrid optimizer
(AdamW on the lidar stream, SGD with Nesterov momentum on the camera
streams, one learning rate schedule).

  loss = focal(lidar) + λ·lovász(lidar) + focal(cam) + λ·lovász(cam)
       + γ·(KL(pcd ‖ img)·img_guide + KL(img ‖ pcd)·pcd_guide)
"""
from __future__ import annotations

import math

import torch

CAMERA_KEYS = ("camera_stream_encoder", "camera_stream_decoder")


def one_hot(labels, C):
    return (labels[..., None] == torch.arange(C, device=labels.device)).float()


def focal(probs, target, alpha, gamma, mask):
    C = probs.shape[-1]
    p, t = probs.reshape(-1, C), target.reshape(-1)
    pt = (p * one_hot(t, C)).sum(dim=-1)
    loss = -((1.0 - pt) ** gamma) * torch.log(pt.clamp(min=1e-6)) * alpha[t.long()]
    m = mask.reshape(-1).float()
    return (loss * m).sum() / m.sum().clamp(min=1e-12)


def _jaccard_weights(err, fg):
    """The Lovász weight of each entry of the [R, P] errors, in their order."""
    order = torch.sort(err, dim=1, descending=True).indices
    fs = fg.gather(1, order)
    gts = fs.sum(dim=1, keepdim=True)
    jac = 1.0 - (gts - fs.cumsum(1)) / (gts + (1.0 - fs).cumsum(1)).clamp(min=1e-12)
    grad = torch.cat([jac[:, :1], jac[:, 1:] - jac[:, :-1]], dim=1)
    return torch.empty_like(grad).scatter_(1, order, grad)


def lovasz_points_pair(probs_list, labels_img, pt_pix, pt_label, pt_won, ignore=0):
    """The Lovász loss of each stream's canvas, ranked over the z-buffer's
    winning points (each labelled pixel is one winner's), the weights of
    both streams from one sort of their stacked errors."""
    B, H, W, C = probs_list[0].shape
    N, S = pt_pix.shape[1], len(probs_list)
    ok = pt_won & (pt_label != ignore)
    okf = ok.float()[..., None]
    fg = one_hot(pt_label, C) * okf
    with torch.no_grad():
        idx = pt_pix.long().clamp(0, H * W - 1)[..., None].expand(B, N, C)
        err = torch.cat([((fg - p.detach().reshape(B, H * W, C).gather(1, idx).float()).abs()
                          * okf).reshape(B * N, C).T for p in probs_list])
        y = torch.where(ok, pt_label, -1).reshape(B * N)
        w = _jaccard_weights(err, one_hot(y, C).T.repeat(S, 1))
        w_pts = w.T.reshape(B, N, S * C) * okf
        bi = torch.arange(B, device=pt_pix.device)[:, None].expand(B, N)[ok]
        w_img = torch.zeros((B, H * W, S * C), device=pt_pix.device)
        w_img[bi, pt_pix[ok].long()] = w_pts[ok]
        w_img = w_img.reshape(B, H, W, S * C)
    okimg = (labels_img != ignore).float()[..., None]
    fg_img = one_hot(labels_img, C) * okimg
    per_class = torch.stack([((fg_img - p.float()).abs() * okimg * w_img[..., s * C:(s + 1) * C])
                             .sum(dim=(0, 1, 2)) for s, p in enumerate(probs_list)])
    present = (fg.sum(dim=(0, 1)) > 0).float()
    return list((per_class * present).sum(dim=1) / present.sum().clamp(min=1.0))


def _entropy(p, logp):
    return -(p * logp).sum(dim=-1) / math.log(p.shape[-1])


def _kl(log_pred, target):
    return torch.where(target > 0, target * torch.log(target.clamp(min=1e-12)), 0.0) \
        - target * log_pred


def perception_aware(pcd, img, tau):
    pcd_log, img_log = torch.log(pcd.clamp(min=1e-8)), torch.log(img.clamp(min=1e-8))
    pcd_conf, img_conf = 1.0 - _entropy(pcd, pcd_log), 1.0 - _entropy(img, img_log)
    imp = pcd_conf - img_conf
    pcd_guide = (imp > 0) * imp.abs() * (pcd_conf >= tau)
    img_guide = (imp < 0) * imp.abs() * (img_conf >= tau)
    return ((_kl(pcd_log, img) * img_guide[..., None]).mean()
            + (_kl(img_log, pcd) * pcd_guide[..., None]).mean())


def pmf_losses(lidar, cam, label, points, loss: dict):
    """(total, {term: value}) of the two streams' probabilities against the
    canvas labels, with the points' (pixel, label, winner flag)."""
    alpha = torch.tensor(loss["alpha"], dtype=torch.float32, device=label.device)
    mask = label > 0
    lov, lov_cam = lovasz_points_pair([lidar, cam], label, *points, ignore=0)
    foc = focal(lidar, label, alpha, loss["gamma_focal"], mask)
    foc_cam = focal(cam, label, alpha, loss["gamma_focal"], mask)
    per = perception_aware(lidar, cam, loss["tau"])
    total = foc + lov * loss["lambda"] + foc_cam + lov_cam * loss["lambda"] + per * loss["gamma"]
    return total, {"focal": foc, "lovasz": lov, "focal_cam": foc_cam, "lovasz_cam": lov_cam,
                   "perception": per}


def warmup_cosine(lr: float, warmup: int, total: int):
    warmup = max(warmup, 1)

    def schedule(step: int) -> float:
        if step < warmup:
            return lr * step / warmup
        t = min(max(step - warmup, 0), total)
        return lr * 0.5 * (1.0 + math.cos(math.pi * t / max(total, 1)))

    return schedule


class HybridOptimizer:
    """AdamW (0.9/0.999, eps 1e-8, weight decay 0.01) on every parameter
    outside the camera streams, SGD (Nesterov, `momentum`, `weight_decay`)
    on the camera streams; the rate of each update read from `schedule` at
    the optimizer's step count, which starts at `start_step`."""

    def __init__(self, model, schedule, momentum, weight_decay, start_step=0):
        camera, other = [], []
        for name, p in model.named_parameters():
            (camera if name.split(".")[0] in CAMERA_KEYS else other).append(p)
        self.schedule, self.steps = schedule, start_step
        lr = schedule(start_step)
        self.optimizers = [
            torch.optim.AdamW(other, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01),
            torch.optim.SGD(camera, lr=lr, momentum=momentum, nesterov=True,
                            weight_decay=weight_decay)]

    def zero_grad(self):
        for o in self.optimizers:
            o.zero_grad(set_to_none=True)

    def step(self):
        lr = self.schedule(self.steps)
        for o in self.optimizers:
            for group in o.param_groups:
                group["lr"] = lr
            o.step()
        self.steps += 1
