"""PMF train and eval steps (counterpart of `pmf_tpu/train/steps.py`).

  loss = focal(lidar) + λ·lovász(lidar) + focal(cam) + λ·lovász(cam)
       + γ·perception_aware(lidar, cam)
with the focal terms masked to labelled pixels (label > 0), the point-domain
Lovász pair when the batch carries the points' winner flags, and the
confusion matrices of both streams per batch. The model's parameters, its BN
statistics and the optimizer's moments are the train state; a train step
updates them in place.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..losses import (focal_softmax_loss, lovasz_softmax_loss,
                      lovasz_softmax_loss_points_pair, normalized_entropy,
                      perception_aware_losses)
from ..metrics.iou import confusion_matrix
from ..ops.reduce import argmax_last


@dataclass(frozen=True)
class LossConfig:
    nclasses: int = 20
    alpha: tuple = ()          # per-class focal alpha
    gamma_focal: float = 2.0
    lambda_: float = 1.0       # Lovász weight
    gamma: float = 0.5         # perception-aware weight
    tau: float = 0.7           # confidence gate
    lovasz_ignore: int = 0


def pmf_losses(lidar_pred, camera_pred, label, cfg: LossConfig, points=None):
    """(total, aux) of the two streams' [B, H, W, C] probabilities against
    the canvas labels [B, H, W]; `points` = (pt_pix, pt_label, pt_won) from
    `build_batch(..., return_points=True)` switches Lovász to the point
    domain."""
    alpha = torch.tensor(cfg.alpha, dtype=torch.float32, device=label.device)
    label_mask = label > 0
    if points is not None:
        loss_lov, loss_lov_cam = lovasz_softmax_loss_points_pair(
            lidar_pred, camera_pred, label, *points, ignore=cfg.lovasz_ignore)
    else:
        loss_lov = lovasz_softmax_loss(lidar_pred, label, ignore=cfg.lovasz_ignore)
        loss_lov_cam = lovasz_softmax_loss(camera_pred, label, ignore=cfg.lovasz_ignore)
    loss_foc = focal_softmax_loss(lidar_pred, label, alpha, cfg.gamma_focal, label_mask)
    loss_foc_cam = focal_softmax_loss(camera_pred, label, alpha, cfg.gamma_focal, label_mask)
    loss_per_pcd, loss_per_img, _, _ = perception_aware_losses(lidar_pred, camera_pred, cfg.tau)
    loss_per = loss_per_pcd + loss_per_img
    total = (loss_foc + loss_lov * cfg.lambda_ + loss_foc_cam + loss_lov_cam * cfg.lambda_
             + loss_per * cfg.gamma)
    with torch.no_grad():
        lidar_log = torch.log(lidar_pred.clamp(min=1e-8))
        cam_log = torch.log(camera_pred.clamp(min=1e-8))
        entropy = normalized_entropy(lidar_pred, lidar_log).mean()
        entropy_cam = normalized_entropy(camera_pred, cam_log).mean()
    aux = {"loss": total, "loss_focal": loss_foc, "loss_lovasz": loss_lov,
           "loss_focal_cam": loss_foc_cam, "loss_lovasz_cam": loss_lov_cam,
           "loss_perception": loss_per, "entropy": entropy, "entropy_cam": entropy_cam}
    return total, aux


def _confusions(aux, lidar_pred, camera_pred, label, nclasses, valid=None):
    aux["conf"] = confusion_matrix(argmax_last(lidar_pred), label, nclasses, valid)
    aux["conf_cam"] = confusion_matrix(argmax_last(camera_pred), label, nclasses, valid)
    return aux


def make_pmf_train_step(model, optimizer, cfg: LossConfig):
    """step(feature [B, H, W, 8], label [B, H, W], generator, points=None)
    → aux: forward in train mode (dropout from `generator`), the losses,
    backward, one optimizer update; aux holds the detached loss terms and
    the [C, C] confusion matrices of both streams, on the batch's device."""

    def step(feature, label, generator=None, points=None):
        model.train()
        optimizer.zero_grad()
        lidar_pred, camera_pred = model(feature[..., 0:5], feature[..., 5:8], generator)
        total, aux = pmf_losses(lidar_pred, camera_pred, label, cfg, points)
        total.backward()
        optimizer.step()
        with torch.no_grad():
            aux = {k: v.detach() for k, v in aux.items()}
            return _confusions(aux, lidar_pred, camera_pred, label, cfg.nclasses)

    return step


def make_pmf_eval_step(model, cfg: LossConfig):
    """step(feature, label, sample_valid=None, points=None) → (aux,
    lidar_pred) with the model in eval mode; `sample_valid` [B] takes padded
    samples of a short last batch out of the confusion matrices."""

    @torch.inference_mode()
    def step(feature, label, sample_valid=None, points=None):
        model.eval()
        lidar_pred, camera_pred = model(feature[..., 0:5], feature[..., 5:8])
        _, aux = pmf_losses(lidar_pred, camera_pred, label, cfg, points)
        valid = None
        if sample_valid is not None:
            valid = sample_valid[:, None, None].expand(label.shape)
        return _confusions(aux, lidar_pred, camera_pred, label, cfg.nclasses, valid), lidar_pred

    return step
