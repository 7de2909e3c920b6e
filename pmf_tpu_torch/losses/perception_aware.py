"""Perception-aware loss: the entropy-gated bidirectional KL between the
two streams (counterpart of `pmf_tpu/losses/perception_aware.py`).

  entropy    = -sum_c p log p / log C
  confidence = 1 - entropy
  importance = conf_pcd - conf_img
  pcd_guide  = [importance > 0] · |importance| · [conf_pcd >= tau]
  img_guide  = [importance < 0] · |importance| · [conf_img >= tau]
  loss_pcd   = mean(KL(pcd_log ‖ img) · img_guide)
  loss_img   = mean(KL(img_log ‖ pcd) · pcd_guide)
The gradient flows through the guides, as in the JAX package. The means
run over the global batch while a process group is up.
"""
from __future__ import annotations

import torch

from ..parallel import global_sum_count
from .kl import kl_div


def normalized_entropy(probs: torch.Tensor, log_probs: torch.Tensor) -> torch.Tensor:
    """Per-pixel entropy of [..., C] probabilities, divided by log C."""
    log_c = torch.log(torch.tensor(float(probs.shape[-1]), dtype=probs.dtype))
    return -(probs * log_probs).sum(dim=-1) / log_c.to(probs.device)


def perception_aware_losses(pcd_probs: torch.Tensor, img_probs: torch.Tensor,
                            tau: float = 0.7):
    """(loss_pcd, loss_img, pcd_guide, img_guide) of [..., C] probabilities."""
    pcd_log = torch.log(pcd_probs.clamp(min=1e-8))
    img_log = torch.log(img_probs.clamp(min=1e-8))
    pcd_conf = 1.0 - normalized_entropy(pcd_probs, pcd_log)
    img_conf = 1.0 - normalized_entropy(img_probs, img_log)
    importance = pcd_conf - img_conf
    pcd_guide = (importance > 0) * importance.abs() * (pcd_conf >= tau)
    img_guide = (importance < 0) * importance.abs() * (img_conf >= tau)
    kl_pcd = kl_div(pcd_log, img_probs) * img_guide[..., None]
    kl_img = kl_div(img_log, pcd_probs) * pcd_guide[..., None]
    sums, n = global_sum_count(torch.stack([kl_pcd.sum(), kl_img.sum()]), kl_pcd.numel())
    loss_pcd, loss_img = sums / n
    return loss_pcd, loss_img, pcd_guide, img_guide


def perception_aware_loss(pcd_probs: torch.Tensor, img_probs: torch.Tensor, tau: float = 0.7):
    """(loss_pcd + loss_img, pcd_guide, img_guide): the bidirectional loss as
    one number, with the guide weights (pmf_tpu's trainer logs them)."""
    loss_pcd, loss_img, pcd_guide, img_guide = perception_aware_losses(pcd_probs, img_probs, tau)
    return loss_pcd + loss_img, pcd_guide, img_guide
