"""Lovász-softmax loss (counterpart of `pmf_tpu/losses/lovasz.py`).

Berman et al.'s Lovász extension of the Jaccard loss, `classes='present'`,
with ignored pixels kept in place at fg = 0 and error 0: they sort to the
tail and change no intersection or union that ranks before them, so the
masked form equals the one that removes them.

The Jaccard weights are detached, as the reference and the JAX package do:
the gradient of the loss w.r.t. an error is the weight at that error's rank.
The weights come from one descending sort per class row and go back to the
entries' own order by a scatter of the sort's permutation, so the loss is an
elementwise product of errors and weights, and so is its backward pass.

The point forms rank the z-buffer winners instead of the canvas pixels: every
labelled pixel of the rasterized canvas is exactly one winning point's
(`ops/scatter.py: point_winner_flags`), so the ranking over points is the
ranking over pixels. The weights are then placed back on the canvas
(`rasterize_unique`) and the loss is taken there. This holds where the
winner flags and the canvas use the same depth quantization, which is true
for N <= 32768 points a scan (see ROADMAP B).

While a process group is up the ranking runs over the global batch, as
pmf_tpu's sort over a `data`-sharded batch does: every process gathers all
processes' errors and labels (detached: the weights are), computes the
weights of the whole batch, and keeps its own columns; the per-class sums
of error · weight and the foreground counts are then summed over the
processes (`parallel.global_sum`, the gradient flowing back through it).
"""
from __future__ import annotations

import torch

from ..ops.scatter import rasterize_unique
from ..parallel import gather_cols, global_sum, own_cols
from .focal import one_hot


def _lovasz_grad(fg_sorted: torch.Tensor) -> torch.Tensor:
    """Jaccard differences of [R, P] {0, 1} foreground indicators in
    descending-error order (Alg. 1 of Berman et al.)."""
    gts = fg_sorted.sum(dim=1, keepdim=True)
    intersection = gts - fg_sorted.cumsum(dim=1)
    union = gts + (1.0 - fg_sorted).cumsum(dim=1)
    jaccard = 1.0 - intersection / union.clamp(min=1e-12)
    return torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], dim=1)


@torch.no_grad()
def _jaccard_weights(err: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """The detached weight of each entry of the [R, P] errors, in the
    entries' own order. Ties may sort either way: the loss's value does not
    depend on their order."""
    order = torch.sort(err, dim=1, descending=True).indices
    grad = _lovasz_grad(fg.gather(1, order))
    return torch.empty_like(grad).scatter_(1, order, grad)


@torch.no_grad()
def _global_weights(err: torch.Tensor, y: torch.Tensor, C: int) -> torch.Tensor:
    """The detached weights of this process's [R, P] errors ranked among all
    processes' (R = S·C rows of S streams, C classes each); y [P] are the
    entries' labels, -1 where not counted."""
    err_all, y_all = gather_cols(err.detach()), gather_cols(y[None])[0]
    fg_all = one_hot(y_all, C).T.repeat(err.shape[0] // C, 1)
    return own_cols(_jaccard_weights(err_all, fg_all), err.shape[1])


def _present_mean(per_class: torch.Tensor, fg_count: torch.Tensor) -> torch.Tensor:
    """The mean over the classes present in the global batch of the [S, C]
    per-class sums (summed over the processes here), one per stream."""
    sums = global_sum(torch.cat([per_class, fg_count[None]]))
    present = (sums[-1] > 0).float()
    return (sums[:-1] * present).sum(dim=1) / present.sum().clamp(min=1.0)


def lovasz_softmax_loss(probs: torch.Tensor, labels: torch.Tensor,
                        ignore: int | None = 0,
                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """probs [..., C] class probabilities, labels [...] integer ground truth;
    `ignore` (None: no label is ignored) and the optional boolean `valid`
    [...] take pixels out. The mean over the classes present in the labels."""
    C = probs.shape[-1]
    p = probs.reshape(-1, C).float()
    y = labels.reshape(-1)
    ok = torch.ones_like(y, dtype=torch.bool)
    if ignore is not None:
        ok &= y != ignore
    if valid is not None:
        ok &= valid.reshape(-1)
    okf = ok.float()[:, None]
    fg = one_hot(y, C) * okf                            # [P, C]
    err = ((fg - p).abs() * okf).T                      # [C, P]
    w = _global_weights(err, torch.where(ok, y, -1), C)
    return _present_mean((err * w).sum(dim=1)[None], fg.sum(dim=0))[0]


def _points_losses(probs_list, labels_img, pt_pix, pt_label, pt_won, ignore):
    """The point-domain Lovász loss of each [B, H, W, C] probability tensor
    in `probs_list` over the same canvas labels, with the weights of all
    streams from one sort of their stacked [S·C, B·N] errors."""
    B, H, W, C = probs_list[0].shape
    HW, N, S = H * W, pt_pix.shape[1], len(probs_list)
    ok = pt_won if ignore is None else pt_won & (pt_label != ignore)
    okf = ok.float()[..., None]
    fg = one_hot(pt_label, C) * okf                     # [B, N, C]
    with torch.no_grad():
        # gather in the model's compute dtype and cast after: exact
        idx = pt_pix.clamp(max=HW - 1).long()[..., None].expand(B, N, C)
        err = torch.cat([((fg - p.detach().reshape(B, HW, C).gather(1, idx).float()).abs() * okf)
                         .reshape(B * N, C).T for p in probs_list])
        w = _global_weights(err, torch.where(ok, pt_label, -1).reshape(B * N), C)
        w_pts = w.T.reshape(B, N, S * C) * okf
        w_img = rasterize_unique(pt_pix, ok, w_pts, H, W)[0]     # [B, H, W, S·C]

    ok_img = labels_img != ignore if ignore is not None else torch.ones_like(labels_img, dtype=torch.bool)
    okimg = ok_img.float()[..., None]
    fg_img = one_hot(labels_img, C) * okimg
    per_class = torch.stack([
        ((fg_img - probs.float()).abs() * okimg * w_img[..., s * C:(s + 1) * C]).sum(dim=(0, 1, 2))
        for s, probs in enumerate(probs_list)])
    return list(_present_mean(per_class, fg.sum(dim=(0, 1))))


def lovasz_softmax_loss_points(probs, labels_img, pt_pix, pt_label, pt_won,
                               ignore: int | None = 0) -> torch.Tensor:
    """`lovasz_softmax_loss(probs, labels_img, ignore)` for canvas labels
    rasterized from the points, ranked over the winner points.

    probs [B, H, W, C]; labels_img [B, H, W]; pt_pix [B, N] flat pixel id
    per point (H·W for points not kept), pt_label [B, N], pt_won [B, N]
    winner flags, as `build_batch(..., return_points=True)` gives them."""
    return _points_losses([probs], labels_img, pt_pix, pt_label, pt_won, ignore)[0]


def lovasz_softmax_loss_points_pair(probs_a, probs_b, labels_img, pt_pix, pt_label,
                                    pt_won, ignore: int | None = 0):
    """`lovasz_softmax_loss_points` of two streams (lidar and camera) over the
    same canvas labels, their weights from one stacked sort: (loss_a, loss_b)."""
    return tuple(_points_losses([probs_a, probs_b], labels_img, pt_pix, pt_label, pt_won,
                                ignore))
