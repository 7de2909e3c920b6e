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
Under a row split (`parallel/spatial.py`) each rank holds some rows of its
data group's canvas: the image form gathers every rank's pixels (blocks of
uneven widths) and ranks them in one process's order (sample, row, column),
so that float32 ties between errors take the weights they take there, and
the point form takes each point's error on the rank that holds its pixel's
row, sums it over the model group (the other ranks add zeros), ranks the
data groups' points, and keeps its own rows of the weights' canvas.
"""
from __future__ import annotations

import torch

from ..ops.scatter import rasterize_unique
from ..parallel import col_layout, gather_cols, global_sum, own_cols, spatial
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


def _one_process_order(layout, batch: int, device) -> torch.Tensor:
    """The gathered columns of row blocks (each rank's [batch, h, W]
    pixels, flattened, in rank order) in the order one process holds them:
    data group, sample, row, column. Ties among the errors then rank as
    they do in one process."""
    split = spatial.active()
    offsets = torch.tensor((0,) + layout.sizes, device=device).cumsum(0).tolist()
    M = split.M
    pieces = []
    for d in range(len(layout.sizes) // M):
        blocks = [torch.arange(offsets[r], offsets[r + 1], device=device).reshape(batch, -1)
                  for r in range(d * M, (d + 1) * M)]
        pieces.append(torch.cat(blocks, dim=1).reshape(-1))
    return torch.cat(pieces)


@torch.no_grad()
def _global_weights(err: torch.Tensor, y: torch.Tensor, C: int, replicated: bool = False,
                    batch: int | None = None) -> torch.Tensor:
    """The detached weights of this process's [R, P] errors ranked among all
    processes' (R = S·C rows of S streams, C classes each); y [P] are the
    entries' labels, -1 where not counted. `replicated`: the entries are the
    same on every rank of a model group (`parallel.col_layout`); `batch`:
    they are the pixels of a row block of `batch` samples, put back in one
    process's order before the ranking."""
    layout = col_layout(err.shape[1], replicated, err.device)
    err_all, y_all = gather_cols(err.detach(), layout), gather_cols(y[None], layout)[0]
    if layout is None or batch is None:
        fg_all = one_hot(y_all, C).T.repeat(err.shape[0] // C, 1)
        return own_cols(_jaccard_weights(err_all, fg_all), err.shape[1], layout)
    order = _one_process_order(layout, batch, err.device)
    fg_all = one_hot(y_all[order], C).T.repeat(err.shape[0] // C, 1)
    w = _jaccard_weights(err_all[:, order], fg_all)
    position = torch.empty_like(order)
    position[order] = torch.arange(order.numel(), device=order.device)
    return w[:, position[layout.offset:layout.offset + err.shape[1]]]


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
    w = _global_weights(err, torch.where(ok, y, -1), C,
                        batch=probs.shape[0] if probs.dim() == 4 else None)
    return _present_mean((err * w).sum(dim=1)[None], fg.sum(dim=0))[0]


def _points_losses(probs_list, labels_img, pt_pix, pt_label, pt_won, ignore):
    """The point-domain Lovász loss of each [B, H, W, C] probability tensor
    in `probs_list` over the same canvas labels, with the weights of all
    streams from one sort of their stacked [S·C, B·N] errors."""
    B, h, W, C = probs_list[0].shape
    split = spatial.active()
    H = spatial.height(probs_list[0], 1)
    lo = 0 if split is None else split.rows(H)[0]
    N, S = pt_pix.shape[1], len(probs_list)
    ok = pt_won if ignore is None else pt_won & (pt_label != ignore)
    okf = ok.float()[..., None]
    fg = one_hot(pt_label, C) * okf                     # [B, N, C]
    with torch.no_grad():
        # gather in the model's compute dtype and cast after: exact; under a
        # row split each point's error on the rank that holds its row
        local = pt_pix.long() - lo * W
        mine = okf if split is None else okf * ((local >= 0) & (local < h * W)).float()[..., None]
        idx = local.clamp(min=0, max=max(h * W - 1, 0))[..., None].expand(B, N, C)
        err = torch.cat([((fg - p.detach().reshape(B, h * W, C).gather(1, idx).float()).abs() * mine)
                         .reshape(B * N, C).T if h else fg.new_zeros(C, B * N)
                         for p in probs_list])
        w = _global_weights(spatial.model_sum(err), torch.where(ok, pt_label, -1).reshape(B * N),
                            C, replicated=split is not None)
        w_pts = w.T.reshape(B, N, S * C) * okf
        w_img = rasterize_unique(pt_pix, ok, w_pts, H, W)[0][:, lo:lo + h]   # [B, h, W, S·C]

    ok_img = labels_img != ignore if ignore is not None else torch.ones_like(labels_img, dtype=torch.bool)
    okimg = ok_img.float()[..., None]
    fg_img = one_hot(labels_img, C) * okimg
    per_class = torch.stack([
        ((fg_img - probs.float()).abs() * okimg * w_img[..., s * C:(s + 1) * C]).sum(dim=(0, 1, 2))
        for s, probs in enumerate(probs_list)])
    fg_count = fg.sum(dim=(0, 1))
    if split is not None and split.m:
        fg_count = fg_count * 0.0                       # the model group's points, once
    return list(_present_mean(per_class, fg_count))


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
