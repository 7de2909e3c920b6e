"""PMF's nuScenes eval view (the "cam" projection) for one (lidar, camera)
item, and the merge of a keyframe's six items, in plain PyTorch and numpy.

The "cam" projection keeps a point whose depth in the camera frame (the
third row of the lidar → image matrix) is above `min_depth` and whose pixel
lies more than `margin` pixels inside the image; the rest of the view is
`view.py`'s per-scan eval view (centre crop, the packed-key z-buffer and a
gather), whose arithmetic and order it shares, so the pixels agree with the
port's bit for bit.

The merge (ICEORY/PMF `pmf_eval_nuscenes/infer.py`): each item lifts its
probabilities to the points through their pixels (class by the first
maximum, confidence the maximum; class 0 and confidence -1 where the item
did not keep the point); running over the six items in order, a camera
takes a point only where its confidence is strictly higher than what the
point holds, so ties keep the earlier camera, and points no camera kept
keep class 0.

Departures from the published description: the published loop
(`pmf_eval_nuscenes/infer.py:18-38`) stacks the six cameras' confidences and
merges once per keyframe; the running merge here gives the same classes,
since a strictly higher confidence wins and a tie keeps the earlier camera,
as a first maximum over the stacked cameras does. The view computes in the
float32 order of the port and the JAX package, not the published loader's
(`nus_perspective_loader.py`), so a point on a pixel's edge may land on the
neighbouring pixel of the published code's.
"""
from __future__ import annotations

import numpy as np
import torch

from .view import (IMAX, View, _project, _values, eval_view, key_image, normalize,
                   packed_keys)

MIN_DEPTH = 1.0     # PVConfig.min_depth: the least camera-frame depth kept
MARGIN = 1.0        # the image border, pixels


def cam_project(points, proj, img_h, img_w, valid, min_depth=MIN_DEPTH, margin=MARGIN):
    """(rows, cols, keep) of points [B, N, 4] through proj [B, 3, 4]."""
    uvw = _project(points, proj)
    w = uvw[..., 2]
    keep = (w > min_depth) & valid
    safe = torch.where(w.abs() > 1e-9, w, 1e-9)
    u, v = uvw[..., 0] / safe, uvw[..., 1] / safe
    h, wd = img_h[..., None], img_w[..., None]
    keep = keep & (u > margin) & (u < wd - margin) & (v > margin) & (v < h - margin)
    return v, u, keep


def cam_item(points, labels, valid, proj, image, img_h: int, img_w: int, view: View):
    """One item's eval view through the packed-key z-buffer and a gather:
    (feature [H, W, 8], mask, label2d, rows, cols, keep)."""
    dev = points.device
    size = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)
    rows_f, cols_f, keep = cam_project(points[None], proj[None], size(img_h), size(img_w),
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


def first_argmax(probs):
    """The index of the first maximum over the last axis."""
    c = probs.shape[-1]
    top = probs == probs.amax(-1, keepdim=True)
    return torch.where(top, torch.arange(c, device=probs.device), c).amin(-1)


def lift(probs, rows, cols, keep):
    """An item's per-point (class, confidence) as numpy: the class and the
    confidence at each point's clipped pixel; 0 and -1 where not kept."""
    H, W = probs.shape[:2]
    r, c = rows.clamp(0, H - 1).long(), cols.clamp(0, W - 1).long()
    cls = torch.where(keep, first_argmax(probs)[r, c], 0)
    conf = torch.where(keep, probs.float().amax(-1)[r, c], -1.0)
    return cls.cpu().numpy(), conf.cpu().numpy()


def merge(items) -> np.ndarray:
    """The keyframe's classes from its items' (class, confidence), in
    camera order: a strictly higher confidence takes a point."""
    pred, conf = items[0]
    pred, conf = pred.copy(), conf.copy()
    for p, c in items[1:]:
        better = c > conf
        conf = np.where(better, c, conf)
        pred = np.where(better, p, pred)
    return pred


def keyframe_confusion(pred: np.ndarray, labels: np.ndarray, valid: np.ndarray,
                       nclasses: int) -> np.ndarray:
    """conf[pred, label] over the keyframe's valid points that some camera
    covered (class > 0)."""
    n = int(valid.sum())
    p, t = pred[:n].astype(np.int64), labels[:n].astype(np.int64)
    covered = p > 0
    return np.bincount(p[covered] * nclasses + t[covered],
                       minlength=nclasses * nclasses).reshape(nclasses, nclasses).astype(np.float64)
