"""EPMF's per-item eval view (the V2 view) for one (lidar, camera) item of a
nuScenes keyframe, in plain PyTorch: `view.v2_eval_view` (the ±45° yaw crop
about the lidar's front, the kept points' tight box padded to the output and
centre-cropped, the RGB a separable integer gather), then the per-scan
packed-key z-buffer and a gather, then the normalization.

The crop is taken about the lidar frame's front whatever the camera, as
EPMF's nuScenes eval gives each item its composed lidar → image matrix with
the V2 view's default ±45° (ROADMAP C6): a camera that does not face the
front sees the front's points projected behind it or near its image plane,
so its tight box is wide and the centre crop keeps few of them, or none.

The arithmetic and its order are `view.py`'s, which the port computes, so
the pixels agree bit for bit. The view holds no matrix product or
convolution, so TF32 cannot reach it; the reference net beside it
(`nets.EPMFNet`) runs with TF32 off, as the configuration's `tf32: false`
sets it.
"""
from __future__ import annotations

import torch

from .view import IMAX, View, _values, key_image, normalize, packed_keys, v2_eval_view


def v2_item(points, labels, valid, proj, image, img_h: int, img_w: int, view: View):
    """One item's eval view: (feature [H, W, 8], mask, label2d, rows, cols,
    keep, depth), as the port's `build_v2_eval_sample_with_uproj` gives them."""
    dev = points.device
    size = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)
    rows, cols, keep, rgb = v2_eval_view(points[None], valid[None], proj[None], image[None],
                                         size(img_h), size(img_w), view)
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
    return feature, mask, lab, rows, cols, keep, depth
