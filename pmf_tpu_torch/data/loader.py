"""Host-side scan readers (counterpart of `pmf_tpu/data/loader.py`; the
numpy + PIL path of `kitti_sample_reader`, and `range_sample_reader`)."""
from __future__ import annotations

from typing import Callable

import numpy as np

from .perspective_pipeline import PVConfig, pad_image, pad_points


def kitti_sample_reader(dataset, cfg: PVConfig) -> Callable[[int], dict]:
    """reader(index) → numpy sample dict for the perspective-view pipeline:
    points [N, 4], labels [N] (train ids), valid [N], proj_matrix [3, 4],
    image [Hc, Wc, 3] in [0, 1], img_h, img_w, index."""

    def read(index: int) -> dict:
        pcd, sem, _ = dataset.loadDataByIndex(index)
        points, labels, valid = pad_points(pcd, dataset.labelMapping(sem), cfg.n_points)
        image, img_h, img_w = pad_image(dataset.loadImage(index), cfg.canvas_h,
                                        cfg.canvas_w)
        seq, _ = dataset.parsePathInfoByIndex(index)
        return {
            "points": points, "labels": labels, "valid": valid,
            "proj_matrix": dataset.projection_matrix(seq).astype(np.float32),
            "image": image, "img_h": img_h, "img_w": img_w,
            "index": np.int32(index),
        }

    return read


def range_sample_reader(dataset, cfg) -> Callable[[int], dict]:
    """reader(index) → numpy sample dict for the range view (no image):
    points [N, 4], labels [N] (train ids), valid [N], index."""

    def read(index: int) -> dict:
        pcd, sem, _ = dataset.loadDataByIndex(index)
        points, labels, valid = pad_points(pcd, dataset.labelMapping(sem), cfg.n_points)
        return {"points": points, "labels": labels, "valid": valid, "index": np.int32(index)}

    return read
