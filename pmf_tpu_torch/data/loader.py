"""Host-side scan readers (counterpart of `pmf_tpu/data/loader.py`; the
numpy + PIL path of `kitti_sample_reader`, the nuScenes readers and
`range_sample_reader`)."""
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


def nuscenes_sample_reader(dataset, cfg) -> Callable[[int], dict]:
    """reader(index) → the numpy sample dict of `kitti_sample_reader` for a
    nuScenes item (a `Nuscenes` (lidar, camera) pair): its scan in the
    lidar frame and its composed lidar → image matrix."""

    def read(index: int) -> dict:
        pcd, sem, _ = dataset.loadDataByIndex(index)
        points, labels, valid = pad_points(pcd, dataset.labelMapping(sem), cfg.n_points)
        image, img_h, img_w = pad_image(dataset.loadImage(index), cfg.canvas_h, cfg.canvas_w)
        return {
            "points": points, "labels": labels, "valid": valid,
            "proj_matrix": dataset.projection_matrix(index).astype(np.float32),
            "image": image, "img_h": img_h, "img_w": img_w,
            "index": np.int32(index),
        }

    return read


def nuscenes_v2_sample_reader(dataset, cfg) -> Callable[[int], dict]:
    """reader(index) → the sample dict of a `NuscenesV2` item for the V2
    view with `cam_frame`: the scan moved into the camera frame on the host,
    the projection [K' | 0] (the rescaled intrinsic alone), the resized
    image, and the camera's yaw field of view `fov` [2] (radians)."""

    def read(index: int) -> dict:
        pcd, sem, _ = dataset.loadDataByIndex(index)
        M, K = dataset.camera_transform(index)
        xyz_cam = pcd[:, :3] @ M[:3, :3].T + M[:3, 3]
        pcd_cam = np.concatenate([xyz_cam, pcd[:, 3:4]], axis=1)
        points, labels, valid = pad_points(pcd_cam, dataset.labelMapping(sem), cfg.n_points)
        image, img_h, img_w = pad_image(dataset.loadImage(index), cfg.canvas_h, cfg.canvas_w)
        proj = np.zeros((3, 4), np.float32)
        proj[:, :3] = K
        return {
            "points": points, "labels": labels, "valid": valid, "proj_matrix": proj,
            "image": image, "img_h": img_h, "img_w": img_w,
            "fov": np.asarray(dataset.fov(index), np.float32), "index": np.int32(index),
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
