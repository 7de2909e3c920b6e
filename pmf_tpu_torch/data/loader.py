"""Host-side scan readers (counterpart of `pmf_tpu/data/loader.py`; the
numpy + PIL path of `kitti_sample_reader`, the nuScenes readers,
`range_sample_reader`, the A2D2 reader and the SensatUrban frame reader)."""
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


def a2d2_sample_reader(dataset, cfg) -> Callable[[int], dict]:
    """reader(index) → numpy sample dict of an `A2D2_PV` item for the V2
    view's pixel-index branch: points [N, 4], labels [N], valid [N], each
    point's stored pixel rows/cols [N] int32 (zeros past the scan), the
    undistorted image on the canvas, img_h, img_w, index. The image is
    divided by 255 before `pad_image` divides it again, as pmf_tpu's reader
    does (ROADMAP C7)."""

    def read(index: int) -> dict:
        pcd, sem, _ = dataset.loadDataByIndex(index)
        rows, cols = dataset.pixel_indices(index)
        points, labels, valid = pad_points(pcd, sem, cfg.n_points)
        rp = np.zeros((cfg.n_points,), np.int32)
        cp = np.zeros((cfg.n_points,), np.int32)
        m = min(len(rows), cfg.n_points)
        rp[:m] = rows[:m]
        cp[:m] = cols[:m]
        img = dataset.loadImage(index).astype(np.float32) / 255.0
        image, img_h, img_w = pad_image(img, cfg.canvas_h, cfg.canvas_w)
        return {
            "points": points, "labels": labels, "valid": valid, "rows": rp, "cols": cp,
            "image": image, "img_h": img_h, "img_w": img_w, "index": np.int32(index),
        }

    return read


def sensat_sample_reader(dataset, cfg, frame_weights=None, train: bool = True,
                         rng: np.random.RandomState | None = None) -> Callable[[int], dict]:
    """reader(index) → numpy sample dict of a `SensatUrban` frame:
    feature_map [8, h, w], label_map [h, w] (-1 empty), index. In train mode
    the index goes through `frame_weights` (`sensat_frame_weights`), and a
    random (2 img_h, 2 img_w) window is cut from the frame (labels -1 past
    its edge), its corner drawn from `rng`: `RandomState(s)` draws what
    pmf_tpu's reader draws after `np.random.seed(s)`. At eval the frames
    are taken whole (tiled by `SensatUrban(use_crop=True)`)."""
    if train and rng is None:
        raise ValueError("the train reader draws its windows from a np.random.RandomState")

    def read(index: int) -> dict:
        if train and frame_weights is not None:
            index = frame_weights[index % len(frame_weights)]
        frame = dataset.readDataByIndex(index)
        fm = np.asarray(frame["feature_map"], np.float32)
        lm = np.asarray(frame["label_map"], np.float32)
        if train:
            wh, ww = cfg.img_h * 2, cfg.img_w * 2
            out_f = np.zeros((8, wh, ww), np.float32)
            out_l = np.full((wh, ww), -1.0, np.float32)
            H, W = lm.shape
            top = rng.randint(0, max(H - wh, 0) + 1)
            left = rng.randint(0, max(W - ww, 0) + 1)
            h, w = min(wh, H - top), min(ww, W - left)
            out_f[:, :h, :w] = fm[:, top:top + h, left:left + w]
            out_l[:h, :w] = lm[top:top + h, left:left + w]
            fm, lm = out_f, out_l
        return {"feature_map": fm, "label_map": lm, "index": np.int32(index)}

    return read
