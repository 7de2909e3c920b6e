"""Host-side scan readers and the batching loader (counterpart of
`pmf_tpu/data/loader.py`): `kitti_sample_reader` (the native reader of
`data/native.py`, or numpy + PIL), the nuScenes readers,
`range_sample_reader`, the A2D2 reader, the SensatUrban frame reader, and
`HostLoader`, which stacks a reader's samples into batches in a thread
pool."""
from __future__ import annotations

import concurrent.futures as cf
from typing import Callable, Iterator

import numpy as np

from . import native
from .perspective_pipeline import PVConfig, pad_image, pad_points

MAX_CONSECUTIVE_IMG_FAILURES = 3


def kitti_sample_reader(dataset, cfg: PVConfig,
                        use_native: bool | None = None) -> Callable[[int], dict]:
    """reader(index) → numpy sample dict for the perspective-view pipeline:
    points [N, 4], labels [N] (train ids), valid [N], proj_matrix [3, 4],
    image [Hc, Wc, 3] in [0, 1], img_h, img_w, index.

    With the native library (`use_native` None: when it loads and the
    dataset has labels) scan, labels and image come from one
    `native.read_scan_full` call; an image it cannot decode is read by PIL
    instead, and after 3 such failures in a row the reader keeps the native
    scan read and decodes every image with PIL. Without it, numpy and PIL.
    Both give the same arrays. `reader.native` says which path it takes."""
    if use_native is None:
        use_native = native.available() and getattr(dataset, "has_label", True)
    state = {"native_img": use_native and native.image_available(), "img_failures": 0}

    def sample(points, labels, valid, image, img_h, img_w, index):
        seq, _ = dataset.parsePathInfoByIndex(index)
        return {
            "points": points, "labels": labels, "valid": valid,
            "proj_matrix": dataset.projection_matrix(seq).astype(np.float32),
            "image": image, "img_h": img_h, "img_w": img_w,
            "index": np.int32(index),
        }

    def read(index: int) -> dict:
        if state["native_img"]:
            try:
                points, labels, valid, image, img_h, img_w, _ = native.read_scan_full(
                    dataset.pointcloud_files[index], dataset.label_files[index],
                    dataset.image_files[index], dataset.class_map_lut, cfg.n_points,
                    cfg.canvas_h, cfg.canvas_w)
                state["img_failures"] = 0
                return sample(points, labels, valid, image, img_h, img_w, index)
            except IOError:
                state["img_failures"] += 1
                if state["img_failures"] >= MAX_CONSECUTIVE_IMG_FAILURES:
                    state["native_img"] = False
        if use_native:
            points, labels, valid, _ = native.read_scan(
                dataset.pointcloud_files[index], dataset.label_files[index],
                dataset.class_map_lut, cfg.n_points)
        else:
            pcd, sem, _ = dataset.loadDataByIndex(index)
            points, labels, valid = pad_points(pcd, dataset.labelMapping(sem), cfg.n_points)
        image, img_h, img_w = pad_image(dataset.loadImage(index), cfg.canvas_h, cfg.canvas_w)
        return sample(points, labels, valid, image, img_h, img_w, index)

    read.native = bool(use_native)
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


class HostLoader:
    """Batches of `reader`'s samples, read by `num_workers` threads with
    `prefetch` batches in flight (pmf_tpu's HostLoader).

    Each process of a group of `process_count` reads the indices
    idx[process_index::process_count] of the epoch's order (shuffled with
    seed + epoch when `shuffle`; `set_epoch`), in batches of `batch_size`:
    the DistributedSampler layout that pmf_tpu's loader describes. With
    `batch_size` per device, the processes' b-th batches together are the
    same set of samples as one process's b-th batch of batch_size ·
    process_count (positions P·b·bs … P·(b+1)·bs − 1 of the order); only
    the rows' order differs. pmf_tpu's trainer builds its loader with the
    global batch over the process's shard instead (ROADMAP C8).

    With drop_last a short last batch is dropped; without it, it is padded
    with its last sample, and `batch_valid` [B] marks the real ones."""

    def __init__(self, reader: Callable[[int], dict], n_samples: int, batch_size: int,
                 shuffle: bool = False, drop_last: bool = True, seed: int = 0,
                 num_workers: int = 8, prefetch: int = 4, process_index: int = 0,
                 process_count: int = 1):
        self.reader = reader
        self.n_samples = n_samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """The epoch whose shuffle the next iteration takes."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(self.n_samples)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx[self.process_index::self.process_count]

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        n_batches = len(self)
        bs = self.batch_size
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            submit = lambda b: [pool.submit(self.reader, int(i)) for i in idx[b * bs:(b + 1) * bs]]
            futures = [submit(b) for b in range(min(self.prefetch, n_batches))]
            for b in range(n_batches):
                if len(futures) < n_batches:
                    futures.append(submit(len(futures)))
                samples = [f.result() for f in futures[b]]
                futures[b] = None
                n_real = len(samples)
                samples += [samples[-1]] * (bs - n_real)
                batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
                batch["batch_valid"] = np.arange(bs) < n_real
                yield batch
