"""A2D2 dataset adapter (counterpart of `pmf_tpu/data/a2d2.py`, a copy of
its host-side numpy code; the port imports nothing of pmf_tpu).

  * (lidar .npz, camera .png, label .png) file triples found by a glob, with
    the fixed unused/zero-size index excludes and the 22407/25181 split
    boundaries;
  * labels decoded from the semantic PNG's colours through the class-index
    JSON, as a 24-bit colour table;
  * each point's (row, col) pixel stored in the lidar .npz, so no
    projection happens: `pixel_indices` rounds them as (row + 0.5) → int32;
  * the camera image undistorted in numpy (radial-tangential for the
    Telecam lens, equidistant for the Fisheye) with a bilinear remap, in
    float64;
  * the 38 classes (+ ignore) and their pixel counts.

PIL is imported when an image is read.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

MAPPED_CLASS_NAME = {
    0: "ignore", 1: "car", 2: "bicycle", 3: "pedestrian", 4: "truck",
    5: "small_vehicles", 6: "traffic_signal", 7: "traffic_sign",
    8: "utility_vehicle", 9: "sidebars", 10: "speed_bumper",
    11: "curbstone", 12: "solid_line", 13: "irrelevant_signs",
    14: "road_blocks", 15: "tractor", 16: "non-drivable_street",
    17: "zebra_crossing", 18: "obstacles/trash", 19: "poles",
    20: "RD_restricted_area", 21: "animals", 22: "grid_structure",
    23: "signal_corpus", 24: "drivable_cobblestone",
    25: "electronic_traffic", 26: "slow_drive_area", 27: "nature_object",
    28: "parking_area", 29: "sidewalk", 30: "ego_car",
    31: "painted_driv._instr.", 32: "traffic_guide_obj.", 33: "dashed_line",
    34: "RD_normal_street", 35: "sky", 36: "buildings", 37: "blurred_area",
    38: "rain_dirt",
}

CLS_FREQ = [0, 16638586, 816746, 885671, 4205546, 166147, 209321,
            1277733, 544559, 32109, 3, 5093660, 1705323, 2194196,
            1044710, 5349, 3029528, 161433, 1668462, 2647306, 956223,
            4182, 4622371, 439294, 6069454, 9990, 1138946, 78342740,
            2156414, 21557480, 8634634, 660671, 1394186, 1719920, 85871754,
            2745726, 63773755, 9046, 45]

UNUSED_INDEX = [942, 12124, 12125, 12126, 12127, 12128, 12129, 12130, 12131,
                12132, 12133, 12134, 20720, 20721, 20722, 20723, 20724,
                20725, 20726, 20727, 21299, 21300, 21301, 21302, 27427, 27428]

ZERO_SIZE_INDEX = [12907, 12908, 12909, 12910, 12911, 12912, 13649, 13650,
                   13651, 13652]

TRAIN_END, VALID_END = 22407, 25181   # the split boundaries in the sorted file list


def undistort_image(image: np.ndarray, K_dist: np.ndarray, dist: np.ndarray,
                    K_new: np.ndarray, lens: str) -> np.ndarray:
    """The undistorted image: each output pixel's distorted source pixel
    (the inverse map), bilinearly sampled. `lens`: 'Telecam' (radial-
    tangential k1, k2, p1, p2[, k3]) or 'Fisheye' (equidistant k1..k4)."""
    H, W = image.shape[:2]
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    x = (u - K_new[0, 2]) / K_new[0, 0]
    y = (v - K_new[1, 2]) / K_new[1, 1]
    d = np.zeros(8)
    dd = np.asarray(dist, dtype=np.float64).ravel()
    d[: len(dd)] = dd

    if lens == "Fisheye":
        r = np.sqrt(x * x + y * y)
        theta = np.arctan(r)
        theta_d = theta * (1 + d[0] * theta ** 2 + d[1] * theta ** 4 +
                           d[2] * theta ** 6 + d[3] * theta ** 8)
        scale = np.where(r > 1e-8, theta_d / np.maximum(r, 1e-8), 1.0)
        xd = x * scale
        yd = y * scale
    else:  # Telecam, and the default: radial-tangential
        k1, k2, p1, p2, k3 = d[0], d[1], d[2], d[3], d[4]
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y

    src_u = K_dist[0, 0] * xd + K_dist[0, 2]
    src_v = K_dist[1, 1] * yd + K_dist[1, 2]
    return _bilinear_remap(image, src_v, src_u)


def _bilinear_remap(image: np.ndarray, rows: np.ndarray,
                    cols: np.ndarray) -> np.ndarray:
    H, W = image.shape[:2]
    r0 = np.floor(rows).astype(np.int64)
    c0 = np.floor(cols).astype(np.int64)
    fr = rows - r0
    fc = cols - c0
    valid = (rows >= 0) & (rows <= H - 1) & (cols >= 0) & (cols <= W - 1)
    r0c = np.clip(r0, 0, H - 1)
    c0c = np.clip(c0, 0, W - 1)
    r1c = np.clip(r0 + 1, 0, H - 1)
    c1c = np.clip(c0 + 1, 0, W - 1)
    img = image.astype(np.float64)
    out = (img[r0c, c0c] * ((1 - fr) * (1 - fc))[..., None] +
           img[r0c, c1c] * ((1 - fr) * fc)[..., None] +
           img[r1c, c0c] * (fr * (1 - fc))[..., None] +
           img[r1c, c1c] * (fr * fc)[..., None])
    out = np.where(valid[..., None], out, 0.0)
    return np.clip(np.round(out), 0, 255).astype(image.dtype)


class A2D2_PV:
    """The A2D2 camera-lidar semantic set, one item per lidar .npz of a
    front-centre camera frame, with its stored point → pixel indices."""

    def __init__(self, root: str, camsLidars_path: str, classIndex_path: str,
                 split: str = "train", has_label: bool = True,
                 apply_excludes: bool = True):
        self.root = root
        self.split = split
        self.has_label = has_label
        self.mapped_class_name = MAPPED_CLASS_NAME
        self.mapped_cls_name = MAPPED_CLASS_NAME
        self.cls_freq = np.asarray(CLS_FREQ, np.float64)
        self.cls_freq = self.cls_freq / self.cls_freq.sum()
        self.cls_freq[0] = 0

        with open(camsLidars_path) as f:
            self.cams_lidars = json.load(f)
        with open(classIndex_path) as f:
            class_index = json.load(f)
        # '#rrggbb' → class id, as a sorted table of 24-bit colours
        self._color_keys = np.array(
            sorted(int(k.lstrip("#"), 16) for k in class_index), np.int64)
        key_to_cls = {int(k.lstrip("#"), 16): v for k, v in class_index.items()}
        self._color_vals = np.array(
            [key_to_cls[k] for k in self._color_keys], np.int32)

        files = np.asarray(sorted(glob.glob(os.path.join(root, "*/lidar/*/*.npz"))))
        if apply_excludes and len(files) > max(UNUSED_INDEX + ZERO_SIZE_INDEX):
            files = np.delete(files, UNUSED_INDEX)
            files = np.delete(files, ZERO_SIZE_INDEX)
        if split == "train":
            files = files[:TRAIN_END]
        elif split == "valid":
            files = files[TRAIN_END:VALID_END]
        elif split == "test":
            files = files[VALID_END:]
        elif split != "all":
            raise ValueError(f"invalid split: {split}")
        self.lidar_files = list(files)
        self.camera_files = [self._sibling(f, "camera", "png") for f in self.lidar_files]
        self.label_files = [self._sibling(f, "label", "png") for f in self.lidar_files]

    @staticmethod
    def _sibling(lidar_file: str, kind: str, ext: str) -> str:
        parts = lidar_file.split(os.sep)
        parts[-3] = parts[-3].replace("lidar", kind)
        parts[-1] = parts[-1].replace("lidar", kind).rsplit(".", 1)[0] + "." + ext
        return os.sep.join(parts)

    @staticmethod
    def get_save_file_name(file_name: str) -> str:
        name = file_name.split(os.sep)[-1].replace("label", "pred")
        return name.rsplit(".", 1)[0] + ".label"

    def __len__(self):
        return len(self.lidar_files)

    def parsePathInfoByIndex(self, index: int):
        return index, ""

    def _decode_labels(self, sem_image: np.ndarray, rows, cols) -> np.ndarray:
        rgb24 = (sem_image[rows, cols, 0].astype(np.int64) << 16) | \
                (sem_image[rows, cols, 1].astype(np.int64) << 8) | \
                sem_image[rows, cols, 2].astype(np.int64)
        pos = np.searchsorted(self._color_keys, rgb24)
        pos = np.clip(pos, 0, len(self._color_keys) - 1)
        hit = self._color_keys[pos] == rgb24
        return np.where(hit, self._color_vals[pos], 0).astype(np.int32)

    def loadDataByIndex(self, index: int):
        """(points [N, 4] x/y/z/reflectance float32, labels [N] int32 (0
        without labels), instances [N] zeros)."""
        d = np.load(self.lidar_files[index])
        pcd = np.concatenate(
            [d["points"], d["reflectance"][:, None]], axis=1).astype(np.float32)
        if self.has_label:
            from PIL import Image

            sem_img = np.asarray(Image.open(self.label_files[index]))
            rows = (d["row"] + 0.5).astype(np.int32)
            cols = (d["col"] + 0.5).astype(np.int32)
            sem = self._decode_labels(sem_img, rows, cols)
        else:
            sem = np.zeros(len(pcd), np.int32)
        return pcd, sem, np.zeros(len(pcd), np.int32)

    def loadLabelByIndex(self, index: int):
        _, sem, inst = self.loadDataByIndex(index)
        return sem, inst

    def labelMapping(self, label: np.ndarray) -> np.ndarray:
        return label  # A2D2's labels are train ids already

    def loadImage(self, index: int) -> np.ndarray:
        """The camera image, undistorted, as stored (uint8)."""
        from PIL import Image

        path = self.camera_files[index]
        image = np.asarray(Image.open(path))
        cam = os.path.basename(path).split(".")[0].split("_")[2]
        return self.undistort(image, cam)

    def undistort(self, image: np.ndarray, cam_name: str) -> np.ndarray:
        if cam_name in ("frontleft", "frontcenter", "frontright",
                        "sideleft", "sideright", "rearcenter"):
            cam = (cam_name[:5] + "_" + cam_name[5:]) if cam_name[0] == "f" \
                else (cam_name[:4] + "_" + cam_name[4:])
            cfg = self.cams_lidars["cameras"][cam]
            return undistort_image(
                image, np.asarray(cfg["CamMatrixOriginal"]),
                np.asarray(cfg["Distortion"]), np.asarray(cfg["CamMatrix"]),
                cfg["Lens"])
        return image

    def pixel_indices(self, index: int):
        """Each point's stored (row, col), rounded: (rows, cols) [N] int32."""
        d = np.load(self.lidar_files[index])
        rows = (d["row"] + 0.5).astype(np.int32)
        cols = (d["col"] + 0.5).astype(np.int32)
        return rows, cols
