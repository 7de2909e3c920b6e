"""SemanticKITTI dataset adapter (counterpart of
`pmf_tpu/data/semantic_kitti.py`): file discovery per sequence, .bin/.label
decoding (semantic = low 16 bits), the calib P2·Tr projection matrix, and
the learning-map LUTs from the class-map YAML. Host-side numpy only.
"""
from __future__ import annotations

import os

import numpy as np

from ..ops.projection import read_kitti_calib

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs", "semantic-kitti.yaml")


def _build_lut(mapping: dict, dtype=np.int32) -> np.ndarray:
    """Dense LUT from a sparse {id: value} map, with 100 entries of headroom."""
    lut = np.zeros((max(mapping.keys()) + 100,), dtype=dtype)
    for k, v in mapping.items():
        lut[k] = v
    return lut


def _listdir(path: str, suffix: str) -> list[str]:
    return sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(suffix))


class SemanticKitti:
    """File-level adapter with the reference's duck-typed API."""

    def __init__(self, root: str, sequences, config_path: str | None = None,
                 has_image: bool = True, has_label: bool = True):
        import yaml

        with open(config_path or DEFAULT_CONFIG) as f:
            cfg = yaml.safe_load(f)
        if not os.path.isdir(root):
            raise ValueError(f"dataset not found: {root}")
        self.data_config = cfg
        self.root = root
        self.has_image = has_image
        self.has_label = has_label
        self.pointcloud_files: list[str] = []
        self.label_files: list[str] = []
        self.image_files: list[str] = []
        self.proj_matrix: dict[str, np.ndarray] = {}
        for seq in sorted(int(s) for s in sequences):
            seq_dir = os.path.join(root, f"{seq:02d}")
            scans = _listdir(os.path.join(seq_dir, "velodyne"), ".bin")
            self.pointcloud_files.extend(scans)
            if has_label:
                labels = _listdir(os.path.join(seq_dir, "labels"), ".label")
                if len(labels) != len(scans):
                    raise ValueError(f"seq {seq:02d}: {len(labels)} labels vs "
                                     f"{len(scans)} scans")
                self.label_files.extend(labels)
            if has_image:
                images = _listdir(os.path.join(seq_dir, "image_2"), ".png")
                if len(images) != len(scans):
                    raise ValueError(f"seq {seq:02d}: {len(images)} images vs "
                                     f"{len(scans)} scans")
                self.image_files.extend(images)
                self.proj_matrix[f"{seq:02d}"] = read_kitti_calib(
                    os.path.join(seq_dir, "calib.txt"))
        self.class_map_lut = _build_lut(cfg["learning_map"])
        self.class_map_lut_inv = _build_lut(cfg["learning_map_inv"])
        self.mapped_cls_name = cfg.get("mapped_class_name", {})
        self.learning_ignore = cfg.get("learning_ignore", {})

    @staticmethod
    def readPCD(path: str) -> np.ndarray:
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)

    @staticmethod
    def readLabel(path: str):
        label = np.fromfile(path, dtype=np.int32)
        return label & 0xFFFF, label >> 16

    def __len__(self):
        return len(self.pointcloud_files)

    def parsePathInfoByIndex(self, index: int):
        parts = os.path.normpath(self.pointcloud_files[index]).split(os.sep)
        return parts[-3], os.path.splitext(parts[-1])[0]

    def loadDataByIndex(self, index: int):
        pcd = self.readPCD(self.pointcloud_files[index])
        if self.has_label:
            sem, inst = self.readLabel(self.label_files[index])
        else:
            sem = inst = np.zeros(pcd.shape[0], dtype=np.int32)
        return pcd, sem, inst

    def loadImage(self, index: int) -> np.ndarray:
        from PIL import Image

        img = Image.open(self.image_files[index])
        if img.mode != "RGB":
            img = img.convert("RGB")
        return np.asarray(img)

    def labelMapping(self, label: np.ndarray) -> np.ndarray:
        return self.class_map_lut[label]

    def labelInvMapping(self, label: np.ndarray) -> np.ndarray:
        return self.class_map_lut_inv[label]

    def projection_matrix(self, seq: str) -> np.ndarray:
        return self.proj_matrix[seq]
