"""Cut SemanticKITTI down to the camera's field of view (counterpart of
`pmf_tpu/tools/create_fov_dataset.py`): for every scan keep the points in
front of the camera (x > 0.5 m) that project inside the image, and write
them, their labels, the image and the sequence's calib.txt into a
`semantic-kitti-fov` tree. Host-side numpy; reads through the port's own
`data/semantic_kitti.py`.

Usage:
  python -m pmf_tpu_torch.tools.create_fov_dataset --src <sequences dir>
      --dst <fov sequences dir> [--sequences 0 1 2 ...] [--no-labels]
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from ..data import SemanticKitti


def fov_keep_mask(points: np.ndarray, proj_matrix: np.ndarray, img_h: int,
                  img_w: int) -> np.ndarray:
    """The points [N, 4] with x > 0.5 whose projection (u, v) lies strictly
    inside the img_w x img_h image."""
    keep = points[:, 0] > 0.5
    hom = np.concatenate([points[:, :3], np.ones((len(points), 1), np.float32)], axis=1)
    uvw = hom @ proj_matrix.T
    w = np.where(np.abs(uvw[:, 2]) > 1e-9, uvw[:, 2], 1e-9)
    u, v = uvw[:, 0] / w, uvw[:, 1] / w
    return keep & (u > 0) & (u < img_w) & (v > 0) & (v < img_h)


def create_fov_dataset(src: str, dst: str, sequences=None, has_label: bool = True) -> int:
    """Write the FOV tree of `sequences` (default 00-10) of `src` under
    `dst`; returns the count of scans written."""
    from PIL import Image

    sequences = sequences if sequences is not None else list(range(11))
    n_total = 0
    for seq in sequences:
        ds = SemanticKitti(src, [seq], has_label=has_label)
        seq_s = f"{int(seq):02d}"
        out = os.path.join(dst, seq_s)
        for sub in ("velodyne", "image_2") + (("labels",) if has_label else ()):
            os.makedirs(os.path.join(out, sub), exist_ok=True)
        shutil.copy2(os.path.join(src, seq_s, "calib.txt"), os.path.join(out, "calib.txt"))
        P = ds.projection_matrix(seq_s)
        for i in range(len(ds)):
            pcd, sem, inst = ds.loadDataByIndex(i)
            with Image.open(ds.image_files[i]) as img:
                keep = fov_keep_mask(pcd, P, img.height, img.width)
            _, frame = ds.parsePathInfoByIndex(i)
            pcd[keep].astype(np.float32).tofile(os.path.join(out, "velodyne", f"{frame}.bin"))
            if has_label:
                packed = sem[keep].astype(np.int32) | (inst[keep].astype(np.int32) << 16)
                packed.tofile(os.path.join(out, "labels", f"{frame}.label"))
            shutil.copy2(ds.image_files[i], os.path.join(out, "image_2", f"{frame}.png"))
            n_total += 1
    return n_total


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", required=True)
    parser.add_argument("--dst", required=True)
    parser.add_argument("--sequences", type=int, nargs="*", default=None)
    parser.add_argument("--no-labels", action="store_true")
    args = parser.parse_args(argv)
    n = create_fov_dataset(args.src, args.dst, args.sequences, has_label=not args.no_labels)
    print(f"wrote {n} FOV scans to {args.dst}")
    return n


if __name__ == "__main__":
    main()
