"""Merge camera-view predictions with 360° predictions into a nuScenes
lidarseg submission (counterpart of
`pmf_tpu/tools/merge_nuscenes_submission.py`).

  * the main predictions (PMF or EPMF, which label only the points a
    camera sees) win wherever they are > 0;
  * their holes are filled from the sub predictions (SalsaNext, all around);
  * the zeros left become class 11 (driveable_surface);
  * `{split}/submission.json` carries the meta block.

Usage:
  python -m pmf_tpu_torch.tools.merge_nuscenes_submission \
      --main-dir preds_pmf --sub-dir preds_salsanext --out-dir merged \
      [--split test] [--validate-dataroot ROOT --version v1.0-test]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def merge_predictions(main_dir: str, sub_dir: str | None, out_dir: str, split: str = "test",
                      fallback_class: int = 11) -> int:
    """Merge every `lidarseg/{split}/*_lidarseg.bin` of `main_dir` with the
    file of the same name under `sub_dir` (where there is one) into
    `out_dir`, and write the meta block; returns the number of files."""
    src = os.path.join(main_dir, "lidarseg", split)
    sub = os.path.join(sub_dir, "lidarseg", split) if sub_dir else None
    dst = os.path.join(out_dir, "lidarseg", split)
    os.makedirs(dst, exist_ok=True)

    files = sorted(f for f in os.listdir(src) if f.endswith("_lidarseg.bin"))
    for fn in files:
        pred = np.fromfile(os.path.join(src, fn), dtype=np.uint8)
        if sub and os.path.isfile(os.path.join(sub, fn)):
            sub_pred = np.fromfile(os.path.join(sub, fn), dtype=np.uint8)
            pred = np.where(pred == 0, sub_pred, pred)
        pred = np.where(pred == 0, np.uint8(fallback_class), pred)
        pred.tofile(os.path.join(dst, fn))

    meta_dir = os.path.join(out_dir, split)
    os.makedirs(meta_dir, exist_ok=True)
    with open(os.path.join(meta_dir, "submission.json"), "w") as f:
        json.dump({"meta": {
            "use_camera": True, "use_lidar": True, "use_radar": False,
            "use_map": False, "use_external": False}}, f, indent=2)
    return len(files)


def validate_submission(out_dir: str, dataroot: str, version: str, split: str = "test") -> bool:
    """Check that every keyframe of the DB has a file with one uint8 label in
    1..16 per lidar point; raises on the first that does not. The nuScenes
    devkit's own check runs instead where the devkit is installed."""
    try:
        from nuscenes.eval.lidarseg.validate_submission import validate_submission as devkit
    except ImportError:
        devkit = None
    if devkit is not None:
        devkit(result_path=out_dir, eval_set=split, dataroot=dataroot, version=version,
               verbose=False)
        return True

    from ..data.nuscenes import NuScenesLite

    nusc = NuScenesLite(dataroot, version)
    dst = os.path.join(out_dir, "lidarseg", split)
    for sample in nusc.sample:
        token = sample["data"]["LIDAR_TOP"]
        sd = nusc.get("sample_data", token)
        n_points = os.path.getsize(os.path.join(dataroot, sd["filename"])) // (5 * 4)
        path = os.path.join(dst, f"{token}_lidarseg.bin")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"missing prediction: {path}")
        pred = np.fromfile(path, dtype=np.uint8)
        if pred.shape[0] != n_points:
            raise ValueError(f"{path}: {pred.shape[0]} labels vs {n_points} points")
        if pred.min() < 1 or pred.max() > 16:
            raise ValueError(f"{path}: labels outside [1, 16]")
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--main-dir", required=True)
    parser.add_argument("--sub-dir", default=None)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--split", default="test")
    parser.add_argument("--validate-dataroot", default=None)
    parser.add_argument("--version", default="v1.0-test")
    args = parser.parse_args(argv)

    n = merge_predictions(args.main_dir, args.sub_dir, args.out_dir, args.split)
    print(f"merged {n} frames → {args.out_dir}")
    if args.validate_dataroot:
        validate_submission(args.out_dir, args.validate_dataroot, args.version, args.split)
        print("submission valid")
    return n


if __name__ == "__main__":
    main()
