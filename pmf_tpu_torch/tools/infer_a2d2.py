"""A2D2 evaluation of EPMFNet or PMFNet (counterpart of
`pmf_tpu/tools/infer_a2d2.py`).

Per scan, on the points' stored pixels (no projection):
  * a proj_h x proj_w window centred on the span of the scan's rows and
    cols (its corner clipped at 0), the points shifted into it and the
    undistorted image cut to it;
  * the per-scan z-buffer (K1) and a gather into the canvas, normalized by
    `pcd_mean`/`pcd_stds`, with the window's RGB;
  * the forward and the argmax; each point takes the class at its clipped
    pixel, 0 where it lies outside the window;
  * the point IoU (class 0 ignored) over the points in the window, and with
    --save-preds an int32 `.label` file a scan, named after its label
    image.

Usage:
  python -m pmf_tpu_torch.tools.infer_a2d2 <config.yaml> --weights W
      [--save-preds DIR] [--split valid|train|test|all] [--max-scans N]
      [--device cpu|cuda]

W is a `.pth` torch state_dict (a trainer's snapshot) or an `.npz` of the
flat flax tree (`scripts/export_flax_npz.py`). The run is on the card
unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Callable

import numpy as np
import torch

from ..config import Options, load_options
from ..data import A2D2_PV, V2Config, pad_points, point_depth
from ..data.perspective_pipeline import fill_scan
from ..metrics import IOUEval
from ..models import build_model, load_weights
from ..ops import argmax_last
from ..utils import disable_tf32, resolve_device
from ..utils.tables import per_class_report

log = logging.getLogger(__name__)


def window_config(opts: Options) -> V2Config:
    """The window of pmf_tpu's A2D2 CLI (its `PVconfig` group, else
    `sensor`): proj_h x proj_w (1216 x 1920 unless set), n_points (32768),
    and `pcd_mean`/`pcd_stds` (else `img_mean`/`img_stds`) to normalize."""
    group = opts.group("PVconfig") or opts.group("sensor")
    return V2Config(proj_h=int(group.get("proj_h", 1216)), proj_w=int(group.get("proj_w", 1920)),
                    n_points=int(group.get("n_points", 32768)),
                    img_mean=tuple(group.get("pcd_mean", group.get(
                        "img_mean", (12.12, 10.88, 0.23, -1.04, 0.21)))),
                    img_stds=tuple(group.get("pcd_stds", group.get(
                        "img_stds", (12.32, 11.47, 6.91, 0.86, 0.16)))))


def a2d2_scan_reader(dataset: A2D2_PV) -> Callable[[int], dict]:
    """reader(index) → one scan as stored: points [N, 4], labels [N], its
    pixels rows/cols [N] int32, the undistorted image [H, W, 3] in [0, 1]."""

    def read(index: int) -> dict:
        pcd, sem, _ = dataset.loadDataByIndex(index)
        rows, cols = dataset.pixel_indices(index)
        return {"points": pcd, "labels": sem, "rows": rows, "cols": cols,
                "image": dataset.loadImage(index).astype(np.float32) / 255.0}

    return read


class A2D2Inference:
    """The eval loop over `n_scans` scans from `reader(i)` (the dict of
    `a2d2_scan_reader`). `dataset` (an A2D2_PV) names the `save_preds` files
    and labels the report's classes."""

    def __init__(self, opts: Options, model: torch.nn.Module, reader: Callable[[int], dict],
                 n_scans: int, device: torch.device, save_preds: str | None = None,
                 dataset: A2D2_PV | None = None):
        if save_preds and dataset is None:
            raise ValueError("save_preds needs the dataset for file names")
        self.opts, self.model, self.reader = opts, model, reader
        self.n_scans, self.device = n_scans, device
        self.save_preds, self.dataset = save_preds, dataset
        self.cfg = window_config(opts)
        self.point_eval = IOUEval(opts.nclasses, ignore=[0])

    @classmethod
    def from_files(cls, opts: Options, weights: str, device: torch.device,
                   save_preds: str | None = None, split: str = "valid"):
        """The CLI's loop: the `split` of the A2D2 set under opts.data_root
        (`cams_lidars_json`, `class_index_json`, `apply_excludes`) and the
        model weights at `weights`."""
        dataset = A2D2_PV(
            opts.data_root,
            opts.config.get("cams_lidars_json", os.path.join(opts.data_root, "cams_lidars.json")),
            opts.config.get("class_index_json", os.path.join(opts.data_root, "class_index.json")),
            split=split, apply_excludes=bool(opts.config.get("apply_excludes", True)))
        model = build_model(opts).to(device).eval()
        load_weights(model, weights)
        return cls(opts, model, a2d2_scan_reader(dataset), len(dataset), device, save_preds,
                   dataset)

    def window(self, s: dict):
        """One scan's view on the device: each point's (rows, cols) in the
        window, whether it lies there (keep), its depth, its values
        depth/x/y/z/i/label [N_points, 6], and the window's RGB."""
        cfg, dev = self.cfg, self.device
        out_h, out_w = cfg.proj_h, cfg.proj_w
        rows, cols = s["rows"], s["cols"]
        r0 = max((rows.min() + rows.max()) // 2 - out_h // 2, 0)
        c0 = max((cols.min() + cols.max()) // 2 - out_w // 2, 0)
        img = s["image"]
        image = np.zeros((out_h, out_w, 3), np.float32)
        h, w = min(out_h, img.shape[0] - r0), min(out_w, img.shape[1] - c0)
        if h > 0 and w > 0:
            image[:h, :w] = img[r0:r0 + h, c0:c0 + w]
        points, labels, valid = pad_points(s["points"], s["labels"], cfg.n_points)
        m = min(len(rows), cfg.n_points)
        rw = np.zeros((cfg.n_points,), np.int32)
        cw = np.zeros((cfg.n_points,), np.int32)
        rw[:m], cw[:m] = rows[:m] - r0, cols[:m] - c0

        t = lambda a: torch.as_tensor(a, device=dev)
        points, rw, cw = t(points), t(rw), t(cw)
        depth = point_depth(points)
        keep = t(valid) & (rw >= 0) & (rw < out_h) & (cw >= 0) & (cw < out_w)
        vals = torch.cat([depth[:, None], points[:, :4], t(labels).float()[:, None]], dim=-1)
        return rw, cw, keep, depth, vals, t(image)

    def scan(self, s: dict) -> tuple[np.ndarray, np.ndarray]:
        """One scan's per-point classes and whether each point lies in the
        window ([N_points] each, numpy)."""
        out_h, out_w = self.cfg.proj_h, self.cfg.proj_w
        geometry = self.window(s)
        rw, cw, keep = geometry[:3]
        f = fill_scan(geometry, out_h, out_w, self.cfg)[0]
        probs = self.model(f[None, ..., :5], f[None, ..., 5:8])[0][0]
        pred = argmax_last(probs)[rw.clamp(0, out_h - 1).long(), cw.clamp(0, out_w - 1).long()]
        return torch.where(keep, pred, 0).cpu().numpy(), keep.cpu().numpy()

    @torch.inference_mode()
    def run(self, max_scans: int = -1) -> dict:
        n = self.n_scans if max_scans < 0 else min(max_scans, self.n_scans)
        t_total = 0.0
        for i in range(n):
            s = self.reader(i)
            t0 = time.perf_counter()
            pred, keep = self.scan(s)
            t_total += time.perf_counter() - t0
            n_pts = len(s["points"])
            self.point_eval.addBatch(pred[:n_pts], s["labels"], valid=keep[:n_pts])
            if self.save_preds:
                os.makedirs(self.save_preds, exist_ok=True)
                name = self.dataset.get_save_file_name(self.dataset.label_files[i])
                pred[:n_pts].astype(np.int32).tofile(os.path.join(self.save_preds, name))
            if i % 200 == 0 or i == n - 1:
                log.info(f"[{i + 1}/{n}] mIoU {self.point_eval.getIoU()[0]:.4f}")
        miou, iou = self.point_eval.getIoU()
        macc, acc = self.point_eval.getAcc()
        mrec, rec = self.point_eval.getRecall()
        names = self.dataset.mapped_class_name if self.dataset else \
            {i: str(i) for i in range(self.opts.nclasses)}
        log.info("\n" + per_class_report(names, iou, acc, rec, self.point_eval.include)
                 + f"\nmIoU {miou * 100:.2f}")
        out = {"mIoU": float(miou), "mAcc": float(macc), "mRecall": float(mrec),
               "ms_per_scan": t_total / max(n, 1) * 1000}
        log.info(f"inference: {out['ms_per_scan']:.1f} ms/scan (window, forward, labels) on "
                 f"{self.device}")
        return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("config")
    parser.add_argument("--weights", required=True,
                        help=".pth torch state_dict or .npz flat flax tree")
    parser.add_argument("--save-preds", default=None)
    parser.add_argument("--split", default="valid")
    parser.add_argument("--max-scans", type=int, default=-1)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    disable_tf32()
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    inf = A2D2Inference.from_files(load_options(args.config), args.weights,
                                   resolve_device(args.device), save_preds=args.save_preds,
                                   split=args.split)
    out = inf.run(args.max_scans)
    print(out)
    return out


if __name__ == "__main__":
    main()
