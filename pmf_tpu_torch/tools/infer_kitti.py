"""SemanticKITTI evaluation of PMFNet and EPMFNet (counterpart of
`pmf_tpu/tools/infer_kitti.py`).

Per-scan inference with the points' projection kept: 2D pixel and 3D point
evaluators, optional KNN lifting, KITTI submission `.label` files through
the inverse class LUT, and the per-class IoU/Acc/Recall + fwIoU report.

Usage:
  python -m pmf_tpu_torch.tools.infer_kitti <config.yaml> --weights W
      [--knn] [--save-preds DIR] [--max-scans N] [--device cpu|cuda]

W is a `.pth` torch state_dict with the reference's module names (a
trainer's snapshot, whose `mt_sigma` is left out) or an `.npz` of the flat
flax tree (see models/convert.py). EPMFNet (`net_type`) runs on the V2 view
of the config's `PVconfig` group. The run is on the card unless --device
cpu is given.
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
from ..data import (
    SemanticKitti, build_eval_sample_with_uproj, build_v2_eval_sample_with_uproj,
    kitti_sample_reader, point_depth, pv_config, view_config,  # noqa: F401 (pv_config: PMF's view)
)
from ..metrics import IOUEval
from ..models import build_model, load_weights
from ..ops import argmax_last, knn_postprocess
from ..utils import disable_tf32, resolve_device
from ..utils.tables import latex_row, matrix_report, per_class_report

log = logging.getLogger(__name__)


class Inference:
    """The eval loop over `n_scans` scans from `reader(i)`, a numpy sample
    dict as `data.kitti_sample_reader` returns. `dataset` (a SemanticKitti)
    is needed only to name and write `save_preds` files and to label the
    report's classes."""

    def __init__(self, opts: Options, model: torch.nn.Module, reader: Callable[[int], dict],
                 n_scans: int, device: torch.device, ignore=(0,),
                 use_knn: bool = False, save_preds: str | None = None,
                 dataset: SemanticKitti | None = None):
        if save_preds and dataset is None:
            raise ValueError("save_preds needs the dataset for file names and labels")
        self.opts, self.model, self.reader = opts, model, reader
        self.n_scans, self.device = n_scans, device
        self.use_knn, self.save_preds, self.dataset = use_knn, save_preds, dataset
        self.pv_cfg = view_config(opts)
        self.build = build_v2_eval_sample_with_uproj if opts.net_type == "EPMFNet" else \
            build_eval_sample_with_uproj
        knn = opts.group("post").get("KNN", {}).get("params", {})
        self.knn_params = {"knn": int(knn.get("knn", 5)),
                           "search": int(knn.get("search", 5)),
                           "sigma": float(knn.get("sigma", 1.0)),
                           "cutoff": float(knn.get("cutoff", 1.0))}
        self.pixel_eval = IOUEval(opts.nclasses, ignore=ignore)
        self.point_eval = IOUEval(opts.nclasses, ignore=ignore)

    @classmethod
    def from_files(cls, opts: Options, weights: str, device: torch.device,
                   use_knn: bool = False, save_preds: str | None = None):
        """The CLI's loop: SemanticKITTI sequence 08 under `opts.data_root`
        and the model weights at `weights`."""
        dataset = SemanticKitti(opts.data_root, [8])
        model = build_model(opts).to(device).eval()
        load_weights(model, weights)
        ignore = [cl for cl, ig in dataset.learning_ignore.items() if ig] or [0]
        return cls(opts, model, kitti_sample_reader(dataset, view_config(opts)),
                   len(dataset), device, ignore, use_knn, save_preds, dataset)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def run(self, max_scans: int = -1) -> dict:
        n = self.n_scans if max_scans < 0 else min(max_scans, self.n_scans)
        cfg = self.pv_cfg
        t_total = 0.0
        for i in range(n):
            s = self.reader(i)
            dev = lambda k: torch.as_tensor(s[k], device=self.device)
            points = dev("points")
            f, m, l2d, rows, cols, keep, _ = self.build(
                points, dev("labels"), dev("valid"), dev("proj_matrix"),
                dev("image"), int(s["img_h"]), int(s["img_w"]), cfg)
            self._sync()
            t0 = time.perf_counter()
            probs = self.model(f[None, ..., :5], f[None, ..., 5:8])[0][0]
            argmax = argmax_last(probs)
            if self.use_knn:
                # the depth plane for KNN: the projected depth channel denormalized
                proj_depth = (f[..., 0] * cfg.img_stds[0] + cfg.img_mean[0]) * m
                proj_range = torch.where(m, proj_depth, -1.0)
                point_pred = knn_postprocess(
                    proj_range, point_depth(points), argmax, cols, rows, valid=keep,
                    nclasses=self.opts.nclasses, **self.knn_params)
            else:
                point_pred = argmax[rows.clamp(0, cfg.proj_h - 1).long(),
                                    cols.clamp(0, cfg.proj_w - 1).long()]
                point_pred = torch.where(keep, point_pred, 0)
            point_pred = point_pred.cpu().numpy()
            t_total += time.perf_counter() - t0

            self.pixel_eval.addBatch(argmax, l2d, valid=l2d > 0)
            keep_np = keep.cpu().numpy() & s["valid"]
            self.point_eval.addBatch(point_pred[keep_np], s["labels"][keep_np])

            if self.save_preds:
                seq, frame = self.dataset.parsePathInfoByIndex(i)
                out_dir = os.path.join(self.save_preds, "sequences", seq, "predictions")
                os.makedirs(out_dir, exist_ok=True)
                raw = self.dataset.labelInvMapping(point_pred[:int(s["valid"].sum())])
                raw.astype(np.int32).tofile(os.path.join(out_dir, f"{frame}.label"))
            if i % 100 == 0 or i == n - 1:
                log.info(f"[{i + 1}/{n}] 3D mIoU {self.point_eval.getIoU()[0]:.4f} "
                         f"({t_total / (i + 1) * 1000:.1f} ms/scan)")
        return self.report(n, t_total)

    def report(self, n: int, t_total: float) -> dict:
        names = self.dataset.mapped_cls_name if self.dataset else \
            {i: str(i) for i in range(self.opts.nclasses)}
        out = {}
        for tag, ev in (("pixel", self.pixel_eval), ("point", self.point_eval)):
            miou, iou = ev.getIoU()
            macc, acc = ev.getAcc()
            mrec, rec = ev.getRecall()
            fwiou = ev.getFwIoU()
            out[tag] = {"mIoU": float(miou), "mAcc": float(macc),
                        "mRecall": float(mrec), "fwIoU": float(fwiou)}
            log.info(f"\n==== {tag} metrics ({n} scans) ====\n"
                     + per_class_report(names, iou, acc, rec, ev.include)
                     + f"\nmIoU {miou * 100:.2f}  mAcc {macc * 100:.2f}  "
                     f"mRecall {mrec * 100:.2f}  fwIoU {fwiou * 100:.2f}\n"
                     f"LaTeX: {latex_row(iou, ev.include)}\n"
                     "confusion (counts):\n" + matrix_report(ev.conf, names)
                     + "\nacc matrix (row-normalized):\n"
                     + matrix_report(ev.conf, names, "acc")
                     + "\nrecall matrix (col-normalized):\n"
                     + matrix_report(ev.conf, names, "recall"))
        out["ms_per_scan"] = t_total / max(n, 1) * 1000
        log.info(f"inference: {out['ms_per_scan']:.1f} ms/scan on {self.device}")
        return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("config")
    parser.add_argument("--weights", required=True,
                        help=".pth torch state_dict or .npz flat flax tree")
    parser.add_argument("--knn", action="store_true")
    parser.add_argument("--save-preds", default=None)
    parser.add_argument("--max-scans", type=int, default=-1)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    disable_tf32()
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    inf = Inference.from_files(load_options(args.config), args.weights,
                               resolve_device(args.device), use_knn=args.knn,
                               save_preds=args.save_preds)
    out = inf.run(args.max_scans)
    print(out)
    return out


if __name__ == "__main__":
    main()
