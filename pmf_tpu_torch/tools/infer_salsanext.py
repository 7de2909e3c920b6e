"""SemanticKITTI and nuScenes evaluation of SalsaNext on the range view
(counterpart of `pmf_tpu/tools/infer_salsanext.py`).

Per scan: the range view with each point's pixel kept (K1 for the
z-buffer), the forward, the argmax, each point's label by the gather
`argmax[py, px]` or by KNN, the point IoU (not on nuScenes' test split),
and the prediction files: KITTI `.label` files through the inverse class
LUT, or nuScenes `lidarseg/{split}/{token}_lidarseg.bin` uint8 files (one
item a keyframe), which `tools/merge_nuscenes_submission.py` merges with a
camera model's.

Usage:
  python -m pmf_tpu_torch.tools.infer_salsanext <config.yaml> --weights W
      [--knn] [--save-preds DIR] [--split val|train|test] [--max-scans N]
      [--device cpu|cuda]

W is a `.pth` torch state_dict with the reference's module names (a
trainer's snapshot) or an `.npz` of the flat flax tree (see
models/convert.py). The view reads the config's `sensor` group as pmf_tpu's
CLI does (`data.range_config(opts, eval_cli=True)`). SemanticKITTI
evaluates sequence 08; nuScenes the `--split` scenes of `nusc_version`. The
run is on the card unless --device cpu is given.
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
from ..data import (Nuscenes, SemanticKitti, build_range_sample_with_uproj, range_config,
                    range_sample_reader)
from ..metrics import IOUEval
from ..models import build_model, load_weights
from ..ops import argmax_last, knn_postprocess
from ..utils import disable_tf32, resolve_device
from ..utils.tables import per_class_report

log = logging.getLogger(__name__)


class SalsaNextInference:
    """The eval loop over `n_scans` scans from `reader(i)`, a numpy sample
    dict as `data.range_sample_reader` returns. `dataset` (a SemanticKitti
    or a Nuscenes without images) is needed only to name and write
    `save_preds` files and to label the report's classes. On nuScenes'
    `split` "test" no labels are read."""

    def __init__(self, opts: Options, model: torch.nn.Module, reader: Callable[[int], dict],
                 n_scans: int, device: torch.device, use_knn: bool = False,
                 save_preds: str | None = None, dataset: SemanticKitti | Nuscenes | None = None,
                 split: str = "val"):
        if save_preds and dataset is None:
            raise ValueError("save_preds needs the dataset for file names and labels")
        self.opts, self.model, self.reader = opts, model, reader
        self.n_scans, self.device = n_scans, device
        self.use_knn, self.save_preds, self.dataset = use_knn, save_preds, dataset
        self.split = split
        self.cfg = range_config(opts, eval_cli=True)
        knn = opts.group("post").get("KNN", {}).get("params", {})
        self.knn_params = {"knn": int(knn.get("knn", 5)),
                           "search": int(knn.get("search", 5)),
                           "sigma": float(knn.get("sigma", 1.0)),
                           "cutoff": float(knn.get("cutoff", 1.0))}
        self.point_eval = IOUEval(opts.nclasses, ignore=[0])

    @classmethod
    def from_files(cls, opts: Options, weights: str, device: torch.device,
                   use_knn: bool = False, save_preds: str | None = None, split: str = "val"):
        """The CLI's loop: SemanticKITTI sequence 08, or the nuScenes DB
        `nusc_version`'s `split` scenes (split by `nusc_splits_file` or the
        official split), under `opts.data_root` (no images), and the model
        weights at `weights`."""
        if opts.dataset == "nuScenes":
            dataset = Nuscenes(opts.data_root,
                               version=opts.config.get("nusc_version", "v1.0-trainval"),
                               split=split, has_image=False,
                               splits_file=opts.config.get("nusc_splits_file"))
        else:
            dataset = SemanticKitti(opts.data_root, [8], has_image=False)
        model = build_model(opts).to(device).eval()
        load_weights(model, weights)
        reader = range_sample_reader(dataset, range_config(opts, eval_cli=True))
        return cls(opts, model, reader, len(dataset), device, use_knn, save_preds, dataset,
                   split)

    @torch.inference_mode()
    def run(self, max_scans: int = -1) -> dict:
        n = self.n_scans if max_scans < 0 else min(max_scans, self.n_scans)
        t_total = 0.0
        for i in range(n):
            s = self.reader(i)
            dev = lambda k: torch.as_tensor(s[k], device=self.device)
            f, _, _, proj_range, px, py, depth, keep = build_range_sample_with_uproj(
                dev("points"), dev("labels"), dev("valid"), self.cfg)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            argmax = argmax_last(self.model(f[None])[0])
            if self.use_knn:
                point_pred = knn_postprocess(proj_range, depth, argmax, px, py, valid=keep,
                                             nclasses=self.opts.nclasses, **self.knn_params)
            else:
                point_pred = torch.where(keep, argmax[py.long(), px.long()], 0)
            point_pred = point_pred.cpu().numpy()
            t_total += time.perf_counter() - t0

            n_pts = int(s["valid"].sum())
            if self.split != "test" and self.opts.has_label:
                self.point_eval.addBatch(point_pred[:n_pts], s["labels"][:n_pts])
            if self.save_preds:
                self._write(i, point_pred[:n_pts])
            if i % 200 == 0 or i == n - 1:
                log.info(f"[{i + 1}/{n}] mIoU {self.point_eval.getIoU()[0]:.4f} "
                         f"({t_total / (i + 1) * 1000:.1f} ms/scan)")
        return self.report(n, t_total)

    def _write(self, index: int, pred: np.ndarray):
        if self.opts.dataset == "nuScenes":
            out_dir = os.path.join(self.save_preds, "lidarseg", self.split)
            os.makedirs(out_dir, exist_ok=True)
            token = self.dataset.lidar_token(index)
            pred.astype(np.uint8).tofile(os.path.join(out_dir, f"{token}_lidarseg.bin"))
        else:
            seq, frame = self.dataset.parsePathInfoByIndex(index)
            out_dir = os.path.join(self.save_preds, "sequences", seq, "predictions")
            os.makedirs(out_dir, exist_ok=True)
            raw = self.dataset.labelInvMapping(pred)
            raw.astype(np.int32).tofile(os.path.join(out_dir, f"{frame}.label"))

    def report(self, n: int, t_total: float) -> dict:
        miou, iou = self.point_eval.getIoU()
        macc, acc = self.point_eval.getAcc()
        mrec, rec = self.point_eval.getRecall()
        names = self.dataset.mapped_cls_name if self.dataset else \
            {i: str(i) for i in range(self.opts.nclasses)}
        log.info(f"\n==== SalsaNext point metrics ({n} scans) ====\n"
                 + per_class_report(names, iou, acc, rec, self.point_eval.include)
                 + f"\nmIoU {miou * 100:.2f}")
        out = {"mIoU": float(miou), "mAcc": float(macc), "mRecall": float(mrec),
               "ms_per_scan": t_total / max(n, 1) * 1000}
        log.info(f"inference: {out['ms_per_scan']:.1f} ms/scan on {self.device}")
        return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("config")
    parser.add_argument("--weights", required=True,
                        help=".pth torch state_dict or .npz flat flax tree")
    parser.add_argument("--knn", action="store_true")
    parser.add_argument("--save-preds", default=None)
    parser.add_argument("--split", default="val", help="nuScenes: val, train or test")
    parser.add_argument("--max-scans", type=int, default=-1)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    disable_tf32()
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    inf = SalsaNextInference.from_files(load_options(args.config), args.weights,
                                        resolve_device(args.device), use_knn=args.knn,
                                        save_preds=args.save_preds, split=args.split)
    out = inf.run(args.max_scans)
    print(out)
    return out


if __name__ == "__main__":
    main()
