"""nuScenes evaluation of PMFNet and EPMFNet with the six cameras merged
(counterpart of `pmf_tpu/tools/infer_nuscenes.py`).

Each item is one (lidar, camera) pair, six consecutive items a keyframe:
  * the per-item forward at the eval size (PMF: the "cam" perspective view
    through K1; EPMF: the V2 view through K1);
  * each point's (confidence, class) gathered at its clipped pixel, or with
    --knn the class by the KNN vote (EPMF also pushes the confidence map
    through that vote, whose integer truncation makes it 0 or 1, as
    pmf_tpu and the reference do; PMF keeps the gathered confidence);
  * the running max-confidence merge over the keyframe's cameras: a camera
    takes a point where its confidence is higher (points no camera sees
    keep class 0); a keyframe is finished when its lidar token changes
    after six cameras;
  * `lidarseg/{split}/{token}_lidarseg.bin` uint8 files with --save-preds;
  * the point IoU over the covered points (class > 0), class 0 ignored.

Usage:
  python -m pmf_tpu_torch.tools.infer_nuscenes <config.yaml> --weights W
      [--knn] [--save-preds DIR] [--split val|train|test] [--max-frames N]
      [--device cpu|cuda]

W is a `.pth` torch state_dict (a trainer's snapshot) or an `.npz` of the
flat flax tree (`scripts/export_flax_npz.py` writes one from a pmf_tpu
snapshot). The run is on the card unless --device cpu is given.
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
from ..data import (Nuscenes, PVConfig, V2Config, build_eval_sample_with_uproj,
                    build_v2_eval_sample_with_uproj, nuscenes_sample_reader)
from ..metrics import IOUEval
from ..models import build_model, load_weights
from ..ops import argmax_last, knn_postprocess
from ..utils import disable_tf32, resolve_device
from ..utils.spans import span
from ..utils.tables import per_class_report

log = logging.getLogger(__name__)

N_CAMERAS = 6


def eval_view_config(opts: Options) -> PVConfig | V2Config:
    """The eval view of pmf_tpu's nuScenes CLI: PMF's "cam" view from the
    `sensor` group (pads 0 unless set), EPMF's V2 view from `PVconfig`;
    `pcd_mean`/`pcd_stds` (else `img_mean`/`img_stds`) normalize."""
    is_v2 = opts.net_type == "EPMFNet"
    group = opts.group("PVconfig") if is_v2 else opts.group("sensor")
    common = dict(
        canvas_h=int(group.get("canvas_h", 900)), canvas_w=int(group.get("canvas_w", 1600)),
        proj_h=int(group.get("proj_h", 896)), proj_w=int(group.get("proj_w", 1600)),
        n_points=int(group.get("n_points", 65536)),
        img_mean=tuple(group.get("pcd_mean", group.get("img_mean", PVConfig.img_mean))),
        img_stds=tuple(group.get("pcd_stds", group.get("img_stds", PVConfig.img_stds))))
    if is_v2:
        return V2Config(proj_ht=common["proj_h"], proj_wt=common["proj_w"], **common)
    return PVConfig(h_pad=int(group.get("h_pad", 0)), w_pad=int(group.get("w_pad", 0)),
                    projection="cam", **common)


class NuscenesInference:
    """The eval loop over `n_items` (lidar, camera) items from `reader(i)`
    (the numpy sample dict of `data.nuscenes_sample_reader`), item i of the
    keyframe whose lidar token is `tokens[i]`. `class_names` label the
    report's classes.

    `run` marks each keyframe as the span pmf.keyframe (`utils/spans.py`),
    holding per item pmf.keyframe.read (the reader), .h2d (the copies to
    the device), pmf.view, pmf.model, .lift (amax, argmax and the gathers
    or the KNN vote), .readback (the `.cpu()` of class and confidence) and
    .merge (the numpy max-confidence merge), and once .finish
    (`_finish_frame`). Its counters: `items` and `frames` done;
    `contested`, the points that more than one camera of a keyframe kept;
    `kept_points`, the points that each item's view kept, summed over the
    items; and `empty_items`, the items whose view kept none."""

    def __init__(self, opts: Options, model: torch.nn.Module, reader: Callable[[int], dict],
                 n_items: int, device: torch.device, tokens, use_knn: bool = False,
                 save_preds: str | None = None, split: str = "val",
                 class_names: dict | None = None):
        self.opts, self.model, self.reader = opts, model, reader
        self.n_items, self.device, self.tokens = n_items, device, tokens
        self.use_knn, self.save_preds, self.split = use_knn, save_preds, split
        self.class_names = class_names or {i: str(i) for i in range(opts.nclasses)}
        self.is_v2 = opts.net_type == "EPMFNet"
        self.cfg = eval_view_config(opts)
        self.build = build_v2_eval_sample_with_uproj if self.is_v2 else \
            build_eval_sample_with_uproj
        knn = opts.group("post").get("KNN", {}).get("params", {})
        self.knn_params = {"knn": int(knn.get("knn", 5)),
                           "search": int(knn.get("search", 5)),
                           "sigma": float(knn.get("sigma", 1.0)),
                           "cutoff": float(knn.get("cutoff", 1.0))}
        self.point_eval = IOUEval(opts.nclasses, ignore=[0])
        self.covered = self.points = 0
        self.items = self.frames = self.contested = 0
        self.kept_points = self.empty_items = 0

    @classmethod
    def from_files(cls, opts: Options, weights: str, device: torch.device,
                   use_knn: bool = False, save_preds: str | None = None, split: str = "val"):
        """The CLI's loop: the nuScenes DB `nusc_version` under
        `opts.data_root` (split by `nusc_splits_file` or the official split)
        and the model weights at `weights`."""
        dataset = Nuscenes(opts.data_root, version=opts.config.get("nusc_version", "v1.0-trainval"),
                           split=split, splits_file=opts.config.get("nusc_splits_file"))
        model = build_model(opts).to(device).eval()
        load_weights(model, weights)
        tokens = [dataset.lidar_token(i) for i in range(len(dataset))]
        return cls(opts, model, nuscenes_sample_reader(dataset, eval_view_config(opts)),
                   len(dataset), device, tokens, use_knn, save_preds, split,
                   dataset.mapped_cls_name)

    def item(self, s: dict):
        """One item's per-point (class [N] int32, confidence [N] float32)
        as numpy arrays: class 0 and confidence -1 where not kept."""
        cfg = self.cfg
        with span("pmf.keyframe.h2d"):
            points, labels, valid, proj, image = (
                torch.as_tensor(s[k], device=self.device)
                for k in ("points", "labels", "valid", "proj_matrix", "image"))
        f, m, _, rows, cols, keep, depth = self.build(
            points, labels, valid, proj, image, int(s["img_h"]), int(s["img_w"]), cfg)
        probs = self.model(f[None, ..., :5], f[None, ..., 5:8])[0][0]
        with span("pmf.keyframe.lift"):
            conf, argmax = probs.amax(-1), argmax_last(probs)
            rows_c = rows.clamp(0, conf.shape[0] - 1)
            cols_c = cols.clamp(0, conf.shape[1] - 1)
            if self.use_knn:
                proj_depth = torch.where(m, f[..., 0] * cfg.img_stds[0] + cfg.img_mean[0], -1.0)
                vote = lambda values: knn_postprocess(proj_depth, depth, values, cols_c, rows_c,
                                                      valid=keep, nclasses=self.opts.nclasses,
                                                      **self.knn_params)
                pt_pred = vote(argmax)
                pt_conf = vote(conf).float() if self.is_v2 else conf[rows_c.long(), cols_c.long()]
            else:
                pt_pred = argmax[rows_c.long(), cols_c.long()]
                pt_conf = conf[rows_c.long(), cols_c.long()]
            pt_pred = torch.where(keep, pt_pred, 0)
            pt_conf = torch.where(keep, pt_conf.float(), -1.0)
        with span("pmf.keyframe.readback"):
            return pt_pred.cpu().numpy(), pt_conf.cpu().numpy()

    @torch.inference_mode()
    def run(self, max_frames: int = -1) -> dict:
        """Score the items' keyframes (the first `max_frames`, all with -1).
        Each keyframe is a span (`utils/spans.py`), pmf.keyframe, holding
        its items' parts and its finish; the counters `items`, `frames`,
        `contested` (points that more than one camera of a keyframe kept),
        `kept_points` (points an item's view kept, summed over the items)
        and `empty_items` (items whose view kept none) add up over the
        calls."""
        n_items = self.n_items if max_frames <= 0 else min(self.n_items, max_frames * N_CAMERAS)
        n_frames = i = 0
        t0 = time.perf_counter()
        while i < n_items:
            token = self.tokens[i]
            with span("pmf.keyframe"):
                merged_pred = merged_conf = seen = contested = last = None
                cams_seen = 0
                while i < n_items and self.tokens[i] == token:
                    with span("pmf.keyframe.read"):
                        last = self.reader(i)
                    pt_pred, pt_conf = self.item(last)
                    with span("pmf.keyframe.merge"):
                        kept = pt_conf >= 0
                        n_kept = int(kept.sum())
                        self.kept_points += n_kept
                        self.empty_items += int(n_kept == 0)
                        if merged_conf is None:
                            merged_pred, merged_conf = pt_pred, pt_conf
                            seen, contested = kept, np.zeros_like(kept)
                        else:
                            better = pt_conf > merged_conf
                            merged_conf = np.where(better, pt_conf, merged_conf)
                            merged_pred = np.where(better, pt_pred, merged_pred)
                            contested |= seen & kept
                            seen |= kept
                    cams_seen += 1
                    self.items += 1
                    i += 1
                if cams_seen == N_CAMERAS:
                    with span("pmf.keyframe.finish"):
                        self._finish_frame(token, merged_pred, last)
                    n_frames += 1
                    self.frames += 1
                    self.contested += int(contested.sum())
        return self.report(n_frames, time.perf_counter() - t0)

    def _finish_frame(self, token: str, pred: np.ndarray, s: dict):
        """A keyframe's merged classes: the IoU of its covered points against
        the labels (not on the test split), its lidarseg file."""
        n = int(s["valid"].sum())
        pred = pred[:n]
        covered = pred > 0
        self.covered += int(covered.sum())
        self.points += n
        if self.split != "test":
            self.point_eval.addBatch(pred[covered], s["labels"][:n][covered])
        if self.save_preds:
            out_dir = os.path.join(self.save_preds, "lidarseg", self.split)
            os.makedirs(out_dir, exist_ok=True)
            pred.astype(np.uint8).tofile(os.path.join(out_dir, f"{token}_lidarseg.bin"))

    def report(self, n_frames: int, seconds: float) -> dict:
        miou, iou = self.point_eval.getIoU()
        macc, acc = self.point_eval.getAcc()
        mrec, rec = self.point_eval.getRecall()
        log.info(f"\n==== nuScenes point metrics ({n_frames} frames) ====\n"
                 + per_class_report(self.class_names, iou, acc, rec, self.point_eval.include)
                 + f"\nmIoU {miou * 100:.2f}")
        out = {"mIoU": float(miou), "mAcc": float(macc), "mRecall": float(mrec),
               "frames": n_frames, "coverage": self.covered / max(self.points, 1),
               "ms_per_frame": seconds / max(n_frames, 1) * 1000}
        log.info(f"inference: {out['ms_per_frame']:.1f} ms/keyframe ({N_CAMERAS} cameras, "
                 f"host and device) on {self.device}; {out['coverage']:.4f} of the points "
                 "covered")
        return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("config")
    parser.add_argument("--weights", required=True,
                        help=".pth torch state_dict or .npz flat flax tree")
    parser.add_argument("--knn", action="store_true")
    parser.add_argument("--save-preds", default=None)
    parser.add_argument("--split", default="val")
    parser.add_argument("--max-frames", type=int, default=-1)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    disable_tf32()
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    inf = NuscenesInference.from_files(load_options(args.config), args.weights,
                                       resolve_device(args.device), use_knn=args.knn,
                                       save_preds=args.save_preds, split=args.split)
    out = inf.run(args.max_frames)
    print(out)
    return out


if __name__ == "__main__":
    main()
