"""SensatUrban evaluation of PMFNet: sliding windows at several scales with
test-time augmentation (counterpart of `pmf_tpu/tools/infer_sensat.py`).

Per BEV frame:
  * at each scale (320, 448, 576 px by default) a grid of non-overlapping
    windows, the last row and column snapped back inside the frame; each
    window zero-padded to the scale;
  * the 7 test-time views of a window (identity, rot90, rot180, rot270,
    horizontal flip, vertical flip, transpose) in one forward, each view's
    probabilities mapped back and averaged (--no-tta: the identity alone);
  * the probabilities summed over windows and scales, then the argmax;
    the 2D IoU over the labelled cells;
  * each point's class at its cell (h_idx, w_idx), or with --knn the KNN
    vote over the max-height channel as the range image and the point's z
    (from the frame's .ply) as its range; class 0 becomes 1 (ground);
  * the 3D IoU against the frame's .bin labels + 1, and with --save-preds
    a uint8 `.label` file of (class - 1) a frame.

PMFNet runs in float32 whatever the config's compute_dtype, as in pmf_tpu.

Usage:
  python -m pmf_tpu_torch.tools.infer_sensat <config.yaml> --weights W
      [--scales 320 448 576] [--no-tta] [--knn] [--save-preds DIR]
      [--split val|train|test] [--max-frames N] [--device cpu|cuda]

W is a `.pth` torch state_dict (a trainer's snapshot) or an `.npz` of the
flat flax tree (`scripts/export_flax_npz.py`). The run is on the card
unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from ..config import Options, load_options
from ..data import SensatUrban
from ..data.sensat_urban import read_ply
from ..metrics import IOUEval
from ..models import PMFNet, load_weights
from ..ops import argmax_last, knn_postprocess
from ..utils import disable_tf32, resolve_device
from ..utils.tables import per_class_report

log = logging.getLogger(__name__)

# (name, view, its inverse) of a window [H, W, C]
TTA_OPS = [
    ("id", lambda x: x, lambda x: x),
    ("rot90", lambda x: torch.rot90(x, 1, (0, 1)), lambda x: torch.rot90(x, -1, (0, 1))),
    ("rot180", lambda x: torch.rot90(x, 2, (0, 1)), lambda x: torch.rot90(x, -2, (0, 1))),
    ("rot270", lambda x: torch.rot90(x, 3, (0, 1)), lambda x: torch.rot90(x, -3, (0, 1))),
    ("hflip", lambda x: x.flip(1), lambda x: x.flip(1)),
    ("vflip", lambda x: x.flip(0), lambda x: x.flip(0)),
    ("transpose", lambda x: x.transpose(0, 1), lambda x: x.transpose(0, 1)),
]


def grid(total: int, size: int, stride: int) -> list[int]:
    """Window starts covering [0, total), the last snapped back to end at
    `total` (0 when the frame is smaller than a window)."""
    starts = list(range(0, max(total - size, 0) + 1, stride))
    if starts[-1] + size < total:
        starts.append(max(total - size, 0))
    return starts


class SensatInference:
    """The eval loop over the frames of `dataset` (a SensatUrban with
    keep_idx) with `model`, a PMFNet in float32."""

    def __init__(self, opts: Options, model: torch.nn.Module, dataset: SensatUrban,
                 device: torch.device, scales=(320, 448, 576), use_tta: bool = True,
                 use_knn: bool = False, save_preds: str | None = None, split: str = "val"):
        self.opts, self.model, self.dataset, self.device = opts, model, dataset, device
        self.scales = [int(s) for s in scales]
        self.use_tta, self.use_knn = use_tta, use_knn
        self.save_preds, self.split = save_preds, split
        knn = opts.group("post").get("KNN", {}).get("params", {})
        self.knn_params = {"knn": int(knn.get("knn", 5)),
                           "search": int(knn.get("search", 5)),
                           "sigma": float(knn.get("sigma", 1.0)),
                           "cutoff": float(knn.get("cutoff", 1.0))}
        self.eval2d = IOUEval(opts.nclasses, ignore=[0])
        self.eval3d = IOUEval(opts.nclasses, ignore=[0])
        self.forwards = 0

    @classmethod
    def from_files(cls, opts: Options, weights: str, device: torch.device, **kw):
        """The CLI's loop: the `split` frames under opts.data_root (with
        each point's cell) and a float32 PMFNet with the weights at
        `weights`."""
        dataset = SensatUrban(opts.data_root, kw.get("split", "val"), keep_idx=True)
        model = PMFNet(nclasses=opts.nclasses, base_channels=opts.base_channels,
                       image_backbone=opts.img_backbone).to(device).eval()
        load_weights(model, weights)
        return cls(opts, model, dataset, device, **kw)

    def predict_window(self, window: torch.Tensor) -> torch.Tensor:
        """Class probabilities [S, S, C] of a window [S, S, 8]: its test-time
        views in one forward, mapped back and averaged."""
        ops = TTA_OPS if self.use_tta else TTA_OPS[:1]
        views = torch.stack([view(window) for _, view, _ in ops])
        probs = self.model(views[..., :5], views[..., 5:8])[0]
        self.forwards += len(ops)
        acc = ops[0][2](probs[0])
        for (_, _, inverse), p in zip(ops[1:], probs[1:]):
            acc = acc + inverse(p)
        return acc / len(ops)

    def lift(self, frame: dict, pred2d: torch.Tensor, fm: torch.Tensor, index: int) -> np.ndarray:
        """Per-point classes (1..C-1) of the 2D prediction: the class at each
        point's cell, or with KNN the vote over the max-height channel as
        the range image and the point's z from the frame's .ply; 0 → 1."""
        t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=self.device)
        h_idx, w_idx = t(frame["h_idx"]), t(frame["w_idx"])
        if self.use_knn:
            ply = os.path.join(self.dataset.split_folder,
                               os.path.splitext(self.dataset.readFileNameByIndex(index))[0]
                               + ".ply")
            z = torch.as_tensor(np.asarray(read_ply(ply)["z"], np.float32), device=self.device)
            pt = knn_postprocess(fm[0], z, pred2d, w_idx, h_idx,
                                 valid=torch.ones_like(z, dtype=torch.bool),
                                 nclasses=self.opts.nclasses, **self.knn_params)
        else:
            pt = pred2d[h_idx, w_idx]
        return torch.where(pt == 0, 1, pt).to(torch.int32).cpu().numpy()

    @torch.inference_mode()
    def run(self, max_frames: int = -1) -> dict:
        n = len(self.dataset) if max_frames < 0 else min(max_frames, len(self.dataset))
        t_total = 0.0
        for i in range(n):
            frame = self.dataset.readDataByIndex(i)
            t0 = time.perf_counter()
            fm = torch.as_tensor(np.asarray(frame["feature_map"], np.float32), device=self.device)
            lm = torch.as_tensor(np.asarray(frame["label_map"], np.float32), device=self.device)
            H, W = lm.shape
            conf = torch.zeros((H, W, self.opts.nclasses), device=self.device)
            hwc = fm.permute(1, 2, 0)
            for size in self.scales:
                for top in grid(H, size, size):
                    for left in grid(W, size, size):
                        h, w = min(size, H - top), min(size, W - left)
                        win = hwc.new_zeros((size, size, 8))
                        win[:h, :w] = hwc[top:top + h, left:left + w]
                        conf[top:top + h, left:left + w] += self.predict_window(win)[:h, :w]
            pred2d = argmax_last(conf)
            gt2d = ((lm + 1) * fm[4]).to(torch.int32)
            self.eval2d.addBatch(pred2d, gt2d, valid=gt2d > 0)
            if frame.get("h_idx") is not None:
                pt = self.lift(frame, pred2d, fm, i)
                if self.split != "test":
                    try:
                        gt3d = self.dataset.readLabelByIndex(i).astype(np.int32) + 1
                        self.eval3d.addBatch(pt, gt3d)
                    except FileNotFoundError:
                        pass  # no .bin labels beside the frames
                if self.save_preds:
                    os.makedirs(self.save_preds, exist_ok=True)
                    (pt - 1).astype(np.uint8).tofile(os.path.join(
                        self.save_preds,
                        self.dataset.readFileNameByIndex(i).replace(".bin", ".label")))
            t_total += time.perf_counter() - t0
            log.info(f"[{i + 1}/{n}] mIoU {self.eval2d.getIoU()[0]:.4f}")
        return self.report(n, t_total)

    def report(self, n: int, seconds: float) -> dict:
        miou, iou = self.eval2d.getIoU()
        macc, acc = self.eval2d.getAcc()
        mrec, rec = self.eval2d.getRecall()
        out = {"mIoU": float(miou), "mAcc": float(macc), "mRecall": float(mrec),
               "ms_per_frame": seconds / max(n, 1) * 1000,
               "ms_per_forward": seconds / max(self.forwards, 1) * 1000}
        names = {0: "ignore"}
        names.update({k + 1: v for k, v in self.dataset.mapped_cls_name.items() if k >= 0})
        log.info("\n" + per_class_report(names, iou, acc, rec, self.eval2d.include)
                 + f"\nmIoU {miou * 100:.2f}")
        if float(self.eval3d.conf.sum()) > 0:
            miou3, iou3 = self.eval3d.getIoU()
            out["point_mIoU"] = float(miou3)
            log.info("\n==== 3D point metrics ====\n"
                     + per_class_report(names, iou3, self.eval3d.getAcc()[1],
                                        self.eval3d.getRecall()[1], self.eval3d.include)
                     + f"\npoint mIoU {miou3 * 100:.2f}")
        log.info(f"inference: {out['ms_per_frame']:.1f} ms/frame, {out['ms_per_forward']:.2f} "
                 f"ms per window view ({self.forwards} views) on {self.device}")
        return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("config")
    parser.add_argument("--weights", required=True,
                        help=".pth torch state_dict or .npz flat flax tree")
    parser.add_argument("--scales", type=int, nargs="*", default=[320, 448, 576])
    parser.add_argument("--no-tta", action="store_true")
    parser.add_argument("--knn", action="store_true")
    parser.add_argument("--save-preds", default=None)
    parser.add_argument("--split", default="val")
    parser.add_argument("--max-frames", type=int, default=-1)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    disable_tf32()
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    opts = load_options(args.config)
    inf = SensatInference.from_files(
        opts, args.weights, resolve_device(args.device), scales=args.scales,
        use_tta=not args.no_tta,
        use_knn=args.knn or bool(opts.group("post").get("KNN", {}).get("use")),
        save_preds=args.save_preds, split=args.split)
    out = inf.run(args.max_frames)
    print(out)
    return out


if __name__ == "__main__":
    main()
