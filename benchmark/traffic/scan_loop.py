"""The eval CLI's per-scan loop, closed: `tools/infer_kitti.py:
Inference.run` over scans that the benchmark's reader serves from a pool
made from the seed and held in host memory as the sample dicts of
`kitti_sample_reader`. Each scan goes through the H2D copy,
`build_eval_sample_with_uproj` (K1 and a gather), the net, `argmax_last`,
the gather lift to the points, the read-backs and both IoU accumulators,
as when a checkpoint is scored (no `--save-preds` files: their writes
cost 3-5 ms a scan and widened the tail on the card's shared host).

The window is one `run` over as many scans as it takes: once its seconds
have passed, the reader ends it by raising when the loop asks for the next
scan (so no chunk's end, with `run`'s report, falls inside it). A scan's
latency runs from the time the loop asks the reader for it to the time it
asks for the next one. Window: the 95th percentile of the latencies of
all scans of the window.

Correct: a sample of the window's scans (drawn from the seed) against the
reference: the view (features) bit for bit; what the scan added to the
point and pixel IoU accumulators equal to the confusions of the argmax of
the net's probabilities, lifted through the view's pixels to the kept
points; and those probabilities against the reference's by
`core.prob_error`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import core, inputs, port
from benchmark import trace as tr
from benchmark.reference import view as ref_view


class _WindowClosed(Exception):
    """Raised by the reader when the loop asks for a scan after the window."""


class Cell:
    e2e = "scan_latency_p95_ms"

    def __init__(self, wl: dict, seed: int, dev):
        from pmf_tpu_torch.config import Options
        from pmf_tpu_torch.tools.infer_kitti import Inference

        self.wl, self.cfg, self.seed, self.dev = wl, wl["config_data"], seed, dev
        s = wl["scans"]
        pool = inputs.scan_pool(seed, wl["pool"], s, self.cfg["nclasses"])
        # one sample dict a scan, as kitti_sample_reader returns them
        self.scans = [{"points": b[0][j], "labels": b[1][j], "valid": b[2][j],
                       "proj_matrix": b[3][j], "image": b[4][j], "img_h": b[5][j],
                       "img_w": b[6][j], "index": np.int32(k)}
                      for k, (b, j) in enumerate((b, j) for b in pool for j in range(len(b[0])))]
        self.sd = port.make_weights(self.cfg, seed, dev)
        self.model = port.program_model(self.cfg, self.sd, dev, train=False)
        opts = Options(config={"sensor": self.cfg["view"],
                               "augmentation": {"img_jitter": self.cfg["view"]["img_jitter"]}},
                       dataset="SemanticKitti", nclasses=self.cfg["nclasses"],
                       net_type=self.cfg["net"], compute_dtype=self.cfg["compute_dtype"],
                       base_channels=self.cfg["base_channels"],
                       img_backbone=self.cfg["img_backbone"])
        self.inf = Inference(opts, self.model, self._read, 1 << 30, dev, ignore=(0,))
        # the benchmark's spans around two calls of the loop: what the view
        # built and what the net returned, kept for the sampled scans (with
        # what each added to the IoU accumulators, read at the next ask)
        build = self.inf.build
        self._slot, self.kept, self.asks = None, {}, []

        def build_and_keep(*args):
            out = build(*args)
            if self._slot is not None:
                self.kept[self._slot]["view"] = out[0]
            return out

        self.inf.build = build_and_keep
        self.model.register_forward_hook(self._keep_probs)
        self.sample, self.deadline, self.next_scan, self.offset = None, None, 0, 0
        self._run(wl["warmup"])
        core.sync(dev)

    def _keep_probs(self, _module, _args, out):
        if self._slot is not None:
            self.kept[self._slot]["probs"] = out[0][0]

    def _read(self, i: int) -> dict:
        now = time.perf_counter()
        if self._slot is not None:      # the last scan was sampled: what it added
            k = self.kept[self._slot]
            k["conf"] = (self.inf.point_eval.conf - k.pop("point0"),
                         self.inf.pixel_eval.conf - k.pop("pixel0"))
        if self.deadline is not None and now >= self.deadline:
            self.closed, self._slot = now, None
            raise _WindowClosed
        self.asks.append(now)
        n = self.offset + i
        self._slot = self.sample.slot() if self.sample else None
        if self._slot is not None:
            self.kept[self._slot] = {"scan": n, "point0": self.inf.point_eval.conf.copy(),
                                     "pixel0": self.inf.pixel_eval.conf.copy()}
        return self.scans[n % len(self.scans)]

    def _run(self, n: int = 1 << 30):
        """`run` over the next n scans, or until the reader closes the
        window."""
        self.offset = self.next_scan
        self.asks = []
        try:
            self.inf.run(n)
        except _WindowClosed:
            pass
        finally:
            self.next_scan += len(self.asks)

    def window(self, seconds: float) -> dict:
        self.sample = core.Reservoir(self.wl["checked_scans"], self.seed)
        self.deadline = time.perf_counter() + seconds
        self._run()
        self.deadline, self.sample = None, None
        self.latencies = core.latencies(self.asks, self.closed)
        return {self.e2e: core.percentile(self.latencies, 95.0) * 1e3,
                "attempted": len(self.latencies)}

    def trace(self, seconds: float) -> dict:
        from benchmark.reference import flops

        out = self.window(min(seconds, self.wl["trace"]["rate_s"]))
        mean_s = sum(self.latencies) / len(self.latencies)
        t = self.wl["trace"]
        waits = tr.host_waits(lambda: self._run(1))
        window = tr.profile(lambda: self._run(t["profiled_calls"]), 1)
        v = self.cfg["view"]
        n = self.wl["scans"]["points"]
        kept = int(self._reference_keep().sum())
        return {"kind": "scan", "spans": {}, "host_waits": waits, "window": window,
                "busy_s": tr.busy_s(window), "window_s": window["wall_s"],
                "calls_per_s": 1.0 / mean_s,
                "flops_per_call": flops.count(self.cfg["net"], 1, v["proj_h"], v["proj_w"],
                                              self.cfg["nclasses"], self.cfg["base_channels"],
                                              train=False),
                "work": {"zbuffer_keys": (1, n, kept, v["proj_h"], v["proj_w"])},
                "attempted": out["attempted"]}

    def _reference_keep(self):
        s = self._tensors(self.scans[0])
        return ref_view.pv_scan(*s, port.reference_view(self.cfg))[5]

    def _tensors(self, s: dict):
        t = lambda k: torch.as_tensor(s[k], device=self.dev)
        return (t("points"), t("labels"), t("valid"), t("proj_matrix"), t("image"),
                int(s["img_h"]), int(s["img_w"]))

    # --- correctness ----------------------------------------------------

    def program_answers(self) -> dict:
        """{slot: (scan, view features, probabilities, (point confusion,
        pixel confusion) that the scan added)} of the sampled scans."""
        return {slot: (k["scan"], k["view"], k["probs"], k["conf"])
                for slot, k in sorted(self.kept.items())}

    def release(self):
        del self.inf, self.model
        torch.cuda.empty_cache()

    def reference_answers(self, fp8: bool) -> dict:
        """`program_answers` of the reference in the program's place (the
        control with `fp8`), on the same scans."""
        model = port.reference_model(self.cfg, self.sd, self.dev, train=False, fp8=fp8)
        rv = port.reference_view(self.cfg)
        out = {}
        for slot, k in sorted(self.kept.items()):
            s = self.scans[k["scan"] % len(self.scans)]
            f, _, l2d, rows, cols, keep = ref_view.pv_scan(*self._tensors(s), rv)
            with torch.no_grad():
                probs = model(f[None, ..., :5], f[None, ..., 5:8])[0][0]
            out[slot] = (k["scan"], f, probs, self._confusions(probs, s, l2d, rows, cols, keep, rv))
        return out

    def _confusions(self, probs, s: dict, l2d, rows, cols, keep, rv):
        """(point, pixel) confusions conf[pred, label] of the argmax of
        `probs`: at the kept valid points, lifted through their pixels,
        against their labels; at the pixels labelled in the view."""
        C = probs.shape[-1]
        pred = probs.argmax(-1)
        ok = keep & torch.as_tensor(s["valid"], device=self.dev)
        pt = pred[rows.clamp(0, rv.proj_h - 1).long(), cols.clamp(0, rv.proj_w - 1).long()]
        labels = torch.as_tensor(s["labels"], device=self.dev).long()

        def conf(p, t):
            return torch.bincount(p * C + t, minlength=C * C).reshape(C, C).double().cpu().numpy()

        return conf(pt[ok], labels[ok]), conf(pred[l2d > 0], l2d[l2d > 0].long())

    def compare(self, answers: dict) -> dict:
        """The compared numbers of `answers` against the float32 reference:
        the view's features bit for bit; the confusions that the scan added
        against those of the argmax of its probabilities through the
        reference's view; the probabilities by `core.prob_error`."""
        model = port.reference_model(self.cfg, self.sd, self.dev, train=False)
        rv = port.reference_view(self.cfg)
        mismatch, wrong, err, scale = 0, 0.0, 0.0, 0.0
        for _, (scan, feat, probs, confs) in sorted(answers.items()):
            s = self.scans[scan % len(self.scans)]
            f, _, l2d, rows, cols, keep = ref_view.pv_scan(*self._tensors(s), rv)
            mismatch += int((feat != f).sum()) if feat.shape == f.shape else f.numel()
            want = self._confusions(probs, s, l2d, rows, cols, keep, rv)
            wrong += sum(float(np.abs(a - b).sum()) for a, b in zip(confs, want))
            with torch.no_grad():
                ref = model(f[None, ..., :5], f[None, ..., 5:8])[0][0]
            e, sc = core.prob_error(probs, ref)
            err, scale = err + e, scale + sc
        return {"view_mismatch": mismatch, "confusion_mismatch": wrong, "prob_err": err / scale}

    def check(self) -> dict:
        answers = self.program_answers()
        self.release()
        return self.compare(answers)
