"""The nuScenes eval CLI's six-camera loop, closed: `tools/infer_nuscenes.py:
NuscenesInference.run`, the model built from the CLI's options
(`build_model`), over keyframes that the benchmark's reader serves from a
pool made from the seed (`benchmark/keyframes.py`) and held in host
memory as the sample dicts of `nuscenes_sample_reader`, six items a
keyframe. Each item goes through the H2D copy, `build_eval_sample_with_uproj`
("cam" projection, K1 and a gather), the net at batch 1, the amax, argmax
and gather lift to the points and the read-backs; each keyframe through
the max-confidence merge of its six items and its IoU update, as when a
checkpoint is scored (no KNN, no `--save-preds` files). Each keyframe
served gets a token of its own, so `run` finishes it after its six items.

The window is one `run` over as many keyframes as it takes: once its
seconds have passed, the reader ends it by raising when the loop asks for
the first item of the next keyframe (so a keyframe is either done or not
begun, and no report falls inside it). A keyframe's latency runs from the
ask for its first item to the ask for the next keyframe's. Window: the
95th percentile of the latencies of all keyframes of the window; beside
it, keyframes finished (the loop's `frames` counter) over the seconds from
the window's opening to the last ask, the rate the traced run's MFU
takes (it spread 2.4-6.4 % between runs on the card, so the tail is the
cell's end-to-end metric).

Correct: a sample of the window's keyframes (drawn from the seed) against
the reference: each item's view (features, mask, labels, the points'
pixels and keep flags) bit for bit against `reference/view_cam.py`; the
merged classes against the reference merge of the six items' own
probabilities lifted through the reference view's pixels; what the
keyframe added to the IoU accumulator against the confusions of that
merge; and the probabilities against the float32 ResNet50 reference
(`reference/nets_r50.py`) by `core.prob_error`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import core, inputs, keyframes
from benchmark import trace as tr
from benchmark.reference import nets as ref_nets
from benchmark.reference import nets_r50
from benchmark.reference import view_cam
from benchmark.reference.view import View

CAMERAS = keyframes.CAMERAS


class _WindowClosed(Exception):
    """Raised by the reader when the loop asks for a keyframe after the window."""


class _Tokens:
    """Item i's lidar token in the current `run`: its keyframe's place in
    everything served so far, so a keyframe served twice is two keyframes."""

    def __init__(self, cell):
        self.cell = cell

    def __getitem__(self, i: int) -> str:
        return f"keyframe-{(self.cell.offset + i) // CAMERAS}"


def template(cfg: dict) -> dict:
    with torch.device("meta"):
        return nets_r50.PMFNetR50(cfg["nclasses"], cfg["base_channels"]).state_dict()


class Cell:
    def __init__(self, wl: dict, seed: int, dev):
        from pmf_tpu_torch.config import Options
        from pmf_tpu_torch.models import build_model
        from pmf_tpu_torch.tools.infer_nuscenes import NuscenesInference

        self.wl, self.cfg, self.seed, self.dev = wl, wl["config_data"], seed, dev
        cfg = self.cfg
        opts = Options(config={"sensor": cfg["view"]}, dataset="nuScenes",
                       nclasses=cfg["nclasses"], net_type=cfg["net"],
                       compute_dtype=cfg["compute_dtype"], base_channels=cfg["base_channels"],
                       img_backbone=cfg["img_backbone"])
        self.model = build_model(opts).to(dev).eval()
        self.offset = self.next_item = 0
        self.inf = NuscenesInference(opts, self.model, self._read, 1 << 30, dev, _Tokens(self))
        if not hasattr(self.inf, "frames"):
            raise RuntimeError("NuscenesInference counts no keyframes: the port predates the "
                               "loop's counters this cell reads")
        s = wl["scans"]
        self.items = [it for kf in keyframes.pool(seed, wl["pool"], s, cfg["nclasses"])
                      for it in kf]
        self.sd = inputs.weights(template(cfg), seed, dev)
        self.model.load_state_dict(self.sd)
        # the benchmark's hooks on three calls of the loop: the sampled
        # keyframes' views, the net's probabilities and the merged classes
        build, finish = self.inf.build, self.inf._finish_frame
        self._slot, self.kept, self.asks = None, {}, []

        def build_and_keep(*args):
            out = build(*args)
            if self._slot is not None:
                self.kept[self._slot]["views"].append(out[:6])
            return out

        def finish_and_keep(token, pred, s):
            if self._slot is not None:
                self.kept[self._slot]["merged"] = pred.copy()
            return finish(token, pred, s)

        self.inf.build, self.inf._finish_frame = build_and_keep, finish_and_keep
        self.model.register_forward_hook(self._keep_probs)
        self.sample, self.deadline = None, None
        self._run(wl["warmup"])
        core.sync(dev)

    def _keep_probs(self, _module, _args, out):
        if self._slot is not None:
            self.kept[self._slot]["probs"].append(out[0][0])

    def _read(self, i: int) -> dict:
        n = self.offset + i
        if n % CAMERAS == 0:
            now = time.perf_counter()
            if self._slot is not None:     # the last keyframe was sampled: what it added
                k = self.kept[self._slot]
                k["conf"] = self.inf.point_eval.conf - k.pop("conf0")
            if self.deadline is not None and now >= self.deadline:
                self.closed, self._slot = now, None
                raise _WindowClosed
            self.asks.append(now)
            self._slot = self.sample.slot() if self.sample else None
            if self._slot is not None:
                self.kept[self._slot] = {"keyframe": n // CAMERAS, "views": [], "probs": [],
                                         "conf0": self.inf.point_eval.conf.copy()}
        self.served += 1
        return self.items[n % len(self.items)]

    def _run(self, n: int = 1 << 30):
        """`run` over the next n keyframes, or until the reader closes the
        window."""
        self.offset, self.asks, self.served = self.next_item, [], 0
        try:
            self.inf.run(n)
        except _WindowClosed:
            pass
        finally:
            self.next_item += self.served

    def window(self, seconds: float) -> dict:
        self.sample = core.Reservoir(self.wl["checked_keyframes"], self.seed)
        frames0 = self.inf.frames
        t0 = time.perf_counter()
        self.deadline = t0 + seconds
        self._run()
        self.deadline, self.sample = None, None
        frames = self.inf.frames - frames0
        self.latencies = core.latencies(self.asks, self.closed)
        return {"scan_latency_p95_ms": core.percentile(self.latencies, 95.0) * 1e3,
                "eval_scans_per_s": core.rate(frames, self.closed - t0), "attempted": frames}

    def trace(self, seconds: float) -> dict:
        out = self.window(min(seconds, self.wl["trace"]["rate_s"]))
        t = self.wl["trace"]
        waits = tr.host_waits(lambda: self._run(1))
        window = tr.profile(lambda: self._run(t["profiled_keyframes"]), 1)
        v = self.cfg["view"]
        return {"kind": "keyframe", "spans": {}, "host_waits": waits, "window": window,
                "busy_s": tr.busy_s(window), "window_s": window["wall_s"],
                "calls_per_s": out["eval_scans_per_s"],
                "flops_per_call": CAMERAS * nets_r50.count(1, v["proj_h"], v["proj_w"],
                                                           self.cfg["nclasses"],
                                                           self.cfg["base_channels"],
                                                           train=False),
                "work": {}, "attempted": out["attempted"]}

    # --- correctness ----------------------------------------------------

    def _tensors(self, s: dict):
        t = lambda k: torch.as_tensor(s[k], device=self.dev)
        return (t("points"), t("labels"), t("valid"), t("proj_matrix"), t("image"),
                int(s["img_h"]), int(s["img_w"]))

    def _keyframe(self, k: int) -> list[dict]:
        first = (k * CAMERAS) % len(self.items)
        return self.items[first:first + CAMERAS]

    def program_answers(self) -> dict:
        """{slot: (keyframe, its items' views, their probabilities, the merged
        classes, the confusions it added)} of the sampled keyframes."""
        return {slot: (k["keyframe"], k["views"], k["probs"], k["merged"], k["conf"])
                for slot, k in sorted(self.kept.items())}

    def release(self):
        del self.inf, self.model
        torch.cuda.empty_cache()

    def reference_model(self, fp8: bool = False):
        """The float32 reference net (the control with `fp8`), loaded with
        the cell's weights."""
        with torch.device(self.dev):
            model = nets_r50.PMFNetR50(self.cfg["nclasses"], self.cfg["base_channels"],
                                       self.cfg["dropout_rate"])
        model.load_state_dict(self.sd)
        return ref_nets.set_fp8(model, fp8).eval()

    def reference_answers(self, fp8: bool) -> dict:
        """`program_answers` of the reference in the program's place (the
        control with `fp8`), on the same keyframes."""
        model = self.reference_model(fp8)
        rv = View.from_dict(self.cfg["view"])
        out = {}
        for slot, k in sorted(self.kept.items()):
            views, probs, lifted = [], [], []
            for s in self._keyframe(k["keyframe"]):
                v = view_cam.cam_item(*self._tensors(s), rv)
                with torch.no_grad():
                    p = model(v[0][None, ..., :5], v[0][None, ..., 5:8])[0][0]
                views.append(v)
                probs.append(p)
                lifted.append(view_cam.lift(p, *v[3:6]))
            merged = view_cam.merge(lifted)
            s = self._keyframe(k["keyframe"])[-1]
            out[slot] = (k["keyframe"], views, probs, merged, view_cam.keyframe_confusion(
                merged, s["labels"], s["valid"], self.cfg["nclasses"]))
        return out

    def compare(self, answers: dict) -> dict:
        """The compared numbers of `answers` against the float32 reference:
        the views bit for bit; the merged classes against the merge of the
        answers' own probabilities lifted through the reference view; the
        confusions the keyframe added against that merge's; the
        probabilities by `core.prob_error`."""
        model = self.reference_model()
        rv = View.from_dict(self.cfg["view"])
        mismatch, merge_wrong, wrong, err, scale = 0, 0, 0.0, 0.0, 0.0
        for _, (k, views, probs, merged, conf) in sorted(answers.items()):
            items = self._keyframe(k)
            lifted = []
            for s, got, p in zip(items, views, probs):
                want = view_cam.cam_item(*self._tensors(s), rv)
                for a, b in zip(got, want):
                    mismatch += int((a != b).sum()) if a.shape == b.shape else b.numel()
                lifted.append(view_cam.lift(p, *want[3:6]))
                with torch.no_grad():
                    ref = model(want[0][None, ..., :5], want[0][None, ..., 5:8])[0][0]
                e, sc = core.prob_error(p, ref)
                err, scale = err + e, scale + sc
            mismatch += abs(len(items) - len(views)) * rv.proj_h * rv.proj_w
            want_merged = view_cam.merge(lifted)
            merge_wrong += int((np.asarray(merged) != want_merged).sum())
            want_conf = view_cam.keyframe_confusion(want_merged, items[-1]["labels"],
                                                    items[-1]["valid"], self.cfg["nclasses"])
            wrong += float(np.abs(conf - want_conf).sum())
        return {"view_mismatch": mismatch, "merge_mismatch": merge_wrong,
                "confusion_mismatch": wrong, "prob_err": err / max(scale, 1e-30)}

    def check(self) -> dict:
        answers = self.program_answers()
        self.release()
        return self.compare(answers)
