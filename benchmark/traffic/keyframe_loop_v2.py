"""EPMF's nuScenes eval loop, closed: `tools/infer_nuscenes.py:
NuscenesInference.run` with EPMFNet (the model built from the CLI's options
by `build_model`, the V2 view read from a `PVconfig` group by
`eval_view_config`), over keyframes that the benchmark's reader serves from
a pool made from the seed (`benchmark/keyframes.py`), six items a keyframe,
each with its own lidar → image matrix. Each item goes through the H2D copy,
`build_v2_eval_sample_with_uproj` (the ±45° yaw crop about the lidar's
front, the kept points' tight box, a centre crop, K1 and a gather), EPMFNet
at batch 1, the amax, argmax and gather lift (no KNN) and the read-backs;
each keyframe through the max-confidence merge of its six items and its IoU
update (no `--save-preds` files).

The window, the latencies, the reservoir of checked keyframes and the
reader that closes the window at a keyframe's first item are
`keyframe_loop.py`'s, which this driver subclasses.

Correct: a sample of the window's keyframes (drawn from the seed) against
the reference: each item's view (features, mask, labels, the points' pixels
and keep flags) bit for bit against `reference/view_v2_item.py`; the merged
classes against the reference merge of the six items' own probabilities
lifted through the reference view's pixels; what the keyframe added to the
IoU accumulator against the confusions of that merge; and the
probabilities against the float32 reference `reference/nets.py: EPMFNet`
by `core.prob_error`.

The loop's counters `kept_points` and `empty_items` (the points the items'
views kept, the items whose view kept none) are read a keyframe over the
profiled keyframes of the traced run (`metrics/kept_points.epmf_keyframe.py`,
`metrics/empty_items.epmf_keyframe.py`); a port whose loop lacks them stops
the set-up.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import core, inputs, keyframes
from benchmark import trace as tr
from benchmark.reference import flops, view_cam, view_v2_item
from benchmark.reference import nets as ref_nets
from benchmark.reference.view import View
from benchmark.traffic import keyframe_loop

CAMERAS = keyframes.CAMERAS


def template(cfg: dict) -> dict:
    with torch.device("meta"):
        return ref_nets.EPMFNet(cfg["nclasses"], cfg["base_channels"]).state_dict()


def pv_group(view: dict) -> dict:
    """The experiment's `PVconfig` group for the configuration's view, with
    its normalization under the yaml's names (`pcd_mean`, `pcd_stds`)."""
    keys = ("canvas_h", "canvas_w", "proj_h", "proj_w", "n_points")
    return dict({k: view[k] for k in keys}, pcd_mean=view["img_mean"],
                pcd_stds=view["img_stds"])


class Cell(keyframe_loop.Cell):
    def __init__(self, wl: dict, seed: int, dev):
        from pmf_tpu_torch.config import Options
        from pmf_tpu_torch.models import build_model
        from pmf_tpu_torch.tools.infer_nuscenes import NuscenesInference

        self.wl, self.cfg, self.seed, self.dev = wl, wl["config_data"], seed, dev
        cfg = self.cfg
        opts = Options(config={"PVconfig": pv_group(cfg["view"])}, dataset="nuScenes",
                       nclasses=cfg["nclasses"], net_type=cfg["net"],
                       compute_dtype=cfg["compute_dtype"], base_channels=cfg["base_channels"],
                       img_backbone=cfg["img_backbone"])
        self.model = build_model(opts).to(dev).eval()
        self.offset = self.next_item = 0
        self.inf = NuscenesInference(opts, self.model, self._read, 1 << 30, dev,
                                     keyframe_loop._Tokens(self))
        if not hasattr(self.inf, "empty_items"):
            raise RuntimeError("NuscenesInference counts no kept points or empty items: the "
                               "port predates the loop's counters this cell reads")
        rv, pv = View.from_dict(cfg["view"]), self.inf.cfg
        if (pv.proj_h, pv.proj_w, pv.fov_left, pv.fov_right) != \
                (rv.proj_h, rv.proj_w, rv.fov_left, rv.fov_right):
            raise RuntimeError(f"the port's eval view {pv} is not the configuration's {rv}")
        self.items = [it for kf in keyframes.pool(seed, wl["pool"], wl["scans"], cfg["nclasses"])
                      for it in kf]
        self.sd = inputs.weights(template(cfg), seed, dev)
        self.model.load_state_dict(self.sd)
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

    def trace(self, seconds: float) -> dict:
        out = self.window(min(seconds, self.wl["trace"]["rate_s"]))
        t = self.wl["trace"]
        waits = tr.host_waits(lambda: self._run(1))
        inf = self.inf
        before = (inf.frames, inf.kept_points, inf.empty_items)
        window = tr.profile(lambda: self._run(t["profiled_keyframes"]), 1)
        frames, kept, empty = (b - a for a, b in
                               zip(before, (inf.frames, inf.kept_points, inf.empty_items)))
        v = self.cfg["view"]
        return {"kind": "keyframe", "spans": {}, "host_waits": waits, "window": window,
                "busy_s": tr.busy_s(window), "window_s": window["wall_s"],
                "calls_per_s": out["eval_scans_per_s"],
                "flops_per_call": CAMERAS * flops.count("EPMFNet", 1, v["proj_h"], v["proj_w"],
                                                        self.cfg["nclasses"],
                                                        self.cfg["base_channels"], False),
                "counters": {"kept_points": kept / max(frames, 1),
                             "empty_items": empty / max(frames, 1)},
                "work": {}, "attempted": out["attempted"]}

    # --- correctness ----------------------------------------------------

    def reference_model(self, fp8: bool = False):
        """The float32 reference EPMFNet (the control with `fp8`), loaded
        with the cell's weights."""
        with torch.device(self.dev):
            model = ref_nets.EPMFNet(self.cfg["nclasses"], self.cfg["base_channels"],
                                     self.cfg["dropout_rate"])
        model.load_state_dict(self.sd)
        return ref_nets.set_fp8(model, fp8).eval()

    def _reference_item(self, s: dict, model, rv: View):
        """An item's reference view and the reference net's probabilities."""
        v = view_v2_item.v2_item(*self._tensors(s), rv)
        with torch.no_grad():
            p = model(v[0][None, ..., :5], v[0][None, ..., 5:8])[0][0]
        return v, p

    def reference_answers(self, fp8: bool) -> dict:
        """`program_answers` of the reference in the program's place (the
        control with `fp8`), on the same keyframes."""
        model = self.reference_model(fp8)
        rv = View.from_dict(self.cfg["view"])
        out = {}
        for slot, k in sorted(self.kept.items()):
            items = self._keyframe(k["keyframe"])
            views, probs = zip(*(self._reference_item(s, model, rv) for s in items))
            merged = view_cam.merge([view_cam.lift(p, *v[3:6]) for v, p in zip(views, probs)])
            out[slot] = (k["keyframe"], list(views), list(probs), merged,
                         view_cam.keyframe_confusion(merged, items[-1]["labels"],
                                                     items[-1]["valid"], self.cfg["nclasses"]))
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
                want, ref = self._reference_item(s, model, rv)
                for a, b in zip(got, want[:6]):
                    mismatch += int((a != b).sum()) if a.shape == b.shape else b.numel()
                lifted.append(view_cam.lift(p, *want[3:6]))
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
