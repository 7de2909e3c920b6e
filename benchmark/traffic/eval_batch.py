"""Batched evaluation, a closed loop: each call builds the eval view of a
batch of scans (`build_batch`, or `build_v2_batch` for EPMF: K2), runs the
net under `torch.inference_mode` and takes `argmax_last` of the lidar
stream; the next call starts when the last returns. The batches cycle
through a pool made from the seed.

Window: scans of the calls completed over the window's seconds.
Correct: a sample of the window's calls (drawn from the seed), each
against the reference on the same batch: the view bit for bit (features,
mask, labels); the prediction equal to the argmax of the lidar stream's
probabilities; and those probabilities against the reference's by
`core.prob_error` (their summed gap over the reference's summed distance
from a flat prediction).
"""
from __future__ import annotations

import time

import torch

from benchmark import core, inputs, port
from benchmark import trace as tr
from benchmark.reference import view as ref_view


class Cell:
    e2e = "eval_scans_per_s"

    def __init__(self, wl: dict, seed: int, dev):
        from pmf_tpu_torch.data import build_batch, build_v2_batch
        from pmf_tpu_torch.ops import argmax_last

        self.wl, self.cfg, self.seed, self.dev = wl, wl["config_data"], seed, dev
        s = wl["scans"]
        self.pool = [inputs.to_device(b, dev)
                     for b in inputs.scan_pool(seed, wl["pool"], s, self.cfg["nclasses"])]
        self.batch = s["batch"]
        self.sd = port.make_weights(self.cfg, seed, dev)
        self.model = port.program_model(self.cfg, self.sd, dev, train=False)
        self.vcfg = port.program_view_config(self.cfg)
        self.build = build_v2_batch if self.cfg["net"] == "EPMFNet" else build_batch
        self.argmax = argmax_last
        self.kept = {}
        for i in range(wl["warmup"]):
            self.call(i)
        core.sync(dev)

    def call(self, i: int, spans: tr.Spans | None = None):
        """One call on the pool's batch i: (view, probabilities, prediction)."""
        mark = spans.mark if spans else (lambda _: None)
        with torch.inference_mode():
            view = self.build(*self.pool[i % len(self.pool)], self.vcfg)
            mark("view")
            lidar, _ = self.model(view[0][..., :5], view[0][..., 5:8])
            mark("model")
            pred = self.argmax(lidar)
            mark("argmax")
        return view, lidar, pred

    def window(self, seconds: float) -> dict:
        sample = core.Reservoir(self.wl["checked_calls"], self.seed)
        core.sync(self.dev)
        t0 = time.perf_counter()
        i = 0
        while True:
            out = self.call(i)
            slot = sample.slot()
            if slot is not None:
                self.kept[slot] = (i, out)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        core.sync(self.dev)
        elapsed = time.perf_counter() - t0
        return {self.e2e: core.rate(i * self.batch, elapsed), "attempted": i * self.batch}

    def trace(self, seconds: float) -> dict:
        from benchmark.reference import flops

        out = self.window(min(seconds, self.wl["trace"]["rate_s"]))
        n_spans, n_prof = self.wl["trace"]["span_calls"], self.wl["trace"]["profiled_calls"]
        spans = tr.Spans()
        for i in range(n_spans):
            spans.start()
            self.call(i, spans)
        parts = spans.done()
        waits = tr.host_waits(lambda: self.call(0))
        window = tr.profile(lambda: self.call(0), n_prof)
        v = self.cfg["view"]
        kept = int(self._reference_keep().sum())
        return {"kind": "eval", "spans": parts, "host_waits": waits, "window": window,
                "busy_s": tr.busy_s(window), "window_s": window["wall_s"],
                "calls_per_s": out[self.e2e] / self.batch,
                "flops_per_call": flops.count(self.cfg["net"], self.batch, v["proj_h"],
                                              v["proj_w"], self.cfg["nclasses"],
                                              self.cfg["base_channels"], train=False),
                "work": {"rasterize": (self.batch, self.wl["scans"]["points"], kept, 6,
                                       v["proj_h"], v["proj_w"])},
                "attempted": out["attempted"]}

    def _reference_keep(self):
        """The reference's kept points of the pool's first batch."""
        rv = port.reference_view(self.cfg)
        b = self.pool[0]
        if self.cfg["net"] == "EPMFNet":
            return ref_view.v2_eval_view(b[0], b[2], b[3], b[4], b[5], b[6], rv)[2]
        rows, cols, keep = ref_view.kitti_project(b[0], b[3], b[5], b[6], b[2])
        return ref_view.eval_view(rows, cols, keep, b[4], b[5], b[6], rv)[2]

    # --- correctness ----------------------------------------------------

    def release(self):
        """Free the program's state; what the window produced is kept."""
        del self.model
        torch.cuda.empty_cache()

    def reference_outputs(self, fp8: bool) -> dict:
        """The reference in the program's place on the sampled calls' batches
        (the control with `fp8`)."""
        model = port.reference_model(self.cfg, self.sd, self.dev, train=False, fp8=fp8)
        rv = port.reference_view(self.cfg)
        out = {}
        for slot, (i, _) in self.kept.items():
            view = self._ref_view(i, rv)
            with torch.no_grad():
                probs, _ = model(view[0][..., :5], view[0][..., 5:8])
            out[slot] = (i, (view, probs, probs.argmax(-1).to(torch.int32)))
        return out

    def _ref_view(self, i: int, rv):
        b = self.pool[i % len(self.pool)]
        build = ref_view.v2_batch if self.cfg["net"] == "EPMFNet" else ref_view.pv_batch
        return build(*b, rv)

    def compare(self, kept: dict) -> dict:
        """The compared numbers of the answers `kept` ({slot: (call, (view,
        probabilities, prediction))}) against the float32 reference."""
        model = port.reference_model(self.cfg, self.sd, self.dev, train=False)
        rv = port.reference_view(self.cfg)
        mismatch, wrong, err, scale = 0, 0, 0.0, 0.0
        for _, (i, (view, probs, pred)) in sorted(kept.items()):
            want = self._ref_view(i, rv)
            mismatch += sum(int((a != b).sum()) for a, b in zip(view, want))
            wrong += int((pred.long() != probs.argmax(-1)).sum())
            with torch.no_grad():
                ref, _ = model(want[0][..., :5], want[0][..., 5:8])
            e, s = core.prob_error(probs, ref)
            err, scale = err + e, scale + s
            del ref
        return {"view_mismatch": mismatch, "argmax_mismatch": wrong, "prob_err": err / scale}

    def check(self) -> dict:
        self.release()
        return self.compare(self.kept)
