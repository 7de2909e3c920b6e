"""The PMF train step, a closed loop: each step builds the train view of a
batch (`build_batch(train=True, return_points=True)`: flip, rotation,
crop, ColorJitter; K2, then K1's winner flags) and runs the step of
`make_pmf_train_step` (forward in train mode, the losses, backward,
`HybridOptimizer`), the draws of both from one generator seeded by the
seed. The batches cycle through a pool made from the seed, so consecutive
steps see different scans.

Set-up builds the one model, optimizer and step, and drives them through
their first three steps with the window's own call and feed; the window
goes on with the same objects. Window: scans of the steps completed over
the window's seconds.

Correct: the reference follows the first three steps from the same
weights, inputs and generator state in float32: the step's view bit for
bit (features, mask, labels and the points' pixel, label and winner flag);
the first gradient as the optimizer got it (worked out from its state
after one step: AdamW's first moment / (1 - β1), SGD's momentum buffer
less the decay), by the median leaf's gap of norms; and each leaf's change
after the three steps, by the median leaf's gap of norms, leaving out
leaves whose reference gradient is under a thousandth of the median
leaf's (a bias just before a BN, whose gradient is nought but for
rounding, moves under AdamW by its rounding). A leaf's gap is measured
against the larger of its reference norm and the median leaf's. The
median, not the worst leaf, and not the loss: PERF.md §4 gives the
readings and why.

One step of the window, drawn from the seed (reservoir sampling), is
redone too: the window keeps the parameters, the optimizer's moments and
the generator's state just before it, and its view, parameters and
moments just after. The reference takes the parameters and moments (the
program's own state: following every step of the window would cost more
than the window), counts the step itself, and redoes the step in float32
from that state: the view bit for bit, the step's gradient (from the
moments before and after) and each leaf's change, by the same median
gaps.
"""
from __future__ import annotations

import statistics
import time

import torch

from benchmark import core, inputs, port
from benchmark import trace as tr
from benchmark.reference import train as ref_train
from benchmark.reference import view as ref_view

FIRST_STEPS = 3
NEGLIGIBLE_GRAD = 1e-3   # of the median leaf's reference gradient norm
MOMENTS = ("exp_avg", "exp_avg_sq", "momentum_buffer")   # torch's AdamW's and SGD's


class Cell:
    e2e = "train_scans_per_s"

    def __init__(self, wl: dict, seed: int, dev):
        from pmf_tpu_torch.data import build_batch
        from pmf_tpu_torch.train import (HybridOptimizer, LossConfig, make_pmf_train_step,
                                         warmup_cosine_lr)

        self.wl, self.cfg, self.seed, self.dev = wl, wl["config_data"], seed, dev
        s = wl["scans"]
        self.batch = s["batch"]
        self.pool = [inputs.to_device(b, dev)
                     for b in inputs.scan_pool(seed, wl["pool"], s, self.cfg["nclasses"])]
        self.sd = port.make_weights(self.cfg, seed, dev)
        self.model = port.program_model(self.cfg, self.sd, dev, train=True)
        o, loss = self.cfg["optimizer"], self.cfg["loss"]
        self.opt = HybridOptimizer(self.model, warmup_cosine_lr(o["lr"], o["warmup_steps"],
                                                                o["total_steps"]),
                                   o["momentum"], o["weight_decay"])
        self.opt.steps = o["start_step"]
        self.loss_cfg = LossConfig(nclasses=self.cfg["nclasses"], alpha=tuple(loss["alpha"]),
                                   gamma_focal=loss["gamma_focal"], lambda_=loss["lambda"],
                                   gamma=loss["gamma"], tau=loss["tau"], lovasz_ignore=0)
        self.step = make_pmf_train_step(self.model, self.opt, self.loss_cfg)
        self.vcfg = port.program_view_config(self.cfg)
        self.build = build_batch
        self.g = torch.Generator(device=dev).manual_seed(seed)
        self.g0 = self.g.get_state()
        self.first, self.grad1, self.probe = [], None, None
        for i in range(max(wl["warmup"], FIRST_STEPS)):
            view, aux = self.call(i)
            if i < FIRST_STEPS:
                self.first.append((view, aux["loss"]))
            if i == 0:
                self.grad1 = self._gradient({}, self._moments(),
                                            {k: self.sd[k] for k, _ in self.model.named_parameters()})
            if i == FIRST_STEPS - 1:
                self.theta3 = self._params()
        self.steps_done = max(wl["warmup"], FIRST_STEPS)
        core.sync(dev)

    def call(self, i: int):
        """One train step on the pool's batch i: (view, aux)."""
        with torch.no_grad():
            view = self.build(*self.pool[i % len(self.pool)], self.vcfg, True, self.g,
                              return_points=True)
        return view, self.step(view[0], view[2], self.g, view[3])

    def split_call(self, i: int, spans: tr.Spans):
        """`call` with its parts timed: a copy of make_pmf_train_step's
        order (view, forward, losses, backward with average_gradients, the
        optimizer, the confusion matrices)."""
        from pmf_tpu_torch.parallel import average_gradients
        from pmf_tpu_torch.train import pmf_losses
        from pmf_tpu_torch.train.steps import global_confusion

        with torch.no_grad():
            f, _, lab, pts = self.build(*self.pool[i % len(self.pool)], self.vcfg, True, self.g,
                                        return_points=True)
        spans.mark("view")
        self.model.train()
        self.opt.zero_grad()
        lidar, cam = self.model(f[..., 0:5], f[..., 5:8], self.g)
        spans.mark("forward")
        total, _ = pmf_losses(lidar, cam, lab, self.loss_cfg, pts)
        spans.mark("loss")
        total.backward()
        average_gradients(self.model.parameters())
        spans.mark("backward")
        self.opt.step()
        spans.mark("optimizer")
        with torch.no_grad():
            for p in (lidar, cam):
                global_confusion(p, lab, self.cfg["nclasses"])
        spans.mark("confusion")

    def _params(self) -> dict:
        return {k: p.detach().clone() for k, p in self.model.named_parameters()}

    def _moments(self) -> dict:
        """A copy of the optimizer's moments of each leaf that has them."""
        names = {p: k for k, p in self.model.named_parameters()}
        return {names[p]: {k: v.detach().clone() for k, v in st.items() if k in MOMENTS}
                for opt in self.opt.optimizers.values() for p, st in opt.state.items()}

    def _gradient(self, before: dict, after: dict, theta: dict) -> dict:
        """Each leaf's gradient as the optimizer got it in one step, from its
        moments before and after the step and the parameters before it:
        AdamW's (m' − β1·m) / (1 − β1), SGD's b' − μ·b less the decay wd·θ."""
        b1 = self.opt.optimizers["adamw"].param_groups[0]["betas"][0]
        sgd = self.opt.optimizers["sgd"].param_groups[0]
        out = {}
        for k, t in theta.items():
            m, m0 = after.get(k, {}), before.get(k, {})
            if "exp_avg" in m:
                out[k] = (m["exp_avg"] - b1 * m0.get("exp_avg", 0.0)) / (1 - b1)
            elif "momentum_buffer" in m:
                out[k] = (m["momentum_buffer"] - sgd["momentum"] * m0.get("momentum_buffer", 0.0)
                          - sgd["weight_decay"] * t)
            else:       # a leaf the optimizer never got a gradient for
                out[k] = torch.zeros_like(t)
        return out

    def _probe(self, i: int) -> None:
        """Step i, with what the reference needs to redo it kept: the
        generator's state, parameters and moments before the step; its view,
        parameters and moments after it."""
        self.probe = None
        before = {"step": i, "gen": self.g.get_state(), "theta": self._params(),
                  "moments": self._moments()}
        view, _ = self.call(i)
        self.probe = {**before, "view": view, "theta_after": self._params(),
                      "moments_after": self._moments()}

    def window(self, seconds: float) -> dict:
        pick = core.Reservoir(1, self.seed)     # the window step the reference redoes
        core.sync(self.dev)
        t0 = time.perf_counter()
        i = self.steps_done
        while True:
            if pick.slot() == 0:
                self._probe(i)
            else:
                self.call(i)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        core.sync(self.dev)
        elapsed = time.perf_counter() - t0
        n = i - self.steps_done
        self.steps_done = i
        return {self.e2e: core.rate(n * self.batch, elapsed), "attempted": n * self.batch}

    def trace(self, seconds: float) -> dict:
        from benchmark.reference import flops

        out = self.window(min(seconds, self.wl["trace"]["rate_s"]))
        t = self.wl["trace"]
        spans = tr.Spans()
        for _ in range(t["span_calls"]):
            spans.start()
            self.split_call(self.steps_done, spans)
            self.steps_done += 1
        parts = spans.done()
        waits = tr.host_waits(self._next)
        window = tr.profile(self._next, t["profiled_calls"])
        v = self.cfg["view"]
        kept = int(self._reference_keep().sum())
        n = self.wl["scans"]["points"]
        return {"kind": "train", "spans": parts, "host_waits": waits, "window": window,
                "busy_s": tr.busy_s(window), "window_s": window["wall_s"],
                "calls_per_s": out[self.e2e] / self.batch,
                "flops_per_call": flops.count(self.cfg["net"], self.batch, v["proj_ht"],
                                              v["proj_wt"], self.cfg["nclasses"],
                                              self.cfg["base_channels"], train=True),
                "work": {"rasterize": (self.batch, n, kept, 6, v["proj_ht"], v["proj_wt"]),
                         "zbuffer_keys": (self.batch, n, kept, v["proj_ht"], v["proj_wt"])},
                "attempted": out["attempted"]}

    def _next(self):
        self.call(self.steps_done)
        self.steps_done += 1

    def _reference_keep(self):
        """The kept points of the first step's train view, by the reference."""
        rv = port.reference_view(self.cfg)
        g = torch.Generator(device=self.dev).set_state(self.g0)
        draws = ref_view.train_draws(g, self.batch, rv, self.dev)
        b = self.pool[0]
        rows, cols, keep = ref_view.kitti_project(b[0], b[3], b[5], b[6], b[2])
        return ref_view.train_view(rows, cols, keep, b[4], b[5], b[6], rv, draws)[2]

    # --- correctness ----------------------------------------------------

    def program_readings(self) -> dict:
        """The first three steps' views and losses, the first gradient's norm
        and the change after three steps of each leaf; the window step's
        view, and its gradient's and change's norms."""
        p = self.probe
        norms = lambda d: {k: float(v.norm()) for k, v in d.items()}
        return {"views": [v for v, _ in self.first] + [p["view"]],
                "losses": [float(loss) for _, loss in self.first],
                "grad": norms(self.grad1),
                "change": {k: float((self.theta3[k] - self.sd[k]).norm()) for k in self.theta3},
                "window": {"grad": norms(self._gradient(p["moments"], p["moments_after"],
                                                        p["theta"])),
                           "change": {k: float((p["theta_after"][k] - t).norm())
                                      for k, t in p["theta"].items()}}}

    def release(self):
        del self.model, self.opt, self.step
        torch.cuda.empty_cache()

    def reference_readings(self, fp8: bool = False, half: bool = False) -> dict:
        """`program_readings` of the reference (with `fp8`, the control; with
        `half`, the fault that steps on the first half of each batch only)."""
        model = port.reference_model(self.cfg, self.sd, self.dev, train=True, fp8=fp8)
        rv = port.reference_view(self.cfg)
        g = torch.Generator(device=self.dev).set_state(self.g0)
        opt = self._reference_optimizer(model, 0, {})
        views, losses = [], []
        for i in range(FIRST_STEPS):
            view, loss, grad = self._reference_step(model, opt, g, i, rv, half)
            if i == 0:
                grad1 = grad
            views.append(view)
            losses.append(loss)
        change = {k: float((t.detach() - self.sd[k]).norm()) for k, t in model.named_parameters()}
        # the window step, from the program's parameters and moments before it
        p = self.probe
        with torch.no_grad():
            for k, t in model.named_parameters():
                t.copy_(p["theta"][k])
        opt = self._reference_optimizer(model, p["step"], p["moments"])
        g.set_state(p["gen"])
        view, _, grad = self._reference_step(model, opt, g, p["step"], rv, half)
        views.append(view)
        window = {"grad": grad, "change": {k: float((t.detach() - p["theta"][k]).norm())
                                           for k, t in model.named_parameters()}}
        del model, opt
        torch.cuda.empty_cache()
        return {"views": views, "losses": losses, "grad": grad1, "change": change,
                "window": window}

    def _reference_optimizer(self, model, step: int, moments: dict):
        """The reference's optimizer at step `step` (counted from the cell's
        start), with `moments` as each leaf's state."""
        o = self.cfg["optimizer"]
        opt = ref_train.HybridOptimizer(
            model, ref_train.warmup_cosine(o["lr"], o["warmup_steps"], o["total_steps"]),
            o["momentum"], o["weight_decay"], o["start_step"] + step)
        names = {t: k for k, t in model.named_parameters()}
        for torch_opt in opt.optimizers:
            for group in torch_opt.param_groups:
                for t in group["params"]:
                    m = moments.get(names[t])
                    if m:
                        st = {k: v.clone() for k, v in m.items()}
                        if "exp_avg" in st:
                            st["step"] = torch.tensor(float(step))
                        torch_opt.state[t] = st
        return opt

    def _reference_step(self, model, opt, g, i: int, rv, half: bool):
        """The reference's train step on the pool's batch i: (view, loss,
        each leaf's gradient norm)."""
        batch = self.pool[i % len(self.pool)]
        if half:
            batch = [t[:self.batch // 2] for t in batch]
        draws = ref_view.train_draws(g, batch[0].shape[0], rv, self.dev)
        view = ref_view.pv_batch(*batch, rv, draws, return_points=True)
        opt.zero_grad()
        lidar, cam = model(view[0][..., :5], view[0][..., 5:8], g)
        total, _ = ref_train.pmf_losses(lidar, cam, view[2], view[3], self.cfg["loss"])
        total.backward()
        del lidar, cam
        grad = {k: float(t.grad.norm()) if t.grad is not None else 0.0
                for k, t in model.named_parameters()}
        opt.step()
        return view, float(total.detach()), grad

    @staticmethod
    def compare(got: dict, want: dict) -> dict:
        """The compared numbers: the views' elements that differ; the median
        leaf's gap of first-gradient norms; the median moved leaf's gap of
        change norms (`core.leaf_gaps`); the same two of the window step."""
        mismatch = 0
        for a, b in zip(got["views"], want["views"]):
            for x, y in zip([*a[:3], *a[3]], [*b[:3], *b[3]]):
                mismatch += int((x != y).sum()) if x.shape == y.shape else y.numel()
        gw, ww = got["window"], want["window"]
        return {"view_mismatch": mismatch,
                "grad_gap_median": _median(Cell.grad_gaps(got, want)),
                "change_gap_median": _median(Cell.change_gaps(got, want)),
                "window_grad_gap_median": _median(Cell.grad_gaps(gw, ww)),
                "window_change_gap_median": _median(Cell.change_gaps(gw, ww))}

    @staticmethod
    def grad_gaps(got: dict, want: dict) -> list:
        return core.leaf_gaps(got["grad"], want["grad"], list(want["grad"]))

    @staticmethod
    def change_gaps(got: dict, want: dict) -> list:
        """The gaps of the leaves whose reference gradient is not nought to
        rounding."""
        median = statistics.median(want["grad"].values())
        moved = [k for k, v in want["grad"].items() if v >= NEGLIGIBLE_GRAD * median]
        return core.leaf_gaps(got["change"], want["change"], moved)

    @staticmethod
    def details(got: dict, want: dict) -> dict:
        """Readings that are not compared (PERF.md §4 gives why): each
        step's loss by the largest relative gap, and the worst leaves."""
        gw, ww = got["window"], want["window"]
        return {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(got["losses"], want["losses"])),
                "grad_worst": Cell.grad_gaps(got, want)[:3],
                "change_worst": Cell.change_gaps(got, want)[:3],
                "window_grad_worst": Cell.grad_gaps(gw, ww)[:3],
                "window_change_worst": Cell.change_gaps(gw, ww)[:3]}

    def check(self) -> dict:
        got = self.program_readings()
        self.release()
        return self.compare(got, self.reference_readings())


def _median(gaps: list) -> float:
    """The median leaf's gap of `core.leaf_gaps`' list (largest first)."""
    return gaps[len(gaps) // 2][0]
