"""EPMF's train step, a closed loop: each step builds the V2 train view of
a batch (`build_v2_batch(train=True)`: random scale, flip, rotation and
crop of the kept points' tight box, ColorJitter and a bilinear RGB; K2
with 64-bit keys above 65535 points) and runs the step of
`make_pmf_train_step` with the loss the trainer builds for EPMF
(`train/trainer.py`): `use_mtloss` on, whose six terms are weighted by
the learned σ (`mt_sigma`, stepped by the AdamW of `HybridOptimizer`
with the lidar stream), and `point_lovasz` off, so Lovász takes the
image domain and the view gives no winner flags (no K1). The draws of
the view and the dropout come from one generator seeded by the seed; the
batches cycle through a pool made from the seed.

Set-up, window and correct are `train_step.py`'s: the reference
(`reference/train_v2.py`) follows the first three steps from the same
weights, σ, inputs and generator state in float32, and redoes one window
step drawn from the seed from the program's state before it: the view bit
for bit (features, mask, labels), and the median leaf's gaps of the first
gradient's and the change's norms, σ counted as one leaf.
"""
from __future__ import annotations

import torch

from benchmark import core, inputs, port
from benchmark import trace as tr
from benchmark.reference import train as ref_pmf
from benchmark.reference import train_v2 as ref_train

base = core.driver("train_step")
FIRST_STEPS = base.FIRST_STEPS
MOMENTS = base.MOMENTS
SIGMA = "mt_sigma"


class Cell(base.Cell):
    e2e = "train_scans_per_s"

    def __init__(self, wl: dict, seed: int, dev):
        from pmf_tpu_torch.data import build_v2_batch
        from pmf_tpu_torch.losses import init_multi_task_params
        from pmf_tpu_torch.train import (HybridOptimizer, LossConfig, make_pmf_train_step,
                                         warmup_cosine_lr)

        self.wl, self.cfg, self.seed, self.dev = wl, wl["config_data"], seed, dev
        s = wl["scans"]
        self.batch = s["batch"]
        self.pool = [inputs.to_device(b, dev)
                     for b in inputs.scan_pool(seed, wl["pool"], s, self.cfg["nclasses"])]
        self.sd = port.make_weights(self.cfg, seed, dev)
        self.model = port.program_model(self.cfg, self.sd, dev, train=True)
        self.sigma = torch.nn.Parameter(init_multi_task_params(ref_train.N_TERMS, dev))
        # the parameters and σ the cell starts from
        self.start = {**{k: self.sd[k] for k, _ in self.model.named_parameters()},
                      SIGMA: self.sigma.detach().clone()}
        o, loss = self.cfg["optimizer"], self.cfg["loss"]
        self.opt = HybridOptimizer(self.model, warmup_cosine_lr(o["lr"], o["warmup_steps"],
                                                                o["total_steps"]),
                                   o["momentum"], o["weight_decay"], extra=[self.sigma])
        self.opt.steps = o["start_step"]
        self.loss_cfg = LossConfig(nclasses=self.cfg["nclasses"], alpha=tuple(loss["alpha"]),
                                   gamma_focal=loss["gamma_focal"], lambda_=loss["lambda"],
                                   gamma=loss["gamma"], tau=loss["tau"], lovasz_ignore=0,
                                   use_mtloss=wl["loss"]["use_mtloss"])
        if wl["loss"]["point_lovasz"]:
            raise ValueError("this driver runs EPMF's image-domain Lovász only")
        self.step = make_pmf_train_step(self.model, self.opt, self.loss_cfg, self.sigma)
        self.vcfg = port.program_view_config(self.cfg)
        self.build = build_v2_batch
        self.g = torch.Generator(device=dev).manual_seed(seed)
        self.g0 = self.g.get_state()
        self.first, self.grad1, self.probe = [], None, None
        for i in range(max(wl["warmup"], FIRST_STEPS)):
            view, aux = self.call(i)
            if i < FIRST_STEPS:
                self.first.append((view, aux["loss"]))
            if i == 0:
                self.grad1 = self._gradient({}, self._moments(), self.start)
            if i == FIRST_STEPS - 1:
                self.theta3 = self._params()
        self.steps_done = max(wl["warmup"], FIRST_STEPS)
        core.sync(dev)

    def call(self, i: int):
        """One train step on the pool's batch i: (view, aux); the view is
        (feature, mask, label, ()) (no winner flags)."""
        with torch.no_grad():
            view = self.build(*self.pool[i % len(self.pool)], self.vcfg, True, self.g)
        return (*view, ()), self.step(view[0], view[2], self.g)

    def _params(self) -> dict:
        return {**super()._params(), SIGMA: self.sigma.detach().clone()}

    def _moments(self) -> dict:
        names = {p: k for k, p in self.model.named_parameters()}
        names[self.sigma] = SIGMA
        return {names[p]: {k: v.detach().clone() for k, v in st.items() if k in MOMENTS}
                for opt in self.opt.optimizers.values() for p, st in opt.state.items()}

    def trace(self, seconds: float) -> dict:
        from benchmark.reference import flops

        out = self.window(min(seconds, self.wl["trace"]["rate_s"]))
        t = self.wl["trace"]
        waits = tr.host_waits(self._next)
        window = tr.profile(self._next, t["profiled_calls"])
        v = self.cfg["view"]
        return {"kind": "train", "spans": {}, "host_waits": waits, "window": window,
                "busy_s": tr.busy_s(window), "window_s": window["wall_s"],
                "calls_per_s": out[self.e2e] / self.batch,
                "flops_per_call": flops.count(self.cfg["net"], self.batch, v["proj_ht"],
                                              v["proj_wt"], self.cfg["nclasses"],
                                              self.cfg["base_channels"], train=True),
                "work": {}, "attempted": out["attempted"]}

    # --- correctness ----------------------------------------------------

    def program_readings(self) -> dict:
        p = self.probe
        norms = lambda d: {k: float(v.norm()) for k, v in d.items()}
        start = self.start
        return {"views": [v for v, _ in self.first] + [p["view"]],
                "losses": [float(loss) for _, loss in self.first],
                "grad": norms(self.grad1),
                "change": {k: float((self.theta3[k] - start[k]).norm()) for k in self.theta3},
                "window": {"grad": norms(self._gradient(p["moments"], p["moments_after"],
                                                        p["theta"])),
                           "change": {k: float((p["theta_after"][k] - t).norm())
                                      for k, t in p["theta"].items()}}}

    def release(self):
        del self.model, self.opt, self.step, self.sigma
        torch.cuda.empty_cache()

    def reference_readings(self, fp8: bool = False, half: bool = False) -> dict:
        """`program_readings` of the reference (with `fp8`, the control; with
        `half`, the fault that steps on the first half of each batch only)."""
        model = port.reference_model(self.cfg, self.sd, self.dev, train=True, fp8=fp8)
        sigma = ref_train.init_sigma(self.dev)
        leaves = lambda: [*model.named_parameters(), (SIGMA, sigma)]
        rv = port.reference_view(self.cfg)
        g = torch.Generator(device=self.dev).set_state(self.g0)
        opt = self._reference_optimizer(model, sigma, 0, {})
        views, losses = [], []
        for i in range(FIRST_STEPS):
            view, loss, grad = self._reference_step(model, sigma, opt, g, i, rv, half)
            if i == 0:
                grad1 = grad
            views.append(view)
            losses.append(loss)
        change = {k: float((t.detach() - self.start[k]).norm()) for k, t in leaves()}
        # the window step, from the program's parameters, σ and moments before it
        p = self.probe
        with torch.no_grad():
            for k, t in leaves():
                t.copy_(p["theta"][k])
        opt = self._reference_optimizer(model, sigma, p["step"], p["moments"])
        g.set_state(p["gen"])
        view, _, grad = self._reference_step(model, sigma, opt, g, p["step"], rv, half)
        views.append(view)
        window = {"grad": grad, "change": {k: float((t.detach() - p["theta"][k]).norm())
                                           for k, t in leaves()}}
        del model, opt
        torch.cuda.empty_cache()
        return {"views": views, "losses": losses, "grad": grad1, "change": change,
                "window": window}

    def _reference_optimizer(self, model, sigma, step: int, moments: dict):
        o = self.cfg["optimizer"]
        opt = ref_train.HybridOptimizer(
            model, sigma, ref_pmf.warmup_cosine(o["lr"], o["warmup_steps"], o["total_steps"]),
            o["momentum"], o["weight_decay"], o["start_step"] + step)
        names = {t: k for k, t in model.named_parameters()}
        names[sigma] = SIGMA
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

    def _reference_step(self, model, sigma, opt, g, i: int, rv, half: bool):
        """The reference's train step on the pool's batch i: (view, loss,
        each leaf's gradient norm, σ's too)."""
        batch = self.pool[i % len(self.pool)]
        if half:
            batch = [t[:self.batch // 2] for t in batch]
        draws = ref_train.train_draws(g, batch[0].shape[0], rv, self.dev)
        view = ref_train.v2_train_batch(*batch, rv, draws)
        opt.zero_grad()
        lidar, cam = model(view[0][..., :5], view[0][..., 5:8], g)
        total, _ = ref_train.epmf_losses(lidar, cam, view[2], sigma, self.cfg["loss"])
        total.backward()
        del lidar, cam
        grad = {k: float(t.grad.norm()) if t.grad is not None else 0.0
                for k, t in [*model.named_parameters(), (SIGMA, sigma)]}
        opt.step()
        return (*view, ()), float(total.detach()), grad
