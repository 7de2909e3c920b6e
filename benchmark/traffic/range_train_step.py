"""SalsaNext's train step on the range view, a closed loop, as
`train/trainer.py` runs it for `net_type: SalsaNext`: each step builds the
train view of a batch (`build_range_batch(train=True)`: the 3D point
augmentation, `spherical_project`, K1 through `zbuffer_scatter_packed`,
the fill and the normalization) and runs the step of
`make_salsanext_train_step` (forward in train mode, focal + λ·Lovász,
backward, `adamw`) on a `SalsaNext` as `build_model` builds it, float32
with TF32 off. The draws of the view and the dropout come from one
generator seeded by the seed; the batches cycle through a pool made from
the seed.

Set-up, window and correct are `train_step.py`'s: the reference
(`reference/salsanext.py`, `reference/view_range.py`) follows the first
three steps from the same weights, inputs and generator state in float32,
and redoes one window step drawn from the seed from the program's
parameters and AdamW moments before it: the view bit for bit (features,
label, mask), and the median leaf's gaps of the first gradient's and the
change's norms.

Scans (the port's `data/synthetic.py: make_range_inputs`, copied): the
returns of a 64-beam sensor all around it at 2-80 m and pitch −26° to 4°
(a little beyond the 3°/−25° field of view), a tenth of them copies of
others (ties in the z-buffer), the first `valid` of each scan valid and the
rest padding; uniform train-class labels.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import core, inputs
from benchmark import trace as tr
from benchmark.reference import salsanext as ref_net
from benchmark.reference import train as ref_train
from benchmark.reference import view_range as ref_view

base = core.driver("train_step")
FIRST_STEPS = base.FIRST_STEPS


def scans(rng: np.random.Generator, batch: int, points: int, valid: int, nclasses: int):
    """(points [B, N, 4], labels [B, N], valid [B, N]) as numpy arrays."""
    r = rng.uniform(2, 80, (batch, points))
    yaw = rng.uniform(-np.pi, np.pi, (batch, points))
    pitch = np.deg2rad(rng.uniform(-26, 4, (batch, points)))
    pts = np.stack([r * np.cos(pitch) * np.cos(yaw), r * np.cos(pitch) * np.sin(yaw),
                    r * np.sin(pitch), rng.uniform(0, 1, (batch, points))], -1).astype(np.float32)
    pts[:, points // 2:points // 2 + points // 10] = pts[:, :points // 10]
    labels = rng.integers(0, nclasses, (batch, points)).astype(np.int32)
    ok = np.zeros((batch, points), bool)
    ok[:, :valid] = True
    return pts, labels, ok


def scan_pool(seed: int, n: int, group: dict, nclasses: int) -> list[tuple]:
    """`n` batches of the cell's `scans` group from `seed`, as numpy."""
    rng = np.random.default_rng(seed)
    return [scans(rng, group["batch"], group["points"], group["valid"], nclasses)
            for _ in range(n)]


def options(cfg: dict):
    """The port's Options of the configuration, as the yaml gives them."""
    from pmf_tpu_torch.config import Options

    v = cfg["view"]
    sensor = {k: v[k] for k in ("proj_h", "proj_w", "fov_up", "fov_down", "fov_left",
                                "fov_right", "n_points", "img_mean", "img_stds")}
    return Options(config={"sensor": sensor, "augmentation": cfg["augmentation"]},
                   net_type=cfg["net"], nclasses=cfg["nclasses"],
                   base_channels=cfg["base_channels"], compute_dtype=cfg["compute_dtype"],
                   lr=cfg["optimizer"]["lr"], lambda_=cfg["loss"]["lambda"],
                   gamma=cfg["loss"]["gamma"], tau=cfg["loss"]["tau"])


def template(cfg: dict) -> dict:
    with torch.device("meta"):
        return ref_net.SalsaNext(cfg["nclasses"], cfg["base_channels"], cfg["dropout_rate"],
                                 cfg["in_channels"]).state_dict()


class Cell(base.Cell):
    e2e = "train_scans_per_s"

    def __init__(self, wl: dict, seed: int, dev):
        from pmf_tpu_torch.data import build_range_batch, range_config
        from pmf_tpu_torch.models import build_model
        from pmf_tpu_torch.train import (LossConfig, adamw, make_salsanext_train_step,
                                         warmup_cosine_lr)

        self.wl, self.cfg, self.seed, self.dev = wl, wl["config_data"], seed, dev
        s = wl["scans"]
        self.batch = s["batch"]
        self.pool = [inputs.to_device(b, dev)
                     for b in scan_pool(seed, wl["pool"], s, self.cfg["nclasses"])]
        opts = options(self.cfg)
        self.sd = inputs.weights(template(self.cfg), seed, dev)
        self.model = build_model(opts).to(dev)
        self.model.load_state_dict(self.sd)
        self.model.train()
        o, loss = self.cfg["optimizer"], self.cfg["loss"]
        self.opt = adamw(self.model, warmup_cosine_lr(o["lr"], o["warmup_steps"],
                                                      o["total_steps"]))
        self.opt.steps = o["start_step"]
        self.loss_cfg = LossConfig(nclasses=opts.nclasses, alpha=tuple(loss["alpha"]),
                                   gamma_focal=loss["gamma_focal"], lambda_=opts.lambda_,
                                   gamma=opts.gamma, tau=opts.tau)
        self.step = make_salsanext_train_step(self.model, self.opt, self.loss_cfg)
        self.vcfg = range_config(opts)
        self.build = build_range_batch
        self.g = torch.Generator(device=dev).manual_seed(seed)
        self.g0 = self.g.get_state()
        self.first, self.grad1, self.probe = [], None, None
        for i in range(max(wl["warmup"], FIRST_STEPS)):
            view, aux = self.call(i)
            if i < FIRST_STEPS:
                self.first.append((view, aux["loss"]))
            if i == 0:
                start = {k: self.sd[k] for k, _ in self.model.named_parameters()}
                self.grad1 = self._gradient({}, self._moments(), start)
            if i == FIRST_STEPS - 1:
                self.theta3 = self._params()
        self.steps_done = max(wl["warmup"], FIRST_STEPS)
        core.sync(dev)

    def call(self, i: int):
        """One train step on the pool's batch i: (view, aux); the view is
        (feature, label, mask, ()) (no winner flags)."""
        with torch.no_grad():
            view = self.build(*self.pool[i % len(self.pool)], self.vcfg, True, self.g)
        return (*view, ()), self.step(view[0], view[1], self.g)

    def _gradient(self, before: dict, after: dict, theta: dict) -> dict:
        """Each leaf's gradient as AdamW got it in one step, from its first
        moments before and after it: (m' − β1·m) / (1 − β1)."""
        b1 = self.opt.optimizers["adamw"].param_groups[0]["betas"][0]
        return {k: (after[k]["exp_avg"] - b1 * before.get(k, {}).get("exp_avg", 0.0)) / (1 - b1)
                if "exp_avg" in after.get(k, {}) else torch.zeros_like(t)
                for k, t in theta.items()}

    def trace(self, seconds: float) -> dict:
        """A short timed window (the rate), one step under torch's sync
        debug mode and `profiled_calls` steps under torch.profiler, with the
        step's FLOPs on the reference and K1's work."""
        out = self.window(min(seconds, self.wl["trace"]["rate_s"]))
        waits = tr.host_waits(self._next)
        window = tr.profile(self._next, self.wl["trace"]["profiled_calls"])
        v, s = self.cfg["view"], self.wl["scans"]
        kept = int(self.pool[0][2].sum())
        return {"kind": "train", "spans": {}, "host_waits": waits, "window": window,
                "busy_s": tr.busy_s(window), "window_s": window["wall_s"],
                "calls_per_s": out[self.e2e] / self.batch,
                "flops_per_call": ref_net.count(self.batch, v["proj_h"], v["proj_w"],
                                                self.cfg["nclasses"], self.cfg["base_channels"]),
                "work": {"zbuffer_keys": (self.batch, s["points"], kept, v["proj_h"],
                                          v["proj_w"])},
                "attempted": out["attempted"]}

    # --- correctness ----------------------------------------------------

    def reference_readings(self, bf16: bool = False, half: bool = False) -> dict:
        """`program_readings` of the reference (with `bf16`, the control; with
        `half`, the fault that steps on the first half of each batch only)."""
        model = self._reference_model(bf16)
        view = ref_view.RangeView.from_config(self.cfg)
        g = torch.Generator(device=self.dev).set_state(self.g0)
        opt = self._reference_optimizer(model, 0, {})
        views, losses = [], []
        for i in range(FIRST_STEPS):
            v, loss, grad = self._reference_step(model, opt, g, i, view, half)
            if i == 0:
                grad1 = grad
            views.append(v)
            losses.append(loss)
        change = {k: float((t.detach() - self.sd[k]).norm()) for k, t in model.named_parameters()}
        # the window step, from the program's parameters and moments before it
        p = self.probe
        with torch.no_grad():
            for k, t in model.named_parameters():
                t.copy_(p["theta"][k])
        opt = self._reference_optimizer(model, p["step"], p["moments"])
        g.set_state(p["gen"])
        v, _, grad = self._reference_step(model, opt, g, p["step"], view, half)
        views.append(v)
        window = {"grad": grad, "change": {k: float((t.detach() - p["theta"][k]).norm())
                                           for k, t in model.named_parameters()}}
        del model, opt
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return {"views": views, "losses": losses, "grad": grad1, "change": change,
                "window": window}

    def _reference_model(self, bf16: bool = False):
        """The reference net in float32 (the control with `bf16`), loaded
        with the cell's weights, in train mode."""
        c = self.cfg
        with torch.device(self.dev):
            model = ref_net.SalsaNext(c["nclasses"], c["base_channels"], c["dropout_rate"],
                                      c["in_channels"])
        model.load_state_dict(self.sd)
        if bf16:
            ref_net.set_bf16(model)
        return model.train()

    def _reference_optimizer(self, model, step: int, moments: dict):
        """The reference's AdamW at step `step` (counted from the cell's
        start), with `moments` as each leaf's state."""
        o = self.cfg["optimizer"]
        opt = ref_net.AdamW(model, ref_train.warmup_cosine(o["lr"], o["warmup_steps"],
                                                               o["total_steps"]),
                            o["start_step"] + step)
        for k, t in model.named_parameters():
            m = moments.get(k)
            if m:
                opt.opt.state[t] = {**{n: v.clone() for n, v in m.items()},
                                    "step": torch.tensor(float(step))}
        return opt

    def _reference_step(self, model, opt, g, i: int, view, half: bool):
        """The reference's train step on the pool's batch i: (view, loss,
        each leaf's gradient norm)."""
        batch = self.pool[i % len(self.pool)]
        if half:
            batch = [t[:self.batch // 2] for t in batch]
        u = ref_view.draws(g, batch[0].shape[0], self.dev)
        feature, label, mask = ref_view.range_batch(*batch, view, u)
        loss, grad = ref_net.train_step(model, opt, feature, label, g, self.cfg["loss"])
        return (feature, label, mask, ()), loss, grad
