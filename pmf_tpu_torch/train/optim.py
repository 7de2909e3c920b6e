"""Optimizers (counterpart of `pmf_tpu/train/optim.py`).

`HybridOptimizer`, PMF's: AdamW (betas 0.9/0.999, eps 1e-8, weight decay
0.01) on the lidar stream, any other top-level module and the `extra`
parameters beside the model (EPMF's multi-task σ); SGD with Nesterov
momentum and coupled weight decay on the two camera streams; with
`amsgrad` (SensatUrban) the AdamW group is `AMSGradW`. `adamw`,
SalsaNext's: the same AdamW on every parameter. torch's AdamW and
SGD(nesterov=True) compute the updates of optax's adamw and
add_decayed_weights + sgd chains; each takes its learning rate from one
schedule, read at the optimizer's own step count before each update.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

CAMERA_KEYS = ("camera_stream_encoder", "camera_stream_decoder")


def _adamw(params, lr: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)


class AMSGradW(torch.optim.Optimizer):
    """AdamW with AMSGrad as optax's chain scale_by_amsgrad →
    add_decayed_weights(weight_decay) → scale_by_learning_rate computes it:
    μ and ν are Adam's moments, ν̂ = ν / (1 - β2^t) their bias-corrected
    second moment, and the step divides μ / (1 - β1^t) by
    sqrt(max over steps of ν̂) + eps, then adds weight_decay · p, all times
    -lr. (torch's AdamW(amsgrad=True) keeps the maximum of the raw ν and
    bias-corrects that with the current step: another update.)"""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            (b1, b2), eps = group["betas"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    for k in ("mu", "nu", "nu_max"):
                        state[k] = torch.zeros_like(p)
                state["step"] += 1
                t, g = state["step"], p.grad
                mu = state["mu"].mul_(b1).add_(g, alpha=1 - b1)
                nu = state["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
                nu_max = torch.maximum(state["nu_max"], nu / (1 - b2 ** t),
                                       out=state["nu_max"])
                update = (mu / (1 - b1 ** t)) / (nu_max.sqrt() + eps)
                p.add_(update + group["weight_decay"] * p, alpha=-group["lr"])


class ScheduledOptimizer:
    """torch optimizers stepped together, their learning rate set from
    `schedule` at each update; the state of all of them is one dict."""

    def __init__(self, schedule: Callable[[int], float], optimizers: dict):
        self.schedule = schedule
        self.steps = 0
        self.optimizers = optimizers

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.steps)

    def zero_grad(self):
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=True)

    def step(self):
        lr = self.lr
        for opt in self.optimizers.values():
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        self.steps += 1

    def state_dict(self) -> dict:
        return {"steps": self.steps,
                **{name: opt.state_dict() for name, opt in self.optimizers.items()}}

    def load_state_dict(self, state: dict):
        self.steps = state["steps"]
        for name, opt in self.optimizers.items():
            opt.load_state_dict(state[name])


class HybridOptimizer(ScheduledOptimizer):
    def __init__(self, model: nn.Module, schedule: Callable[[int], float],
                 momentum: float, weight_decay: float, camera_keys=CAMERA_KEYS, extra=(),
                 amsgrad: bool = False):
        camera, other = [], []
        for name, p in model.named_parameters():
            (camera if name.split(".")[0] in camera_keys else other).append(p)
        other.extend(extra)
        super().__init__(schedule, {
            "adamw": (AMSGradW if amsgrad else _adamw)(other, schedule(0)),
            "sgd": torch.optim.SGD(camera, lr=schedule(0), momentum=momentum, nesterov=True,
                                   weight_decay=weight_decay)})


def adamw(model: nn.Module, schedule: Callable[[int], float]) -> ScheduledOptimizer:
    """AdamW on every parameter of `model`, weight decay 0.01 (not the
    config's `weight_decay`), as pmf_tpu's trainer gives SalsaNext."""
    return ScheduledOptimizer(schedule, {"adamw": _adamw(model.parameters(), schedule(0))})
