"""The PMF hybrid optimizer (counterpart of `pmf_tpu/train/optim.py:
hybrid_pmf_optimizer`).

AdamW (betas 0.9/0.999, eps 1e-8, weight decay 0.01) on the lidar stream, any
other top-level module and the `extra` parameters beside the model (EPMF's
multi-task σ); SGD with Nesterov momentum and coupled weight
decay on the two camera streams. torch's AdamW and SGD(nesterov=True)
compute the updates of optax's adamw and add_decayed_weights + sgd chains;
both take their learning rate from one schedule, read at the optimizer's
own step count before each update.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

CAMERA_KEYS = ("camera_stream_encoder", "camera_stream_decoder")


class HybridOptimizer:
    def __init__(self, model: nn.Module, schedule: Callable[[int], float],
                 momentum: float, weight_decay: float, camera_keys=CAMERA_KEYS, extra=()):
        camera, other = [], []
        for name, p in model.named_parameters():
            (camera if name.split(".")[0] in camera_keys else other).append(p)
        other.extend(extra)
        self.schedule = schedule
        self.steps = 0
        self.adamw = torch.optim.AdamW(other, lr=schedule(0), betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=0.01)
        self.sgd = torch.optim.SGD(camera, lr=schedule(0), momentum=momentum,
                                   nesterov=True, weight_decay=weight_decay)

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.steps)

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)
        self.sgd.zero_grad(set_to_none=True)

    def step(self):
        lr = self.lr
        for opt in (self.adamw, self.sgd):
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        self.steps += 1

    def state_dict(self) -> dict:
        return {"steps": self.steps, "adamw": self.adamw.state_dict(),
                "sgd": self.sgd.state_dict()}

    def load_state_dict(self, state: dict):
        self.steps = state["steps"]
        self.adamw.load_state_dict(state["adamw"])
        self.sgd.load_state_dict(state["sgd"])
