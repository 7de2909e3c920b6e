"""Learning-rate schedules (counterpart of `pmf_tpu/train/schedules.py`):
step → lr, stepped per iteration, in Python floats (pmf_tpu's are float32;
they agree to its rounding). The first update uses schedule(0), as optax's
count starts at 0, so under warmup it is 0."""
from __future__ import annotations

import math


def warmup_cosine_lr(lr: float, warmup_steps: int, max_steps: int):
    """Linear warmup 0 → `lr` over `warmup_steps`, then cosine anneal to 0
    over `max_steps`, held at 0 after."""
    warmup_steps = max(warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * step / warmup_steps
        t = min(max(step - warmup_steps, 0), max_steps)
        return lr * 0.5 * (1.0 + math.cos(math.pi * t / max(max_steps, 1)))

    return schedule


def warmup_exp_lr(lr: float, warmup_steps: int, decay: float):
    """Linear warmup 0 → `lr`, then lr · decay^(step − warmup_steps)."""
    warmup_steps = max(warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * step / warmup_steps
        return lr * decay ** (step - warmup_steps)

    return schedule


def warmup_multistep_lr(lr: float, warmup_steps: int, milestones, gamma: float = 0.1):
    """Linear warmup, then lr · gamma^(the milestones passed)."""
    warmup_steps = max(warmup_steps, 1)
    milestones = tuple(sorted(milestones))

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * step / warmup_steps
        return lr * gamma ** sum(step >= m for m in milestones)

    return schedule


def clip_lr(schedule, min_lr: float):
    """`schedule` floored at `min_lr`."""
    return lambda step: max(schedule(step), min_lr)
