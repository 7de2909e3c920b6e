"""Learning-rate schedule (counterpart of `pmf_tpu/train/schedules.py:
warmup_cosine_lr`): step → lr, stepped per iteration. The first update
uses schedule(0), as optax's count starts at 0, so under warmup it is 0."""
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
