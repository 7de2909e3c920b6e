"""Argmax over the last axis (counterpart of `pmf_tpu/ops/reduce.py`)."""
from __future__ import annotations

import torch


def argmax_last(x: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis as a max followed by a masked min: the first
    maximum wins ties, and a row holding NaN gives C-1 (its max is NaN, which
    equals nothing), where `torch.argmax` would return the NaN's position.
    Returns int32."""
    c = x.shape[-1]
    m = x.amax(dim=-1, keepdim=True)
    iota = torch.arange(c, dtype=torch.int32, device=x.device)
    out = torch.where(x == m, iota, c).amin(dim=-1)
    return out.clamp(max=c - 1).to(torch.int32)
