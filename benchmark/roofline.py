"""The card's published peaks, and the work each z-buffer kernel must do
(the port's `utils/timing.py` byte counts, copied): each input read once,
each output written once, whatever the kernel reads again.

A roofline share is the least time the card could take (the larger of
bytes over the memory rate and operations over the float32 rate) over
the kernel's device time, in percent.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_FLOPS = 989e12


def rasterize_work(batch: int, points: int, kept: int, f: int, h: int, w: int):
    """K2's (bytes, operations): rows, cols (int32), depth (f32), keep and
    the f float values of each point read once; the canvas and its mask
    written once; one key a kept point and one store a canvas value."""
    return (batch * points * (4 + 4 + 4 + 1 + 4 * f) + batch * h * w * (4 * f + 1),
            kept + batch * h * w * f)


def keys_work(batch: int, points: int, kept: int, h: int, w: int):
    """K1's (bytes, operations): each point's pixel and key read once, the
    key image written once; one atomic a kept point."""
    return batch * points * 8 + batch * h * w * 4, kept


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def share(work, device_us: float, launches: int) -> float | None:
    """The roofline share in percent of `launches` calls that took
    `device_us` on the device, each doing `work` (bytes, operations); None
    when the kernel did not launch."""
    if not launches or device_us <= 0:
        return None
    return 100.0 * bound_s(*work) / (device_us / 1e6 / launches)
