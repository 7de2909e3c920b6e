"""The whole SalsaNext train step's share of the card's float32 peak (67 TFLOP/s, outside the tensor cores), in percent: the forward and backward FLOPs of the step counted on the reference (`reference/salsanext.py: count`, `reference/flops.py`'s rules) × steps a second of a plain timed window. The configuration computes in float32 with TF32 off, so the float32 peak is the one it can reach, not the bf16 one of the other cells' `mfu`."""
from benchmark.roofline import F32_OPS_PER_S


def read(t: dict):
    if not t.get("flops_per_call") or not t.get("calls_per_s"):
        return None
    return 100.0 * t["flops_per_call"] * t["calls_per_s"] / F32_OPS_PER_S
