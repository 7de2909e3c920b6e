"""The whole keyframe's share of the card's bf16 peak (989 TFLOP/s), in percent: a keyframe's FLOPs (six forwards of PMF-ResNet50 at 896x1600, counted on the reference, `reference/nets_r50.py: count`) × keyframes a second of a plain timed window."""
from benchmark.roofline import BF16_FLOPS


def read(t: dict):
    if not t.get("flops_per_call") or not t.get("calls_per_s"):
        return None
    return 100.0 * t["flops_per_call"] * t["calls_per_s"] / BF16_FLOPS
