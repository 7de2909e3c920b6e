"""The whole EPMF train step's share of the card's bf16 peak (989 TFLOP/s), in percent: the forward and backward FLOPs of the step counted on the reference (`reference/flops.py: count("EPMFNet", 2, 320, 1280, ...)`) × steps a second of a plain timed window."""
from benchmark.roofline import BF16_FLOPS


def read(t: dict):
    if not t.get("flops_per_call") or not t.get("calls_per_s"):
        return None
    return 100.0 * t["flops_per_call"] * t["calls_per_s"] / BF16_FLOPS
