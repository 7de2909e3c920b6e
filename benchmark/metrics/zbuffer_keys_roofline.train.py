"""K1's (`ops/scatter.py: point_winner_flags` → `csrc/zbuffer_keys.cu`) share of its roofline for the train batch's winner flags, in percent: the bound of the bytes it must move (`roofline.keys_work`) over its device time a launch in the profiler window.

A kernel that did not launch in the traced calls reads nothing."""
from benchmark import roofline, trace

KERNELS = ['(anonymous namespace)::zbuffer_keys_kernel(']   # trace names start so; the first counts launches
MEMSET_BEFORE = None


def read(t: dict):
    work = t.get("work", {}).get('zbuffer_keys')
    if work is None:
        return None
    us, launches = trace.kernel_us(t["window"], KERNELS, MEMSET_BEFORE)
    return roofline.share(roofline.keys_work(*work), us, launches)
