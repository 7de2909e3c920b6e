"""K1's (`ops/scatter.py: zbuffer_scatter_packed`, the per-scan fill) share of its roofline on one scan, in percent (as `zbuffer_keys_roofline.train`).

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
