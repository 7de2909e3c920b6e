"""K2's (`ops/rasterize.py` → `csrc/rasterize.cu`) share of its roofline at the eval view, in percent: the bound of the bytes it must move (`roofline.rasterize_work`) over its device time a launch (its two kernels and the key image's memset just before the first) in the profiler window.

A kernel that did not launch in the traced calls reads nothing."""
from benchmark import roofline, trace

KERNELS = ['(anonymous namespace)::winners_kernel<',
           '(anonymous namespace)::fill_kernel<']   # trace names start so; the first counts launches
MEMSET_BEFORE = '(anonymous namespace)::winners_kernel<'


def read(t: dict):
    work = t.get("work", {}).get('rasterize')
    if work is None:
        return None
    us, launches = trace.kernel_us(t["window"], KERNELS, MEMSET_BEFORE)
    return roofline.share(roofline.rasterize_work(*work), us, launches)
