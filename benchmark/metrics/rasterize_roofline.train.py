"""K2's share of its roofline at the train crop, in percent (as `rasterize_roofline.eval`).

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
