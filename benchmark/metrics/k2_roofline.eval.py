"""K2's share of its roofline at the eval view, in percent (as `k2_roofline.train`): `roofline.rasterize_work` over the device time launched inside the span `pmf.k2` a span.

A window without the span reads nothing."""
from benchmark import program_spans as ps
from benchmark import roofline


def read(t: dict):
    work = t.get("work", {}).get("rasterize")
    n = ps.count(t["window"], "pmf.k2")
    if work is None or not n:
        return None
    return roofline.share(roofline.rasterize_work(*work), ps.device_us(t["window"], "pmf.k2"), n)
