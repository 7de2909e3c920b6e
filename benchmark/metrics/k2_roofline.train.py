"""K2's (`ops/rasterize.py` → `csrc/rasterize.cu`) share of its roofline at the train crop, in percent: the bound of the bytes it must move (`roofline.rasterize_work`) over the device time launched inside the span `pmf.k2` (the whole call, the key image's memset included) a span.

A window without the span reads nothing."""
from benchmark import program_spans as ps
from benchmark import roofline


def read(t: dict):
    work = t.get("work", {}).get("rasterize")
    n = ps.count(t["window"], "pmf.k2")
    if work is None or not n:
        return None
    return roofline.share(roofline.rasterize_work(*work), ps.device_us(t["window"], "pmf.k2"), n)
