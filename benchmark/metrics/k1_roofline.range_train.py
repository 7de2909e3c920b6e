"""K1's (`ops/zbuffer.py: zbuffer_keys` → `csrc/zbuffer_keys.cu`) share of its roofline for the range train view's z-buffer (8 scans of 131072 points into 64x2048, 17 index bits), in percent: the bound of the bytes it must move (`roofline.keys_work`, the work the driver gives) over the device time launched inside the span `pmf.k1` a span.

A window without the span reads nothing."""
from benchmark import program_spans as ps
from benchmark import roofline


def read(t: dict):
    work = t.get("work", {}).get("zbuffer_keys")
    n = ps.count(t["window"], "pmf.k1")
    if work is None or not n:
        return None
    return roofline.share(roofline.keys_work(*work), ps.device_us(t["window"], "pmf.k1"), n)
