"""K1's share of its roofline on one scan of the per-scan loop, in percent (as `k1_roofline.train`): `roofline.keys_work` over the device time launched inside the span `pmf.k1` a span.

A window without the span reads nothing."""
from benchmark import program_spans as ps
from benchmark import roofline


def read(t: dict):
    work = t.get("work", {}).get("zbuffer_keys")
    n = ps.count(t["window"], "pmf.k1")
    if work is None or not n:
        return None
    return roofline.share(roofline.keys_work(*work), ps.device_us(t["window"], "pmf.k1"), n)
