"""The host wall time of both IoU accumulators' updates (the span `pmf.scan.iou`: the pixel confusion on the card and its read-back, the point confusion on the host), a scan (`pmf.scan`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.host_us(w, "pmf.scan.iou"), "pmf.scan")
