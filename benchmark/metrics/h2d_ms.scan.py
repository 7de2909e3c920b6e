"""The host wall time of the per-scan loop's copies of a scan to the card (the span `pmf.scan.h2d` of `tools/infer_kitti.py: Inference.run`), a scan (`pmf.scan`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.host_us(w, "pmf.scan.h2d"), "pmf.scan")
