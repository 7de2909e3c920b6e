"""The host wall time of the per-scan loop's read-backs of the points' predictions and kept flags (the span `pmf.scan.readback`: the host waiting for the card), a scan (`pmf.scan`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.host_us(w, "pmf.scan.readback"), "pmf.scan")
