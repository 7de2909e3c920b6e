"""The device time that the net's forward at batch 1 launches (the span `pmf.model`), a scan (`pmf.scan`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.device_us(w, "pmf.model"), "pmf.scan")
