"""The host wall time of the per-scan view (the span `pmf.view`: `build_eval_sample_with_uproj`, K1 and a gather), a scan (`pmf.scan`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.host_us(w, "pmf.view"), "pmf.scan")
