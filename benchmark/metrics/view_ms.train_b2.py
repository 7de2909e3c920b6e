"""The host wall time of EPMF's V2 train view (the span `pmf.view` of `data/perspective_pipeline_v2.py: build_v2_batch(train=True)`, outside the step), a step (`pmf.step`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.host_us(w, "pmf.view"), "pmf.step")
