"""The host wall time of the range train view (the span `pmf.view` of `data/range_pipeline.py: build_range_batch(train=True)`: the point augmentation, the spherical projection, K1 and the fill, outside the step), a step (`pmf.step`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.host_us(w, "pmf.view"), "pmf.step")
