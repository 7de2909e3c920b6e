"""The host wall time of EPMFNet's forwards (the span `pmf.model`: the launches of six calls of the net at batch 1), a keyframe of the nuScenes loop (`pmf.keyframe`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.host_us(w, "pmf.model"), "pmf.keyframe")
