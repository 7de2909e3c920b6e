"""The host wall time of the six cameras' max-confidence merge on numpy (the span `pmf.keyframe.merge` of `tools/infer_nuscenes.py: NuscenesInference.run`), a keyframe (`pmf.keyframe`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.host_us(w, "pmf.keyframe.merge"), "pmf.keyframe")
