"""The host wall time of the six items' V2 eval views (the span `pmf.view` of `data/perspective_pipeline_v2.py: build_v2_eval_sample_with_uproj`: the yaw crop, the tight box, K1 and the gather), a keyframe of the nuScenes loop (`pmf.keyframe`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.host_us(w, "pmf.view"), "pmf.keyframe")
