"""The device time that EPMF's camera decoder launches (the span `pmf.model.camera_decoder`: the ASPP kernel on layer4 at 1x512x20x40 and the lidar bottleneck's upsample, six calls of the net), a keyframe of the nuScenes loop (`pmf.keyframe`), ms. The loop keeps only the lidar head's output, so nothing reads what this work computes."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.device_us(w, "pmf.model.camera_decoder"), "pmf.keyframe")
