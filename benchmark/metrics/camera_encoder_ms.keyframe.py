"""The device time that the camera stream's encoder launches (the span `pmf.model.camera_encoder`: the ResNet50's bottleneck blocks, six calls of the net), a keyframe of the nuScenes loop (`pmf.keyframe`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.device_us(w, "pmf.model.camera_encoder"), "pmf.keyframe")
