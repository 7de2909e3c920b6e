"""The device time that the lidar stream's four fusion blocks launch (the span `pmf.model.lidar_stream.fusion`, fed 256 to 2048 camera channels by the ResNet50), a keyframe of the nuScenes loop (`pmf.keyframe`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.device_us(w, "pmf.model.lidar_stream.fusion"), "pmf.keyframe")
