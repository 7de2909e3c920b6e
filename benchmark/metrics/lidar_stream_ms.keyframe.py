"""The device time that the lidar stream launches (the span `pmf.model.lidar_stream`, its fusion blocks included), a keyframe of the nuScenes loop (`pmf.keyframe`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.device_us(w, "pmf.model.lidar_stream"), "pmf.keyframe")
