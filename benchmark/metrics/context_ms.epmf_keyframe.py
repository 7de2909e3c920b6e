"""The device time that EPMF's sparse context blocks launch (the span `pmf.model.lidar_stream.context`: float32 `SparseVariantConv`s with their mask max-pools, at 1x32x640x1280 until `downCntx3` halves the map, six calls of the net), a keyframe of the nuScenes loop (`pmf.keyframe`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.device_us(w, "pmf.model.lidar_stream.context"), "pmf.keyframe")
