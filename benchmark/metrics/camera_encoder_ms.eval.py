"""The device time that the camera stream's encoder launches (the span `pmf.model.camera_encoder`: the ResNet34), a call of the net (`pmf.model`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.device_us(w, "pmf.model.camera_encoder"), "pmf.model")
