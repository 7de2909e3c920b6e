"""The device time that the camera stream's decoder launches (the span `pmf.model.camera_decoder`), a call of the net (`pmf.model`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.device_us(w, "pmf.model.camera_decoder"), "pmf.model")
