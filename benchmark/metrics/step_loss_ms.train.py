"""The device time that the train step's losses launch (the span `pmf.step.loss`: `pmf_losses`), a step (`pmf.step`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.device_us(w, "pmf.step.loss"), "pmf.step")
