"""The device time that SalsaNext's train step's losses launch (the span `pmf.step.loss`: `salsanext_losses`, focal over the labelled pixels and Lovász-softmax over every pixel of the batch), a step (`pmf.step`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.device_us(w, "pmf.step.loss"), "pmf.step")
