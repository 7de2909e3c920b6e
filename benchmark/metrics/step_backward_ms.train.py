"""The device time that the train step's backward launches, on any thread (the span `pmf.step.backward`: autograd and `average_gradients`), a step (`pmf.step`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.device_us(w, "pmf.step.backward"), "pmf.step")
