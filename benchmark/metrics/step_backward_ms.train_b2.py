"""The device time that EPMF's train step's backward launches (the span `pmf.step.backward`, autograd's launches included), a step (`pmf.step`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.device_us(w, "pmf.step.backward"), "pmf.step")
