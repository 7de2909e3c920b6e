"""The device time that SalsaNext's train step's backward launches (the span `pmf.step.backward`, on any thread: autograd's own launches it), a step (`pmf.step`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.device_us(w, "pmf.step.backward"), "pmf.step")
