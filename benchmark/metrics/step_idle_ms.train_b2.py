"""The device's idle time inside EPMF's train step (the span `pmf.step`), a step, ms: the step's host interval less the union of the device intervals in it."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.idle_us(w, "pmf.step"), "pmf.step")
