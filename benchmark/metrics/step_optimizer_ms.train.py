"""The device time that the train step's update launches (the span `pmf.step.optimizer`: `HybridOptimizer.step`), a step (`pmf.step`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.device_us(w, "pmf.step.optimizer"), "pmf.step")
