"""The device time that SalsaNext's train step's forward launches (the span `pmf.step.forward` of `train/steps.py: make_salsanext_train_step`: zero_grad and the float32 forward in train mode), a step (`pmf.step`), ms."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.device_us(w, "pmf.step.forward"), "pmf.step")
