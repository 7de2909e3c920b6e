"""Autograd through the losses and the net, with `average_gradients`: mean time a step (CUDA events), ms."""


def read(t: dict):
    return t["spans"].get("backward")
