"""The net's mean device time a call (CUDA events around the forward), ms."""


def read(t: dict):
    return t["spans"].get("model")
