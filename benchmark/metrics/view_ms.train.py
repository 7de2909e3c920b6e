"""The train view's mean time a step (CUDA events around `build_batch(train=True, return_points=True)`), ms."""


def read(t: dict):
    return t["spans"].get("view")
