"""The eval view's mean device time a call (CUDA events around `build_batch` / `build_v2_batch`), ms."""


def read(t: dict):
    return t["spans"].get("view")
